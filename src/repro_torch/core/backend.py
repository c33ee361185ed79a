"""Pluggable SplitZip codec backends (the port of ``repro.core.backend``).

One logical codec, several physical implementations.  Every serving-path
consumer selects its implementation through this registry via
``TransferConfig.backend`` instead of importing a codec module directly.

Built-in backends:

  torch : the reference codec (:mod:`repro_torch.core.codec`) — plain PyTorch
          on any device; the counterpart of the JAX package's ``xla``.
  cuda  : the hand-written CUDA kernels (:mod:`repro_torch.kernels.ops`): one
          launch per encode/decode with escape compaction and sparse
          correction fused in.  ``CudaBackend(fused=False)`` selects the
          two-stage structure (dense kernel + PyTorch escape passes).  The
          kernels launch for CUDA tensors; CPU tensors take their plain
          versions.  The counterpart of ``pallas``.
  auto  : resolves to ``cuda``.
  wire  : the SZ02 host payload (:mod:`repro_torch.core.wire`): true
          variable-length bytes with no escape-capacity limit, so ``ok`` is
          always True.  The element-wise work runs on the tensor's device
          through the ``cuda`` backend's kernels; the payload itself is host
          bytes.  ``wire-verify`` checks every payload's frame table before
          decoding.

Interface contract: ``encode`` returns a compressed object (a
:class:`CompressedTensor`, or a :class:`WireCompressed` for ``wire``);
``decode`` inverts it bit-exactly; ``decode_bits`` yields the flat container
bit stream; ``ok``/``wire_bytes``/``raw_bytes`` give the transfer session a
uniform view for the raw-fallback accounting; ``checksum`` is the
Fletcher-32 tag the verified wire hop frames an object with.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import codec as C
from repro_torch.core import wire as W
from repro_torch.core.codebook import FORMATS, Codebook
from repro_torch.kernels import ops


class CodecBackend:
    """Codec backend over :class:`~repro_torch.core.codec.CompressedTensor`."""

    name: str = "abstract"

    def encode(self, x: torch.Tensor, codebook: Codebook, *,
               chunk: int = C.DEFAULT_CHUNK, cap: int = C.DEFAULT_CAP,
               layout: str = "chunked") -> C.CompressedTensor:
        raise NotImplementedError

    def decode(self, comp: C.CompressedTensor) -> torch.Tensor:
        raise NotImplementedError

    def decode_bits(self, comp: C.CompressedTensor) -> torch.Tensor:
        """Decode to the flat container bit stream (u16/u8, n_elements long)."""
        raise NotImplementedError

    def ok(self, comp: C.CompressedTensor) -> torch.Tensor:
        """Did the compressed form stay within capacity (lossless as-is)?"""
        return comp.ok

    def wire_bytes(self, comp: C.CompressedTensor) -> float:
        """Exact variable-length wire bytes for this tensor (when ok)."""
        return C.compressed_bytes(comp)

    def raw_bytes(self, comp: C.CompressedTensor) -> float:
        """Uncompressed bytes of the original tensor (the fallback cost)."""
        return C.raw_bytes(comp)

    def checksum(self, comp) -> int:
        """Fletcher-32 integrity tag over a wire object's bytes: a
        compressed object's streams concatenated in the JAX pytree's leaf
        order (:meth:`CompressedTensor.tensors`), or a raw tensor's bytes.
        Computed on the object's device; only the tag reaches the host."""
        leaves = comp.tensors() if isinstance(comp, C.CompressedTensor) else (comp,)
        return W.fletcher32(torch.cat([
            C.signed_view(t).contiguous().reshape(-1).view(torch.uint8)
            for t in leaves]))

    def for_retry(self, layout: str) -> "CodecBackend":
        """Backend for the adaptive-capacity re-encode of an overflowed unit.

        Default: the backend itself (growing ``cap`` is enough)."""
        return self

    def capacity_schedule(self, layout: str, cap: int, n: int, *,
                          doublings: int = 2, global_budget: float = 0.05
                          ) -> Tuple[Tuple["CodecBackend", str, int], ...]:
        """Plan-time geometric retry schedule for one tensor/chunk of ``n``
        elements: ``(backend, layout, cap)`` attempts, tried in order until
        one encode's ``ok`` holds; exhaustion means the raw fallback.

        ``cap -> 2*cap -> 4*cap -> layout='global'``: two doublings of the
        level-0 capacity, then the global layout whose single escape pool
        (sized by ``global_budget``) absorbs heavy-tailed chunks.  Each step
        routes through :meth:`for_retry`.  ``doublings=0`` disables retries
        (single base attempt, no global last resort)."""
        steps = [(self, layout, cap)]
        if doublings <= 0:
            return tuple(steps)
        be, c = self, cap
        for _ in range(doublings):
            c *= 2
            be = be.for_retry(layout)
            steps.append((be, layout, c))
        gcap = max(C.default_global_cap(n, global_budget), 2 * c)
        steps.append((be.for_retry("global"), "global", gcap))
        return tuple(steps)


class TorchBackend(CodecBackend):
    """The reference codec: plain PyTorch, any device."""

    name = "torch"

    def encode(self, x, codebook, *, chunk=C.DEFAULT_CHUNK, cap=C.DEFAULT_CAP,
               layout="chunked"):
        return C.encode(x, codebook, chunk=chunk, cap=cap, layout=layout)

    def decode(self, comp):
        return C.decode(comp)

    def decode_bits(self, comp):
        return C.decode_to_bits(comp)


class CudaBackend(CodecBackend):
    """The CUDA codec kernels.

    ``fused=True`` (default): one launch per encode/decode with in-kernel
    escape compaction / sparse correction.  ``fused=False``: the two-stage
    structure — same stream layout, bit-identical output."""

    name = "cuda"

    def __init__(self, fused: bool = True):
        self.fused = fused

    def encode(self, x, codebook, *, chunk=C.DEFAULT_CHUNK, cap=C.DEFAULT_CAP,
               layout="chunked"):
        return ops.encode(x, codebook, chunk=chunk, cap=cap, layout=layout,
                          fused=self.fused)

    def decode(self, comp):
        return ops.decode(comp, fused=self.fused)

    def decode_bits(self, comp):
        return ops.decode_bits(comp, fused=self.fused)

    def for_retry(self, layout):
        if layout == "global" and self.fused:
            # A level-1 (per-chunk kernel buffer) overflow cannot be cleared
            # by growing the TOTAL cap — the fused kernel pins its per-chunk
            # cap at MAX_FUSED_CAP.  Retry through the two-stage structure,
            # which compacts globally with no level-1 bound.
            return CudaBackend(fused=False)
        return self


@dataclasses.dataclass(frozen=True)
class WireCompressed:
    """A tensor as its SZ02 host payload.  ``device`` is where it was
    encoded from and where it decodes to."""

    payload: bytes
    shape: tuple
    dtype: str
    fmt: str
    stats: W.WireStats
    device: str


class WireBackend(CodecBackend):
    """The SZ02 wire codec: byte-exact serialization, no capacity limit.

    Encode runs the ``cuda`` backend's kernels where the tensor is (a
    chunked encode at ``cap``; where a chunk's true count overflows, one
    ``layout='global'`` re-encode at the total count through the two-stage
    path, which loses no escape), compacts the escapes in chunk order and
    repacks the fields whose width differs from SZ02's, then copies the body
    to the host once.  Decode parses on the host, uploads the payload once
    and decodes on the payload's device through the kernels.
    ``verify=True`` checks the frame table first (on that device) and raises
    :class:`~repro_torch.core.wire.WireIntegrityError` naming the bad
    frames."""

    name = "wire"

    def __init__(self, verify: bool = False):
        self.verify = verify
        self.codec = CudaBackend()

    def encode(self, x, codebook, *, chunk=C.DEFAULT_CHUNK, cap=C.DEFAULT_CAP,
               layout="chunked"):
        # layout is an in-graph concern: the payload's escape arrays hold
        # exactly the escapes there are
        ct = W.lossless_streams(x, codebook, chunk, cap, self.codec.encode,
                                self.codec.for_retry("global").encode)
        payload, stats = W.payload_from_streams(ct)
        return WireCompressed(payload=payload, shape=tuple(x.shape),
                              dtype=C.dtype_name(x.dtype), fmt=codebook.fmt,
                              stats=stats, device=str(x.device))

    def decode_bits(self, comp: WireCompressed) -> torch.Tensor:
        ct = W.streams_from_payload(comp.payload, comp.device,
                                    verify=self.verify)
        return self.codec.decode_bits(ct)

    def decode(self, comp: WireCompressed) -> torch.Tensor:
        bits = self.decode_bits(comp).reshape(comp.shape)
        return C.from_bits(bits, C.dtype_from_name(comp.dtype))

    def checksum(self, comp: WireCompressed) -> int:
        return W.fletcher32(comp.payload)

    def ok(self, comp: WireCompressed) -> bool:
        return True  # variable-length format: unconditionally lossless

    def wire_bytes(self, comp: WireCompressed) -> float:
        return float(comp.stats.payload_bytes)

    def raw_bytes(self, comp: WireCompressed) -> float:
        return comp.stats.n_elements * FORMATS[comp.fmt]["bits"] / 8.0


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], CodecBackend]] = {}
_INSTANCES: Dict[str, CodecBackend] = {}


def register_backend(name: str, factory: Callable[[], CodecBackend]) -> None:
    """Register a codec backend under ``name`` (later wins, instances reset)."""
    _REGISTRY[name] = factory
    _INSTANCES.pop(name, None)


def get_backend(name: str) -> CodecBackend:
    """Resolve a backend name to its (cached) instance."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown codec backend {name!r}; available: {available_backends()}")
    if name not in _INSTANCES:
        _INSTANCES[name] = _REGISTRY[name]()
    return _INSTANCES[name]


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_backend("torch", TorchBackend)
register_backend("cuda", CudaBackend)
register_backend("auto", CudaBackend)
register_backend("wire", WireBackend)
# integrity-checking wire decode: every payload's frame table is verified
# before the body is parsed (WireIntegrityError on corruption)
register_backend("wire-verify", lambda: WireBackend(verify=True))
