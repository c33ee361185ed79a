"""TransferPlan: compile-once / run-many policy resolution for bulk transfer.

The port of ``repro.serving.plan``.  A :class:`TransferPlan` resolves the
per-leaf policy ONCE from the structure (shapes + dtypes), and a
:class:`~repro_torch.serving.session.TransferSession` executes it many times.

Per-leaf routing table (resolved at build time):

  bf16 leaf                    -> 'splitzip'   : the calibrated exponent codec
                                  via the backend registry; folded into the
                                  chunked bit stream when ``n_chunks > 1``.
  fp32 leaf (compress_fp32)    -> 'fp32_hilo'  : hi/lo u16 split; the hi half
                                  has the BF16 bit layout so the SAME codebook
                                  compresses it (folded into the chunked
                                  stream too); the lo half ships raw but is
                                  counted on the wire.
  float8 leaf                  -> 'fp8'        : bitcast to the u8 container
                                  and encoded under the e5m2 exponent
                                  codebook; lossless for any float8 bits.
  everything else              -> 'raw'        : dtype-exact passthrough.

Capacity policy: each encoded unit (tensor or pipeline chunk) gets the
geometric retry schedule ``cap -> 2*cap -> 4*cap -> layout='global'``
(:meth:`repro_torch.core.backend.CodecBackend.capacity_schedule`);
exhaustion means the unconditional raw fallback.

Leaves are walked in sorted-key order (:mod:`repro_torch.core.tree`), as JAX
flattens dicts, so the folded stream and the per-leaf stats match the JAX
package.

Execution targets: local (``mesh=None``) or a process mesh (``mesh=`` a
``DeviceMesh`` with a ``"pod"`` dimension, :mod:`repro_torch.launch.mesh`).
A mesh plan carries ``src_pod``/``dst_pod`` and one spec a leaf: a tuple
naming a mesh dimension (or None) for each tensor dimension, the
counterpart of a ``PartitionSpec``.  Mesh execution needs a stream backend
(``torch``, ``cuda``): the collective executors ship the codec's streams.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import codec as C
from repro_torch.core import tree as TR
from repro_torch.core.backend import CodecBackend, WireBackend, get_backend
from repro_torch.core.codebook import Codebook
from repro_torch.core.pipeline import (CodecProfile, degraded_stage_times,
                                       expected_schedule_attempts,
                                       flowshop_makespan)
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import mesh_shape


@dataclasses.dataclass(frozen=True)
class TransferConfig:
    codebook: Codebook
    chunk: int = C.DEFAULT_CHUNK
    cap: int = C.DEFAULT_CAP
    enabled: bool = True          # False => native raw-bytes baseline
    compress_fp32: bool = False   # fp32 hi/lo-split codec toggle
    layout: str = "chunked"       # 'chunked' (paper) | 'global' (beyond-paper)
    global_budget: float = 0.01   # escape-capacity budget for layout='global'
    backend: str = "torch"        # codec backend registry key (core/backend.py)
    n_chunks: int = 1             # >1 => chunked pipelined transfer engine
    # codebook for the fp8 route; None => default normal band
    fp8_codebook: Optional[Codebook] = None
    # geometric capacity schedule: number of cap doublings before the
    # layout='global' last resort (0 disables retries entirely)
    retry_doublings: int = 2
    retry_global_budget: float = 0.05
    # encoded routes need at least this many elements; smaller leaves ship raw
    min_compress_elems: int = 0

    def get_backend(self) -> CodecBackend:
        return get_backend(self.backend)


# default fp8 codebook: the 16-exponent band around the e5m2 bias (15)
FP8_DEFAULT_CODEBOOK = Codebook(fmt="fp8_e5m2", exponents=tuple(range(8, 24)))

leaf_key = TR.leaf_key


def _leaf_order(specs, treedef):
    """Mesh specs in leaf order: a tree like the cache read up to its
    leaves, else a sequence already in leaf order (always so for a bare
    tensor, whose one spec is itself a tuple)."""
    if treedef == TR.LEAF:
        return specs
    try:
        return TR.flatten_up_to(treedef, specs)
    except ValueError:
        return specs


def _resolve_cap(tc: TransferConfig, n: int) -> int:
    cap = tc.cap
    if tc.layout == "global" and cap == C.DEFAULT_CAP:
        cap = C.default_global_cap(n, tc.global_budget)
    return cap


# ---------------------------------------------------------------------------
# per-leaf routes and per-chunk segments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafRoute:
    """One leaf's resolved transfer policy."""

    key: str
    shape: Tuple[int, ...]
    dtype: str                    # numpy-style name, e.g. 'bfloat16'
    route: str                    # 'splitzip' | 'fp32_hilo' | 'fp8' | 'raw'
    cap: int = 0                  # level-0 escape capacity (encoded routes)

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def raw_bytes(self) -> float:
        return float(self.n_elements * C.dtype_from_name(self.dtype).itemsize)


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    """One pipeline chunk of the folded u16 bit stream: a contiguous,
    codec-chunk-aligned [start, stop) element range with its resolved
    level-0 escape capacity."""

    start: int
    stop: int
    cap: int

    @property
    def n_elements(self) -> int:
        return self.stop - self.start

    @property
    def raw_bytes(self) -> float:
        return 2.0 * self.n_elements


@dataclasses.dataclass
class TransferStats:
    """Per-transfer accounting emitted by a :class:`TransferSession` run.

    Chunked executions fill the ``chunk_*`` lists (one entry per pipeline
    chunk); whole-tensor executions fill ``leaf_wire_bytes``/``leaf_ok``.
    Either way ``wire_bytes``/``all_ok`` give the engine a uniform view."""

    chunk_wire_bytes: List[float]   # wire bytes actually shipped per chunk
    chunk_ok: List[bool]            # escape capacity held for this chunk?
    raw_passthrough_bytes: float    # unrouted leaves shipped outside the pipe
    n_elements: int                 # u16 elements routed through the pipe
    # units re-encoded on the geometric capacity schedule, and the extra
    # encode attempts per unit (0 == first encode held)
    chunk_retried: List[bool] = dataclasses.field(default_factory=list)
    chunk_retry_steps: List[int] = dataclasses.field(default_factory=list)
    # whole-tensor execution: per-leaf accounting (raw fallback applied)
    leaf_wire_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    leaf_ok: Dict[str, bool] = dataclasses.field(default_factory=dict)
    # fp32 hi/lo route: raw lo halves counted on the wire
    fp32_lo_wire_bytes: float = 0.0
    # fp8 route: sidecar-encoded float8 leaves' wire bytes
    fp8_wire_bytes: float = 0.0
    # verified delivery (verify=True sessions / injected faults): checksum
    # mismatches + drops observed, re-fetches issued, re-fetches that shipped
    # the unit's raw bits, and the extra bytes those re-fetches put on the
    # wire (chunk_*/leaf_* keep their first-ship meaning)
    verify_failures: int = 0
    refetches: int = 0
    raw_refetches: int = 0
    refetch_wire_bytes: float = 0.0
    # injected-fault bookkeeping (FaultChannel): faults applied this call and
    # wire latency added by 'delay' faults
    faults_injected: int = 0
    fault_delay_s: float = 0.0
    # prefix-delta transfer: raw bytes of segments and sidecars NOT shipped
    # because the receiver already held them bit for bit; excluded from
    # ``wire_bytes``, which stays the bytes actually on the wire
    prefix_hit_bytes: float = 0.0

    @property
    def wire_bytes(self) -> float:
        return (sum(self.chunk_wire_bytes) + sum(self.leaf_wire_bytes.values())
                + self.raw_passthrough_bytes + self.fp32_lo_wire_bytes
                + self.fp8_wire_bytes + self.refetch_wire_bytes)

    @property
    def all_ok(self) -> bool:
        return all(self.chunk_ok) and all(self.leaf_ok.values())

    @property
    def n_retries(self) -> int:
        """Units (chunks/leaves) that needed at least one re-encode."""
        return sum(self.chunk_retried)

    @property
    def n_retry_steps(self) -> int:
        """Total extra encode attempts across the capacity schedule."""
        return sum(self.chunk_retry_steps)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransferPlan:
    """A resolved, leaf-aware transfer program.  Build once per model with
    :meth:`build`, execute many times through :meth:`session`."""

    tc: TransferConfig
    treedef: Any
    routes: Tuple[LeafRoute, ...]
    backend: CodecBackend
    segments: Tuple[SegmentSpec, ...]   # chunked-granularity stream cuts
    stream_len: int                     # u16 elements folded into the stream
    mesh: Any = None                    # DeviceMesh with a 'pod' dimension
    src_pod: int = 0
    dst_pod: int = 1
    in_specs: Optional[Tuple[Tuple[Optional[str], ...], ...]] = None

    @classmethod
    def build(cls, cache_structure, tc: TransferConfig, mesh=None, *,
              specs=None, src_pod: int = 0, dst_pod: int = 1,
              granularity: Optional[str] = None) -> "TransferPlan":
        """Resolve the full per-leaf policy from shapes + dtypes.

        ``cache_structure`` is a pytree of tensors (``meta`` tensors work:
        only ``.shape``/``.dtype`` are read).  ``granularity`` forces
        'chunked' (segment even when ``n_chunks == 1``) or 'tensor'; None
        picks 'chunked' iff ``tc.n_chunks > 1``.  ``mesh``: see the module
        docstring; ``specs`` is a tree like the cache with a spec at each
        leaf (``ShardingPolicy.cache_specs``) or one spec a leaf in leaf
        order (default :meth:`_default_leaf_spec`).  A spec entry is
        None, an axis name or a tuple of axis names
        (``distributed/sharding.py``)."""
        flat, treedef = TR.flatten_with_path(cache_structure)
        backend = get_backend(tc.backend)
        if mesh is not None:
            if isinstance(backend, WireBackend):
                raise ValueError(
                    f"backend {tc.backend!r} is host-side and cannot run on "
                    "the mesh executor; use a stream backend ('torch', "
                    "'cuda')")
            if "pod" not in (mesh.mesh_dim_names or ()):
                raise ValueError("mesh execution needs a 'pod' mesh axis")
        routes: List[LeafRoute] = []
        stream_len = 0
        for path, leaf in flat:
            key = TR.leaf_key(path)
            shape, dtype = tuple(leaf.shape), leaf.dtype
            name = C.dtype_name(dtype)
            n = int(np.prod(shape)) if shape else 1
            if n < tc.min_compress_elems:
                routes.append(LeafRoute(key, shape, name, "raw"))
                continue
            if dtype == torch.bfloat16 and tc.enabled:
                route = LeafRoute(key, shape, name, "splitzip",
                                  cap=_resolve_cap(tc, n))
                stream_len += n
            elif dtype == torch.float32 and tc.enabled and tc.compress_fp32:
                route = LeafRoute(key, shape, name, "fp32_hilo",
                                  cap=_resolve_cap(tc, n))
                stream_len += n                     # the folded hi half
            elif name.startswith("float8") and tc.enabled:
                route = LeafRoute(key, shape, name, "fp8",
                                  cap=_resolve_cap(tc, n))
            else:
                route = LeafRoute(key, shape, name, "raw")
            routes.append(route)

        if granularity is None:
            granularity = "chunked" if tc.n_chunks > 1 else "tensor"
        segments: List[SegmentSpec] = []
        if granularity == "chunked" and stream_len and tc.enabled:
            per = -(-stream_len // max(1, tc.n_chunks))        # ceil split
            per = max(tc.chunk, -(-per // tc.chunk) * tc.chunk)  # align up
            for start in range(0, stream_len, per):
                stop = min(start + per, stream_len)
                segments.append(SegmentSpec(start, stop,
                                            _resolve_cap(tc, stop - start)))
        in_specs = None
        if mesh is not None:
            in_specs = (tuple(cls._default_leaf_spec(leaf, mesh)
                              for _, leaf in flat) if specs is None
                        else cls._check_specs(_leaf_order(specs, treedef),
                                              routes, mesh))
        return cls(tc=tc, treedef=treedef, routes=tuple(routes),
                   backend=backend, segments=tuple(segments),
                   stream_len=stream_len, mesh=mesh, src_pod=src_pod,
                   dst_pod=dst_pod, in_specs=in_specs)

    @staticmethod
    def _default_leaf_spec(x, mesh) -> Tuple[Optional[str], ...]:
        # cache leaves: (L, B, S, ...) — batch over data, replicated over
        # pod/model (the prefill pod is the logical owner).  A mesh without
        # a 'data' dimension replicates (the JAX spec reads mesh.shape
        # ['data'] and raises there)
        sizes = mesh_shape(mesh)
        spec: List[Optional[str]] = [None] * len(x.shape)
        if (len(x.shape) >= 2 and "data" in sizes
                and x.shape[1] % sizes["data"] == 0):
            spec[1] = "data"
        return tuple(spec)

    @staticmethod
    def _check_specs(specs, routes, mesh):
        """One spec a leaf, each padded with None to the leaf's rank; every
        named axis must exist and the product of an entry's axes divide
        its tensor dimension."""
        sizes = mesh_shape(mesh)
        specs = tuple(tuple(s) for s in specs)
        if len(specs) != len(routes):
            raise ValueError(f"{len(specs)} specs for {len(routes)} leaves")
        out = []
        for spec, r in zip(specs, routes):
            if len(spec) > len(r.shape):
                raise ValueError(f"spec {spec} has more entries than leaf "
                                 f"{r.key!r} has dimensions {r.shape}")
            for d, entry in enumerate(spec):
                for name in SH.entry_axes(entry):
                    if name not in sizes:
                        raise ValueError(f"spec {spec} names {name!r}, not a "
                                         f"mesh dimension {tuple(sizes)}")
                n = math.prod(sizes[a] for a in SH.entry_axes(entry))
                if r.shape[d] % n:
                    raise ValueError(f"leaf {r.key!r} dimension {d} "
                                     f"({r.shape[d]}) does not divide over "
                                     f"{entry!r} ({n})")
            out.append(spec + (None,) * (len(r.shape) - len(spec)))
        return tuple(out)

    # -- derived views -------------------------------------------------------
    @property
    def granularity(self) -> str:
        return "chunked" if len(self.segments) > 0 else "tensor"

    @property
    def n_chunks(self) -> int:
        return len(self.segments)

    @property
    def fp8_codebook(self) -> Codebook:
        return self.tc.fp8_codebook or FP8_DEFAULT_CODEBOOK

    def matches(self, cache) -> bool:
        """Does ``cache`` have exactly the structure this plan was built for?"""
        flat, treedef = TR.flatten_with_path(cache)
        if treedef != self.treedef or len(flat) != len(self.routes):
            return False
        return all(tuple(leaf.shape) == r.shape
                   and C.dtype_name(leaf.dtype) == r.dtype
                   for (_, leaf), r in zip(flat, self.routes))

    def schedule_for(self, n: int, cap: int) -> Tuple[Tuple[CodecBackend, str, int], ...]:
        """The geometric capacity schedule for one encoded unit of ``n``
        elements (see ``CodecBackend.capacity_schedule``)."""
        return self.backend.capacity_schedule(
            self.tc.layout, cap, n, doublings=self.tc.retry_doublings,
            global_budget=self.tc.retry_global_budget)

    def raw_bytes(self) -> float:
        return float(sum(r.raw_bytes for r in self.routes))

    # -- the time model -------------------------------------------------------
    def chunk_raw_bytes(self, scale: float = 1.0) -> List[float]:
        """Raw byte size of each pipeline chunk, as actually segmented,
        times ``scale`` (per-prompt-length byte scaling)."""
        return [s.raw_bytes * scale for s in self.segments]

    def byte_split(self, scale: float = 1.0) -> Tuple[float, float, float]:
        """(stream_bytes, fp8_sidecar_bytes, incompressible_bytes) under the
        route table: stream = bf16 bits + fp32 hi halves (codec ratio
        applies), fp8 sidecars compress outside the pipe, incompressible =
        raw passthrough + fp32 lo halves (full link cost).  ``scale``
        multiplies every class."""
        stream = 2.0 * self.stream_len
        fp8 = out = 0.0
        for r in self.routes:
            if r.route == "fp8":
                fp8 += r.raw_bytes
            elif r.route == "fp32_hilo":
                out += 2.0 * r.n_elements           # the raw lo half
            elif r.route == "raw":
                out += r.raw_bytes
        return stream * scale, fp8 * scale, out * scale

    def collective_wire_bytes(self, ratio: float, n_hops: int,
                              scale: float = 1.0) -> float:
        """Analytic wire bytes for a ring collective over this plan: each of
        the ``n_hops`` hops ships the routed stream at the codec ``ratio``
        plus the incompressible bytes at full cost."""
        stream, fp8, out = self.byte_split(scale)
        return ((stream + fp8) / max(ratio, 1e-9) + out) * n_hops

    def expected_attempts(self, overflow_p: float) -> Tuple[float, float]:
        """``(expected encode attempts per unit, raw-fallback fraction)``
        under this plan's capacity schedule when each attempt independently
        overflows with probability ``overflow_p``.  The schedule length is
        read off a representative unit: the first segment (chunked) or the
        largest encoded leaf (tensor)."""
        if overflow_p <= 0.0:
            return 1.0, 0.0
        if self.segments:
            n, cap = self.segments[0].n_elements, self.segments[0].cap
        else:
            enc = [r for r in self.routes if r.route != "raw"]
            if not enc:
                return 1.0, 0.0
            big = max(enc, key=lambda r: r.n_elements)
            n, cap = big.n_elements, big.cap
        return expected_schedule_attempts(len(self.schedule_for(n, cap)),
                                          overflow_p)

    def estimate_time(self, profile: CodecProfile, *, scale: float = 1.0,
                      overflow_p: float = 0.0) -> float:
        """A-priori transfer time for ONE execution: the flowshop recurrence
        over the plan's actual segment sizes (tensor granularity: additive),
        charging the codec ratio only on routed bytes — incompressible
        sidecars pay full link cost.  ``overflow_p`` walks the capacity
        schedule in expectation: re-attempts inflate the encode stage and
        the exhausted fraction ships raw at full link bandwidth."""
        stream, fp8, out = self.byte_split(scale)
        attempts, raw_frac = self.expected_attempts(overflow_p)
        t_side = (fp8 * ((1.0 - raw_frac) / (profile.ratio * profile.link_bw)
                         + raw_frac / profile.link_bw)
                  + out / profile.link_bw)
        if self.granularity == "chunked":
            times = [degraded_stage_times(s, profile, attempts=attempts,
                                          raw_frac=raw_frac)
                     for s in self.chunk_raw_bytes(scale)]
            return (flowshop_makespan(times) + profile.fixed_overhead_s
                    + t_side)
        t_enc, t_xfer, t_dec = degraded_stage_times(stream, profile,
                                                    attempts=attempts,
                                                    raw_frac=raw_frac)
        t_enc += attempts * fp8 / profile.g_enc      # fp8 sidecars are
        t_dec += (1.0 - raw_frac) * fp8 / profile.g_dec  # codec-touched too
        return t_enc + t_xfer + t_dec + t_side + profile.fixed_overhead_s

    def describe(self) -> str:
        """Human-readable routing table (serve launcher / docs)."""
        counts: Dict[str, int] = {}
        bytes_: Dict[str, float] = {}
        for r in self.routes:
            counts[r.route] = counts.get(r.route, 0) + 1
            bytes_[r.route] = bytes_.get(r.route, 0.0) + r.raw_bytes
        target = ("local" if self.mesh is None
                  else f"mesh(pod {self.src_pod}->{self.dst_pod})")
        lines = [f"TransferPlan[{self.granularity}, backend={self.backend.name}, "
                 f"target={target}, n_chunks={max(1, self.n_chunks)}]"]
        for route in ("splitzip", "fp32_hilo", "fp8", "raw"):
            if route in counts:
                lines.append(f"  {route:10s}: {counts[route]:3d} leaves, "
                             f"{bytes_[route] / 2**20:8.2f} MiB raw")
        if self.segments:
            lines.append(f"  segments  : {self.n_chunks} x "
                         f"~{self.segments[0].n_elements} u16 elems "
                         f"(cap {self.segments[0].cap})")
        return "\n".join(lines)

    # -- stream folding (chunked granularity) --------------------------------
    def fold_stream(self, cache) -> Tuple[torch.Tensor, Dict, Dict, Dict]:
        """Flatten every routed leaf into ONE u16 bit stream in route order:
        bf16 leaves contribute their container bits, fp32 leaves their hi
        halves (lo halves returned separately, shipped raw).  Returns
        ``(stream, lo_halves, fp8_leaves, raw_leaves)``."""
        flat = TR.flatten_with_path(cache)[0]
        parts: List[torch.Tensor] = []
        lo: Dict[str, torch.Tensor] = {}
        fp8: Dict[str, torch.Tensor] = {}
        raw: Dict[str, torch.Tensor] = {}
        device = flat[0][1].device if flat else torch.device("cpu")
        for (_, leaf), r in zip(flat, self.routes):
            if r.route == "splitzip":
                parts.append(leaf.reshape(-1).view(torch.int16))
            elif r.route == "fp32_hilo":
                u = leaf.reshape(-1).view(torch.int32)
                parts.append(((u >> 16) & 0xFFFF).to(torch.int16))
                lo[r.key] = C.narrow_u16(u & 0xFFFF)
            elif r.route == "fp8":
                fp8[r.key] = leaf
            else:
                raw[r.key] = leaf
        if not parts:
            stream = torch.zeros((0,), dtype=torch.int16, device=device)
        else:
            stream = torch.cat(parts) if len(parts) > 1 else parts[0]
        return stream.view(torch.uint16), lo, fp8, raw

    def unfold_stream(self, bits_out: torch.Tensor, lo: Dict, fp8_decoded: Dict,
                      raw: Dict):
        """Inverse of :meth:`fold_stream` against the plan's structure."""
        leaves, off = [], 0
        for r in self.routes:
            n = r.n_elements
            if r.route == "splitzip":
                leaves.append(bits_out[off:off + n].reshape(r.shape)
                              .view(torch.bfloat16))
                off += n
            elif r.route == "fp32_hilo":
                hi = C.widen(bits_out[off:off + n]).to(torch.int64)
                u = (hi << 16) | C.widen(lo[r.key]).to(torch.int64)
                leaves.append(C.narrow_u32(u).view(torch.int32)
                              .view(torch.float32).reshape(r.shape))
                off += n
            elif r.route == "fp8":
                leaves.append(fp8_decoded[r.key].reshape(r.shape))
            else:
                leaves.append(raw[r.key])
        return TR.unflatten(self.treedef, leaves)

    # -- session -------------------------------------------------------------
    def session(self, *, faults=None, verify: bool = False,
                retain_last: bool = False, device=None) -> "TransferSession":
        """A session executing this plan.  ``faults`` is ``None | registry
        name | FaultPlan`` (:mod:`repro_torch.serving.faults`);
        ``verify=True`` checksum-verifies every wire hop and re-fetches on
        failure; ``retain_last=True`` keeps the last transfer's compressed
        payloads sender-side so a decode-worker failover can re-send them
        (``TransferSession.resend_last``) without re-encoding.  ``device``
        is where ``load`` puts what it reads (default: the card)."""
        from repro_torch.serving.session import TransferSession
        return TransferSession(self, faults=faults, verify=verify,
                               retain_last=retain_last, device=device)
