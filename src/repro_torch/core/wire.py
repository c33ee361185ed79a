"""SplitZip host wire payload (SZ02): variable-length byte serialization.

The port of ``repro.core.wire``.  A payload is

  header | codebook exponents | integrity-frame table | body

with the body

  sign-mantissa stream (``mbits + 1`` bits an element, LSB-first) |
  packed code stream (``code_bits`` an element) | per-chunk escape counts
  (u32) | escape positions (u16, chunk-relative) | escape values (u8)

and one Fletcher-32 tag per ``FRAME_BYTES`` window of the body in the frame
table, so a receiver learns WHICH 64 KiB window arrived corrupt.  The escape
arrays hold exactly the escapes there are: the format has no capacity
limit, so it is unconditionally lossless (``docs/wire_format.md`` §7).

The element-wise work runs in PyTorch on whatever device the tensors are
on; only the header, the frame table and the assembled payload live on the
host.  :func:`payload_from_streams` / :func:`streams_from_payload` convert
between a payload and the codec's streams (a
:class:`~repro_torch.core.codec.CompressedTensor`), so the ``wire`` backend
runs its element-wise work through the CUDA codec kernels and
:func:`encode` / :func:`decode` through the reference codec, and both write
the same bytes.
"""

from __future__ import annotations

import dataclasses
import math
import struct
import warnings
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import codec as C
from repro_torch.core.codebook import FORMATS, Codebook
from repro_torch.device import resolve_device
from repro_torch.kernels.splitzip_encode import MAX_FUSED_CAP

MAGIC = b"SZ02"
DEFAULT_CHUNK = 1024
#: integrity-frame window: one u32 Fletcher-32 checksum per 64 KiB of body
FRAME_BYTES = 64 * 1024

# magic, fmt_id, k, chunk, n_chunks, n_elements, n_integrity_frames
_HEADER = struct.Struct("<4sBBHIQI")
_FMT_IDS = {"bf16": 0, "fp8_e5m2": 1, "fp8_e4m3": 2}
_FMT_NAMES = {v: k for k, v in _FMT_IDS.items()}

_MOD = 65535
# Fletcher words are summed in blocks of one frame: a block's weights
# (block - j) times a u16 word stay below 2**31, so the weighted products
# fit int32 and only the sums widen to int64
_BLOCK_WORDS = FRAME_BYTES // 2


class WireIntegrityError(ValueError):
    """A payload failed checksum verification.  ``frames`` lists the indices
    of the corrupted integrity frames (``FRAME_BYTES`` windows of the body),
    so a transport can re-fetch exactly those windows."""

    def __init__(self, frames):
        self.frames = tuple(frames)
        super().__init__(
            f"wire payload corrupted in integrity frame(s) {self.frames}")


# ---------------------------------------------------------------------------
# Fletcher-32
# ---------------------------------------------------------------------------

def _host_bytes(data: Union[bytes, bytearray, memoryview]) -> torch.Tensor:
    """Read-only host bytes as a u8 tensor, without a copy (nothing here
    writes through it)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "not writable"
        return torch.frombuffer(memoryview(data), dtype=torch.uint8)


def _as_u8(data) -> torch.Tensor:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return _host_bytes(data) if len(data) else torch.zeros(0, dtype=torch.uint8)
    if data.dtype != torch.uint8:
        raise TypeError(f"fletcher32 takes u8 tensors or bytes, got {data.dtype}")
    return data.reshape(-1)


def _block_sums(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per block of ``_BLOCK_WORDS`` little-endian u16 words of ``buf`` (u8,
    zero-padded to a whole word and a whole block): ``(S1, U, L)`` with
    ``S1 = sum(w)``, ``U = sum_j (L - j) * w_j`` (j 0-based in the block) and
    ``L`` the block's true word count, all int64 on ``buf``'s device."""
    n = buf.numel()
    m = (n + 1) // 2
    nb = max(1, -(-m // _BLOCK_WORDS))
    padded = torch.zeros(nb * _BLOCK_WORDS * 2, dtype=torch.uint8, device=buf.device)
    padded[:n] = buf
    w = padded.view(torch.int16).to(torch.int32) & 0xFFFF
    w = w.reshape(nb, _BLOCK_WORDS)
    weight = torch.arange(_BLOCK_WORDS, 0, -1, dtype=torch.int32, device=buf.device)
    s1 = w.sum(dim=1, dtype=torch.int64)
    u = (w * weight).sum(dim=1, dtype=torch.int64)
    lengths = torch.full((nb,), _BLOCK_WORDS, dtype=torch.int64, device=buf.device)
    lengths[-1] = m - (nb - 1) * _BLOCK_WORDS
    # zero padding past a short last block carries no weight; the weights
    # were counted from the padded length, so take the difference back out
    u = u - (_BLOCK_WORDS - lengths) * s1
    return s1, u, lengths


def fletcher32(data) -> int:
    """Fletcher-32 over a byte buffer (u16 little-endian words, zero-padded
    to a whole word): ``s1 = sum(w)``, ``s2 = sum_i (m - i) * w_i`` (i
    0-based, m words), both mod 65535, tag ``s2 << 16 | s1``.

    ``data`` is a u8 tensor on any device (computed there; one scalar comes
    back) or host ``bytes``.  Each block adds its share of ``s2`` as
    ``(words after the block) * S1_b + sum_j (L_b - j) * w_j``."""
    buf = _as_u8(data)
    if buf.numel() == 0:
        return 0
    s1, u, lengths = _block_sums(buf)
    after = (lengths.sum() - torch.cumsum(lengths, 0)) % _MOD
    s2 = (after * (s1 % _MOD) + u % _MOD).sum() % _MOD
    s1_all = s1.sum() % _MOD
    s1_host, s2_host = torch.stack([s1_all, s2]).tolist()
    return int((s2_host << 16) | s1_host)


def frame_checksums(body) -> np.ndarray:
    """One Fletcher-32 per ``FRAME_BYTES`` window of ``body`` (u8 tensor on
    any device, or host bytes), as host u32."""
    buf = _as_u8(body)
    if buf.numel() == 0:
        return np.zeros(0, dtype=np.uint32)
    s1, u, _ = _block_sums(buf)              # one frame == one block
    tags = ((u % _MOD) << 16) | (s1 % _MOD)
    return tags.cpu().numpy().astype(np.uint32)


def n_integrity_frames(body_bytes: int) -> int:
    return max(1, -(-body_bytes // FRAME_BYTES)) if body_bytes else 0


# ---------------------------------------------------------------------------
# bit packing (LSB-first, as numpy's packbits(bitorder="little"))
# ---------------------------------------------------------------------------

def code_bits_for(k: int) -> int:
    return max(1, int(math.ceil(math.log2(max(2, k)))))


def _packed_len(n: int, bits: int) -> int:
    return n if bits == 8 else ((n + 1) // 2 if bits == 4 else (n * bits + 7) // 8)


def _bitpack(values: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack u8 values below ``2**bits`` into a dense LSB-first bitstream."""
    n = values.numel()
    if bits == 8:
        return values.to(torch.uint8)
    if bits == 4:
        if n % 2:
            values = torch.cat([values, values.new_zeros(1)])
        return (values[0::2] & 0xF) | ((values[1::2] & 0xF) << 4)
    groups = -(-n // 8)
    v = torch.zeros(groups * 8, dtype=torch.int64, device=values.device)
    v[:n] = values.to(torch.int64) & ((1 << bits) - 1)
    shifts = torch.arange(8, device=values.device, dtype=torch.int64) * bits
    word = (v.reshape(groups, 8) << shifts).sum(dim=1)     # disjoint fields
    byte_shifts = torch.arange(bits, device=values.device, dtype=torch.int64) * 8
    out = ((word[:, None] >> byte_shifts) & 0xFF).to(torch.uint8).reshape(-1)
    return out[:_packed_len(n, bits)]


def _bitunpack(buf: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    if bits == 8:
        return buf[:n]
    if bits == 4:
        return torch.stack([buf & 0xF, buf >> 4], dim=-1).reshape(-1)[:n]
    groups = -(-n // 8)
    b = torch.zeros(groups * bits, dtype=torch.int64, device=buf.device)
    b[:buf.numel()] = buf.to(torch.int64)
    byte_shifts = torch.arange(bits, device=buf.device, dtype=torch.int64) * 8
    word = (b.reshape(groups, bits) << byte_shifts).sum(dim=1)
    shifts = torch.arange(8, device=buf.device, dtype=torch.int64) * bits
    out = ((word[:, None] >> shifts) & ((1 << bits) - 1)).to(torch.uint8)
    return out.reshape(-1)[:n]


def _le_u16(buf: torch.Tensor) -> torch.Tensor:
    """Little-endian u16 values from a u8 tensor at any alignment (int32)."""
    return buf[0::2].to(torch.int32) | (buf[1::2].to(torch.int32) << 8)


# ---------------------------------------------------------------------------
# payload <-> streams
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WireStats:
    n_elements: int
    n_escapes: int
    payload_bytes: int
    raw_bytes: int

    @property
    def escape_rate(self) -> float:
        return self.n_escapes / max(1, self.n_elements)

    @property
    def ratio(self) -> float:
        return self.raw_bytes / max(1, self.payload_bytes)


def lossless_streams(x: torch.Tensor, codebook: Codebook, chunk: int, cap: int,
                     encode: Callable, encode_global: Callable
                     ) -> C.CompressedTensor:
    """Encode ``x`` so that no escape is lost: once per chunk at ``cap``
    (``encode``), and where a chunk's true escape count (``esc_count``
    counts past ``cap``) overflows, once more in the global layout at a
    capacity of the total count (``encode_global``, which must have no
    per-chunk bound)."""
    ct = encode(x, codebook, chunk=chunk, cap=cap, layout="chunked")
    count = ct.esc_count.to(torch.int64)
    worst, total = torch.stack([count.max(), count.sum()]).tolist()
    if worst <= cap:
        return ct
    return encode_global(x, codebook, chunk=chunk, cap=int(total), layout="global")


def _escapes(ct: C.CompressedTensor, n_chunks: int):
    """(counts i32[n_chunks], chunk-relative positions i32[m], values u8[m])
    of a stream set that lost no escape, in chunk then position order."""
    dev = ct.esc_pos.device
    if ct.layout == "global":
        gpos = C.widen(ct.esc_pos.reshape(-1)).to(torch.int64)
        keep = gpos < ct.n_padded                           # padding == N
        gpos = gpos[keep]
        counts = torch.bincount(gpos // ct.chunk, minlength=n_chunks)
        return (counts.to(torch.int32), (gpos % ct.chunk).to(torch.int32),
                ct.esc_val.reshape(-1)[keep])
    counts = ct.esc_count.to(torch.int32)
    slot = torch.arange(ct.esc_pos.shape[1], device=dev, dtype=torch.int32)
    keep = slot[None, :] < counts[:, None]
    return counts, C.widen(ct.esc_pos)[keep], ct.esc_val[keep]


def payload_from_streams(ct: C.CompressedTensor) -> Tuple[bytes, WireStats]:
    """Assemble the SZ02 payload of a stream set that lost no escape
    (chunked layout within its cap, or the global layout).  The body is
    built where the streams are and copied to the host once."""
    if not bool(ct.ok):
        raise ValueError("the streams lost escapes to their capacity; encode "
                         "them with lossless_streams")
    spec = FORMATS[ct.fmt]
    n, chunk, k = ct.n_elements, ct.chunk, len(ct.exponents)
    n_chunks = -(-n // chunk)
    a_bits, code_bits = spec["mbits"] + 1, code_bits_for(k)
    a_packed = _bitpack(ct.sign_mantissa[:n], a_bits)
    if k <= 16 and code_bits == 4:
        codes_packed = ct.packed[:(n + 1) // 2]    # the codec's nibbles; a pad
    else:                                          # element's code is 0
        codes = (C.unpack_nibbles(ct.packed) if k <= 16 else ct.packed)[:n]
        codes_packed = _bitpack(codes, code_bits)
    counts, pos, val = _escapes(ct, n_chunks)
    body = torch.cat([
        a_packed, codes_packed, counts.contiguous().view(torch.uint8),
        pos.to(torch.int16).contiguous().view(torch.uint8), val.to(torch.uint8)])
    frames = frame_checksums(body)
    header = _HEADER.pack(MAGIC, _FMT_IDS[ct.fmt], k, chunk, n_chunks, n,
                          frames.size)
    payload = b"".join([header, bytes(bytearray(ct.exponents)),
                        frames.tobytes(), body.cpu().numpy().tobytes()])
    stats = WireStats(n_elements=n, n_escapes=int(pos.numel()),
                      payload_bytes=len(payload), raw_bytes=n * spec["bits"] // 8)
    return payload, stats


@dataclasses.dataclass(frozen=True)
class _Layout:
    fmt: str
    k: int
    chunk: int
    n_chunks: int
    n: int
    n_frames: int
    exponents: tuple
    frames_off: int
    body_off: int


def _parse(payload: bytes) -> _Layout:
    magic, fmt_id, k, chunk, n_chunks, n, n_frames = _HEADER.unpack_from(payload, 0)
    if magic != MAGIC:
        raise ValueError("bad SplitZip magic")
    off = _HEADER.size
    exps = tuple(payload[off:off + k])
    return _Layout(fmt=_FMT_NAMES[fmt_id], k=k, chunk=chunk, n_chunks=n_chunks,
                   n=n, n_frames=n_frames, exponents=exps, frames_off=off + k,
                   body_off=off + k + 4 * n_frames)


def verify_payload(payload: bytes, body: Optional[torch.Tensor] = None
                   ) -> Tuple[int, ...]:
    """Recompute the body's per-frame Fletcher-32 sums against the stored
    frame table.  Returns the indices of MISMATCHED frames (empty ==
    intact).  ``body`` is the payload's body already on a device (computed
    there); None computes on the host bytes."""
    lay = _parse(payload)
    stored = np.frombuffer(payload, np.uint32, lay.n_frames, lay.frames_off)
    got = frame_checksums(memoryview(payload)[lay.body_off:] if body is None
                          else body)
    if got.size != stored.size:
        return tuple(range(max(got.size, stored.size)))
    return tuple(int(i) for i in np.flatnonzero(got != stored))


def streams_from_payload(payload: bytes, device, *, verify: bool = False
                         ) -> C.CompressedTensor:
    """Parse a payload on the host, upload it once to ``device`` and rebuild
    the codec's streams there: the chunked layout with a cap of the largest
    chunk count where that fits the fused decode kernel (``MAX_FUSED_CAP``),
    else the global layout.
    ``verify=True`` checks the frame table first (on ``device``) and raises
    :class:`WireIntegrityError` naming the bad frames."""
    lay = _parse(payload)
    spec = FORMATS[lay.fmt]
    n, chunk, nc = lay.n, lay.chunk, lay.n_chunks
    dev = torch.device(device)
    host = _host_bytes(payload)
    buf = host.to(dev) if dev.type != "cpu" else host.clone()
    body = buf[lay.body_off:]
    if verify:
        bad = verify_payload(payload, body)
        if bad:
            raise WireIntegrityError(bad)
    a_bits, code_bits = spec["mbits"] + 1, code_bits_for(lay.k)
    off = 0
    n_a = _packed_len(n, a_bits)
    a = _bitunpack(body[off:off + n_a], n, a_bits)
    off += n_a
    n_code = _packed_len(n, code_bits)
    code_buf = body[off:off + n_code]
    off += n_code
    counts_host = np.frombuffer(payload, np.uint32, nc, lay.body_off + off)
    off += 4 * nc
    m = int(counts_host.sum(dtype=np.int64))
    pos = _le_u16(body[off:off + 2 * m])
    off += 2 * m
    val = body[off:off + m]

    n_pad = nc * chunk
    sm = torch.zeros(n_pad, dtype=torch.uint8, device=dev)
    sm[:n] = a
    if lay.k <= 16:
        packed = torch.zeros(n_pad // 2, dtype=torch.uint8, device=dev)
        if code_bits == 4:
            packed[:n_code] = code_buf
        else:
            codes = torch.zeros(n_pad, dtype=torch.uint8, device=dev)
            codes[:n] = _bitunpack(code_buf, n, code_bits)
            packed = C.pack_nibbles(codes)
    else:
        packed = torch.zeros(n_pad, dtype=torch.uint8, device=dev)
        packed[:n] = _bitunpack(code_buf, n, code_bits)
    counts = torch.from_numpy(counts_host.astype(np.int64)).to(dev)
    chunk_id = torch.repeat_interleave(
        torch.arange(nc, dtype=torch.int64, device=dev), counts)
    worst = int(counts_host.max()) if nc else 0
    if worst <= MAX_FUSED_CAP:
        cap = max(1, worst)
        slot = (torch.arange(m, dtype=torch.int64, device=dev)
                - (torch.cumsum(counts, 0) - counts)[chunk_id])
        esc_pos = torch.full((nc, cap), chunk, dtype=torch.int32, device=dev)
        esc_val = torch.zeros((nc, cap), dtype=torch.uint8, device=dev)
        esc_pos[chunk_id, slot] = pos
        esc_val[chunk_id, slot] = val
        esc_pos, layout, esc_count = C.narrow_u16(esc_pos), "chunked", counts
    else:
        cap = m
        esc_pos = C.narrow_u32(chunk_id * chunk + pos)[None]
        esc_val, layout = val.reshape(1, m), "global"
        esc_count = torch.tensor([m], device=dev)
    return C.CompressedTensor(
        sign_mantissa=sm, packed=packed, esc_pos=esc_pos, esc_val=esc_val,
        esc_count=esc_count.to(torch.int32),
        ok=torch.tensor(True, device=dev), shape=(n,),
        dtype=C.dtype_name(C.container_dtype(lay.fmt)), fmt=lay.fmt,
        exponents=lay.exponents, chunk=chunk, cap=cap, layout=layout)


# ---------------------------------------------------------------------------
# the reference encode / decode (the plain codec)
# ---------------------------------------------------------------------------

def encode(bits: torch.Tensor, codebook: Codebook, chunk: int = DEFAULT_CHUNK
           ) -> Tuple[bytes, WireStats]:
    """Serialize a raw-bit tensor (u16 for bf16, u8 for fp8) to wire bytes,
    through the reference codec on ``bits``' device."""
    flat = C.flat_bits(bits, codebook.fmt)
    ct = lossless_streams(flat, codebook, chunk, C.DEFAULT_CAP,
                          C.encode, C.encode)
    return payload_from_streams(ct)


def decode(payload: bytes, verify: bool = False, device=None) -> torch.Tensor:
    """Wire bytes -> flat raw-bit tensor (bit-exact), through the reference
    codec on ``device`` (default: the CUDA card; raises without one).

    ``verify=True`` checks the integrity-frame table before touching the
    body and raises :class:`WireIntegrityError` (carrying the corrupted
    frame indices) instead of decoding garbage."""
    ct = streams_from_payload(payload, resolve_device(device), verify=verify)
    return C.decode_to_bits(ct)


def payload_bytes_model(n: int, m: int, fmt: str = "bf16", k: int = 16,
                        chunk: int = DEFAULT_CHUNK) -> int:
    """Analytic size: must equal len(encode(...)[0])."""
    spec = FORMATS[fmt]
    code_bits = code_bits_for(k)
    n_chunks = (n + chunk - 1) // chunk
    body = (_packed_len(n, spec["mbits"] + 1) + _packed_len(n, code_bits)
            + 4 * n_chunks + 3 * m)
    return _HEADER.size + k + 4 * n_integrity_frames(body) + body
