"""SplitZip reference codec on PyTorch tensors (paper §3.2).

The counterpart of ``repro.core.codec``: the plain, straightforward codec that
every CUDA kernel of :mod:`repro_torch.kernels` is held against, and that the
``torch`` backend runs.  It produces the same static-shape streams as the JAX
codec, field for field and bit for bit:

  sign_mantissa : u8[N]              exact `a_i` bytes (dense stream 1)
  packed        : u8[N//2]           two 4-bit codes per byte (dense stream 2)
  esc_pos       : u16[C, cap]        chunk-relative escape positions
                  (u32[1, cap] global element indices for layout='global')
  esc_val       : u8[C, cap]         raw escaped exponents
  esc_count     : i32[C]             true escapes per chunk (may exceed cap)
  ok            : bool[]             no chunk overflowed its escape capacity

Bits only: container bits are never routed through float arithmetic, so NaN
payloads, -0.0 and subnormals survive.  PyTorch implements few operations on
``uint16``/``uint32``, so the arithmetic runs on int32/int64 widenings and on
same-width signed views; only the returned streams carry the unsigned stream
dtypes of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import abstract as AB
from repro_torch.core.codebook import FORMATS, Codebook

DEFAULT_CHUNK = 1024  # paper §4.1: "chunked escape value with chunk size 1024"
DEFAULT_CAP = 64      # escape capacity per chunk (6.25%; paper's ε ≈ 0.16%)

# unsigned dtype -> the signed dtype of the same width PyTorch fully supports
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32}
_UNSIGNED = {torch.int16: torch.uint16, torch.int32: torch.uint32}


@dataclasses.dataclass(frozen=True)
class CompressedTensor:
    """The SplitZip streams of one tensor plus their static metadata."""

    sign_mantissa: torch.Tensor  # u8[N]
    packed: torch.Tensor         # u8[N//2] (nibble-packed, k<=16) or u8[N] (k>16)
    esc_pos: torch.Tensor        # u16[C, cap] (chunked) | u32[1, cap] (global)
    esc_val: torch.Tensor        # u8[C, cap]
    esc_count: torch.Tensor      # i32[C]
    ok: torch.Tensor             # bool[]

    shape: tuple
    dtype: str                   # numpy-style name, e.g. 'bfloat16'
    fmt: str
    exponents: tuple
    chunk: int
    cap: int
    # 'chunked' (paper layout) or 'global' (two-level compaction, beyond-paper)
    layout: str = "chunked"

    @property
    def codebook(self) -> Codebook:
        return Codebook(fmt=self.fmt, exponents=self.exponents)

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def n_padded(self) -> int:
        return self.sign_mantissa.shape[0]

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """The streams in the JAX pytree's leaf order."""
        return (self.sign_mantissa, self.packed, self.esc_pos, self.esc_val,
                self.esc_count, self.ok)


# ---------------------------------------------------------------------------
# bit plumbing
# ---------------------------------------------------------------------------

def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``'bfloat16'`` (numpy/JAX spelling)."""
    return str(dtype).replace("torch.", "")


def dtype_from_name(name: str) -> torch.dtype:
    return getattr(torch, name)


def container_dtype(fmt: str) -> torch.dtype:
    return torch.uint16 if FORMATS[fmt]["bits"] == 16 else torch.uint8


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """Same-width signed view of a u16/u32 tensor (identity otherwise):
    copies, concatenation, indexing and bitwise ops work on every device."""
    return t.view(_SIGNED[t.dtype]) if t.dtype in _SIGNED else t


def unsigned_view(t: torch.Tensor) -> torch.Tensor:
    return t.view(_UNSIGNED[t.dtype]) if t.dtype in _UNSIGNED else t


def widen(t: torch.Tensor) -> torch.Tensor:
    """Zero-extend unsigned integer bits: u8/u16 -> int32, u32 -> int64."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.int32)


def narrow_u16(t: torch.Tensor) -> torch.Tensor:
    """Integers in [0, 2**16) -> u16 (wrapping cast through int16)."""
    return t.to(torch.int16).view(torch.uint16)


def narrow_u32(t: torch.Tensor) -> torch.Tensor:
    """Integers in [0, 2**32) -> u32 (wrapping cast through int32)."""
    return t.to(torch.int32).view(torch.uint32)


def narrow(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer tensor -> unsigned container ``dtype``, keeping the low bits."""
    if dtype == torch.uint16:
        return narrow_u16(t & 0xFFFF)
    if dtype == torch.uint32:
        return narrow_u32(t & 0xFFFFFFFF)
    return (t & 0xFF).to(dtype)


def to_bits(x: torch.Tensor, fmt: str = "bf16") -> torch.Tensor:
    """Bitcast a float tensor to its unsigned container type (u16 | u8)."""
    want = container_dtype(fmt)
    if x.dtype == want:
        return x
    if x.dtype in (torch.uint16, torch.uint8):
        return narrow(widen(x), want)
    return x.view(want)


def flat_bits(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` as a flat container-bit tensor (a copy only if ``x`` is not
    contiguous, made in the signed view: PyTorch copies u16 on the CPU only)."""
    return unsigned_view(signed_view(to_bits(x, fmt)).reshape(-1))


def from_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if bits.dtype == dtype:
        return bits
    return bits.view(dtype)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two tensors of the same dtype (NaN-safe)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = a.view(ints[a.element_size()]), b.view(ints[b.element_size()])
    return bool(torch.equal(signed_view(a), signed_view(b)))


def split_fields(bits: torch.Tensor, fmt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """bits -> (exponent u8, sign_mantissa u8).  Paper §3.2 exactly (bf16):
    e = (x >> 7) & 0xff ;  a = ((x >> 8) & 0x80) | (x & 0x7f)."""
    s = FORMATS[fmt]
    ebits, mbits = s["ebits"], s["mbits"]
    b = widen(bits)
    e = (b >> mbits) & ((1 << ebits) - 1)
    a = ((b >> ebits) & (1 << mbits)) | (b & ((1 << mbits) - 1))
    return e.to(torch.uint8), a.to(torch.uint8)


def join_fields(e: torch.Tensor, a: torch.Tensor, fmt: str) -> torch.Tensor:
    """(exponent, sign_mantissa) -> container bits.  Paper §3.2:
    x = ((a & 0x80) << 8) | (e << 7) | (a & 0x7f)   (bf16 instance)."""
    s = FORMATS[fmt]
    mbits, nbits = s["mbits"], s["bits"]
    ei = e.to(torch.int32)
    ai = a.to(torch.int32)
    sign = (ai >> mbits) & 1
    out = (sign << (nbits - 1)) | (ei << mbits) | (ai & ((1 << mbits) - 1))
    return narrow(out, container_dtype(fmt))


# ---------------------------------------------------------------------------
# dense path: code assignment and lookup
# ---------------------------------------------------------------------------

def _lut(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), device=device)


def assign_codes(e: torch.Tensor, exponents: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    """exponent byte -> (code u8, member bool).

    The code is the index of the matching codebook entry.  Escapes get the
    dummy code 0 (paper §3.4) and are fixed by the sparse correction."""
    code_t = np.zeros(256, dtype=np.uint8)
    member_t = np.zeros(256, dtype=bool)
    for code, ce in enumerate(exponents):
        code_t[ce] = code
        member_t[ce] = True
    idx = e.to(torch.int64)
    return _lut(code_t, e.device)[idx], _lut(member_t, e.device)[idx]


def decode_codes(code: torch.Tensor, exponents: tuple) -> torch.Tensor:
    """code -> exponent; codes beyond the codebook decode to 0."""
    table = np.zeros(256, dtype=np.uint8)
    table[:len(exponents)] = exponents
    return _lut(table, code.device)[code.to(torch.int64)]


def pack_nibbles(code: torch.Tensor) -> torch.Tensor:
    """[N] 4-bit codes -> [N//2] bytes; element 2i low nibble, 2i+1 high."""
    lo = code[0::2].to(torch.uint8)
    hi = code[1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(-1)


# ---------------------------------------------------------------------------
# escape collection: per-chunk ranks + bounded scatter
# ---------------------------------------------------------------------------

def collect_escapes(
    e: torch.Tensor, member: torch.Tensor, chunk: int, cap: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact escape (position, value) pairs into fixed-capacity buffers.

    Ranks are an inclusive cumsum of the escape mask per chunk; an escape of
    rank ``r < cap`` lands in slot ``r``, everything else in a spill column
    that is cut off.  Padding entries carry position == chunk.  Returns
    (esc_pos u16[C,cap], esc_val u8[C,cap], esc_count i32[C], ok bool[])."""
    c = e.shape[0] // chunk
    e2 = e.reshape(c, chunk).to(torch.int32)
    is_esc = ~member.reshape(c, chunk)
    flags = is_esc.to(torch.int32)
    rank = torch.cumsum(flags, dim=-1) - 1
    esc_count = flags.sum(dim=-1, dtype=torch.int32)
    ok = torch.all(esc_count <= cap)
    col = torch.where(is_esc & (rank < cap), rank, cap).to(torch.int64)
    pos = torch.arange(chunk, dtype=torch.int32, device=e.device).expand(c, chunk)
    esc_pos = torch.full((c, cap + 1), chunk, dtype=torch.int32, device=e.device)
    esc_val = torch.zeros((c, cap + 1), dtype=torch.int32, device=e.device)
    esc_pos.scatter_(1, col, pos)
    esc_val.scatter_(1, col, e2)
    return (narrow_u16(esc_pos[:, :cap].contiguous()),
            esc_val[:, :cap].to(torch.uint8), esc_count, ok)


def scatter_escapes(
    e_decoded: torch.Tensor, esc_pos: torch.Tensor, esc_val: torch.Tensor,
    chunk: int,
) -> torch.Tensor:
    """Sparse correction: overwrite decoded exponents at escape positions
    (padding entries, position >= chunk, are dropped)."""
    c = esc_pos.shape[0]
    pos = widen(esc_pos).to(torch.int64)
    base = (torch.arange(c, dtype=torch.int64, device=pos.device) * chunk)[:, None]
    valid = pos < chunk
    out = e_decoded.clone()
    out[(base + pos)[valid]] = esc_val[valid]
    return out


# ---------------------------------------------------------------------------
# two-level (global) escape compaction — beyond the paper
#
# A per-chunk capacity must absorb the WORST single chunk, so the static
# buffers cost chunks*cap*3 bytes even when almost every slot is padding.  A
# single per-tensor buffer only absorbs the TOTAL escape count; positions
# widen to u32 (5 bytes/escape instead of 3).
# ---------------------------------------------------------------------------

def collect_escapes_global(
    e: torch.Tensor, member: torch.Tensor, total_cap: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact escapes into one per-tensor buffer, in position order.

    Returns (esc_pos u32[1, total_cap] element indices, esc_val
    u8[1, total_cap], esc_count i32[1], ok bool[]).  Padding entries carry
    position == N."""
    n = e.shape[0]
    where = torch.nonzero(~member).reshape(-1)            # ascending positions
    esc_count = torch.tensor([where.numel()], dtype=torch.int32, device=e.device)
    ok = esc_count[0] <= total_cap
    kept = where[:total_cap]
    esc_pos = torch.full((total_cap,), n, dtype=torch.int64, device=e.device)
    esc_val = torch.zeros((total_cap,), dtype=torch.uint8, device=e.device)
    esc_pos[:kept.numel()] = kept
    esc_val[:kept.numel()] = e[kept]
    return narrow_u32(esc_pos)[None], esc_val[None], esc_count, ok


def scatter_escapes_global(
    e_decoded: torch.Tensor, esc_pos: torch.Tensor, esc_val: torch.Tensor
) -> torch.Tensor:
    """Sparse correction for the global layout (positions are element indices)."""
    pos = widen(esc_pos).reshape(-1)
    val = esc_val.reshape(-1)
    valid = pos < e_decoded.shape[0]                       # padding == N
    out = e_decoded.clone()
    out[pos[valid]] = val[valid]
    return out


def compact_chunked_to_global(
    esc_pos_c: torch.Tensor, esc_val_c: torch.Tensor, esc_count_c: torch.Tensor,
    chunk: int, total_cap: int, n: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Second-level compaction: per-chunk escape buffers -> one global buffer.

    Touches only the ``C x cap1`` entries the fused encode kernel produced,
    never the stream.  Entries stay in position order, so when nothing is
    dropped the output equals :func:`collect_escapes_global` on the same
    data.  ``ok`` also requires that no chunk overflowed its level-1 buffer
    (such a chunk already lost escapes)."""
    c, cap1 = esc_pos_c.shape
    dev = esc_pos_c.device
    count = esc_count_c.to(torch.int64)
    cnt = torch.clamp(count, max=cap1)                     # entries present
    jj = torch.arange(cap1, dtype=torch.int64, device=dev)[None, :]
    offsets = (torch.cumsum(cnt, 0) - cnt)[:, None]        # exclusive over chunks
    rank = offsets + jj
    gpos = (torch.arange(c, dtype=torch.int64, device=dev)[:, None] * chunk
            + widen(esc_pos_c).to(torch.int64))
    sel = (jj < cnt[:, None]) & (rank < total_cap)
    esc_pos = torch.full((total_cap,), n, dtype=torch.int64, device=dev)
    esc_val = torch.zeros((total_cap,), dtype=torch.uint8, device=dev)
    r, g, v = AB.used_slots(sel, rank, gpos, esc_val_c)
    esc_pos[r] = g
    esc_val[r] = v
    total = count.sum().to(torch.int32)
    ok = (total <= total_cap) & torch.all(count <= cap1)
    return narrow_u32(esc_pos)[None], esc_val[None], total[None], ok


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _pad_to_chunk(flat: torch.Tensor, chunk: int, pad_bits: int) -> torch.Tensor:
    n = flat.shape[0]
    pad = (-n) % chunk
    if pad:
        sv = signed_view(flat)
        fill = torch.full((pad,), pad_bits, dtype=sv.dtype, device=flat.device)
        flat = unsigned_view(torch.cat([sv, fill]))
    return flat


def pad_bits_for(codebook: Codebook) -> int:
    """Padding container bits: the most frequent exponent, zero sign and
    mantissa, so padding never escapes."""
    return int(codebook.exponents[0]) << FORMATS[codebook.fmt]["mbits"]


def default_global_cap(n: int, budget: float = 0.01) -> int:
    """Static per-tensor escape capacity for layout='global': a 1% escape
    budget (6x the paper's worst layer-wise escape rate), rounded up to a
    multiple of 128."""
    return max(128, int(-(-n * budget // 128)) * 128)


def encode(
    x: torch.Tensor,
    codebook: Codebook,
    chunk: int = DEFAULT_CHUNK,
    cap: int = DEFAULT_CAP,
    layout: str = "chunked",
) -> CompressedTensor:
    """SplitZip encode (paper §3.2, encoding path).

    Stage 1 (dense): split fields, assign 4-bit codes, pack nibbles, store
    sign-mantissa exactly.  Stage 2 (sparse): compact uncovered exponents
    into escape buffers — per chunk (paper layout) or one per-tensor buffer
    (layout='global'; ``cap`` is then the TOTAL capacity, default from
    :func:`default_global_cap`)."""
    fmt = codebook.fmt
    bits = _pad_to_chunk(flat_bits(x, fmt), chunk, pad_bits_for(codebook))
    e, a = split_fields(bits, fmt)
    code, member = assign_codes(e, codebook.exponents)
    packed = pack_nibbles(code) if codebook.k <= 16 else code
    if layout == "global":
        cap = default_global_cap(bits.shape[0]) if cap == DEFAULT_CAP else cap
        esc_pos, esc_val, esc_count, ok = collect_escapes_global(e, member, cap)
    else:
        esc_pos, esc_val, esc_count, ok = collect_escapes(e, member, chunk, cap)
    return CompressedTensor(
        sign_mantissa=a, packed=packed, esc_pos=esc_pos, esc_val=esc_val,
        esc_count=esc_count, ok=ok, shape=tuple(x.shape),
        dtype=dtype_name(x.dtype), fmt=fmt,
        exponents=tuple(int(v) for v in codebook.exponents), chunk=chunk,
        cap=cap, layout=layout)


def decode_to_bits(ct: CompressedTensor) -> torch.Tensor:
    """SplitZip decode to the FLAT container bit stream (length n_elements):
    dense unpack + lookup + reassemble, then the sparse overwrite."""
    code = unpack_nibbles(ct.packed) if len(ct.exponents) <= 16 else ct.packed
    e = decode_codes(code, ct.exponents)
    if ct.layout == "global":
        e = scatter_escapes_global(e, ct.esc_pos, ct.esc_val)
    else:
        e = scatter_escapes(e, ct.esc_pos, ct.esc_val, ct.chunk)
    return join_fields(e, ct.sign_mantissa, ct.fmt)[:ct.n_elements]


def decode(ct: CompressedTensor) -> torch.Tensor:
    bits = decode_to_bits(ct).reshape(ct.shape)
    return from_bits(bits, dtype_from_name(ct.dtype))


# ---------------------------------------------------------------------------
# byte accounting (paper §3.2 size model)
# ---------------------------------------------------------------------------

def compressed_bytes(ct: CompressedTensor) -> float:
    """Exact wire bytes under the paper's layout: N sign-mantissa + N/2
    codes + 3 bytes per escape (5 for layout='global').  Uses the TRUE
    element count (chunk padding never ships).  Computed in float64, so it
    is exact at every tensor size."""
    s = FORMATS[ct.fmt]
    n = ct.n_elements
    dense = n * (1 + s["mbits"]) / 8.0
    k = len(ct.exponents)
    code_bits = max(1, int(np.ceil(np.log2(max(2, k)))))
    codes = n * code_bits / 8.0
    per_escape = 5.0 if ct.layout == "global" else 3.0
    return dense + codes + per_escape * AB.n_used_slots(ct.esc_count,
                                                        ct.esc_pos.numel())


def static_stream_bytes(ct: CompressedTensor) -> int:
    """Bytes the fixed-shape streams occupy, padding slots included."""
    return int(ct.sign_mantissa.numel() + ct.packed.numel()
               + ct.esc_pos.numel() * ct.esc_pos.element_size()
               + ct.esc_val.numel() + ct.esc_count.numel() * 4 + 1)


def raw_bytes(ct: CompressedTensor) -> float:
    return ct.n_elements * FORMATS[ct.fmt]["bits"] / 8.0


def roundtrip_ok(x: torch.Tensor, ct: CompressedTensor) -> torch.Tensor:
    """Bit-level equality of ``x`` and the decode of ``ct`` (a 0-d bool
    tensor; float ``==`` would fail on NaN)."""
    a = signed_view(flat_bits(x, ct.fmt))
    b = signed_view(flat_bits(decode(ct), ct.fmt))
    return torch.all(a == b)


def compression_ratio(ct: CompressedTensor) -> float:
    return raw_bytes(ct) / compressed_bytes(ct)


def _code_bits(k: int) -> int:
    return max(1, int(np.ceil(np.log2(max(2, k)))))


def theoretical_ratio(fmt: str = "bf16", k: int = 16, escape_rate: float = 0.0) -> float:
    """ρ = 2 / (3/2 + 3ε) for bf16/top-16; generalized per format/k."""
    s = FORMATS[fmt]
    per_elem_bytes = (1 + s["mbits"]) / 8.0 + _code_bits(k) / 8.0 + 3.0 * escape_rate
    return (s["bits"] / 8.0) / per_elem_bytes


# ---------------------------------------------------------------------------
# Top-15 + sentinel variant (paper §3.4 / Table 6 ablation)
# ---------------------------------------------------------------------------

SENTINEL = 15


@dataclasses.dataclass(frozen=True)
class SentinelCompressed:
    """Streams of the top-15 + escape-token design: code 15 marks an escape,
    whose value sits in ``esc_val`` in occurrence order (no positions)."""

    sign_mantissa: torch.Tensor  # u8[N]
    packed: torch.Tensor         # u8[N//2]
    esc_val: torch.Tensor        # u8[C, cap] escape values in occurrence order
    esc_count: torch.Tensor      # i32[C]
    ok: torch.Tensor             # bool[]
    shape: tuple
    dtype: str
    fmt: str
    exponents: tuple             # 15 entries
    chunk: int
    cap: int


def encode_sentinel(x: torch.Tensor, codebook: Codebook, chunk: int = DEFAULT_CHUNK,
                    cap: int = DEFAULT_CAP) -> SentinelCompressed:
    """Top-15 + escape-token encode: saves 2 bytes an escape (no position)
    but makes decode irregular."""
    exps = tuple(int(e) for e in codebook.exponents[:15])
    fmt = codebook.fmt
    pad = exps[0] << FORMATS[fmt]["mbits"]
    bits = _pad_to_chunk(flat_bits(x, fmt), chunk, pad)
    e, a = split_fields(bits, fmt)
    code, member = assign_codes(e, exps)
    code = torch.where(member, code, torch.full_like(code, SENTINEL))
    _, esc_val, esc_count, ok = collect_escapes(e, member, chunk, cap)
    return SentinelCompressed(
        sign_mantissa=a, packed=pack_nibbles(code), esc_val=esc_val,
        esc_count=esc_count, ok=ok, shape=tuple(x.shape),
        dtype=dtype_name(x.dtype), fmt=fmt, exponents=exps, chunk=chunk,
        cap=cap)


def decode_sentinel(ct: SentinelCompressed) -> torch.Tensor:
    """Irregular decode: every element inspects the code stream for the
    sentinel, sentinels are ranked per chunk, and the rank (clipped to
    ``cap - 1``, as the JAX package clips it) gathers from the values."""
    code = unpack_nibbles(ct.packed)
    is_esc = code == SENTINEL
    e = decode_codes(torch.where(is_esc, torch.zeros_like(code), code),
                     ct.exponents)
    c = ct.esc_val.shape[0]
    is_esc2 = is_esc.reshape(c, ct.chunk)
    rank = torch.cumsum(is_esc2.to(torch.int32), dim=-1) - 1
    rank = torch.clamp(rank, 0, ct.cap - 1).to(torch.int64)
    vals = torch.gather(ct.esc_val, 1, rank)
    e = torch.where(is_esc2, vals, e.reshape(c, ct.chunk)).reshape(-1)
    bits = join_fields(e, ct.sign_mantissa, ct.fmt)
    n = int(np.prod(ct.shape)) if ct.shape else 1
    return from_bits(bits[:n].reshape(ct.shape), dtype_from_name(ct.dtype))


def sentinel_bytes(ct: SentinelCompressed) -> float:
    """N + N/2 + 1 byte per escape (values only)."""
    s = FORMATS[ct.fmt]
    n = ct.sign_mantissa.shape[0]
    return n * (1 + s["mbits"]) / 8.0 + n * 0.5 + 1.0 * int(ct.esc_count.sum())


# ---------------------------------------------------------------------------
# Dynamic (per-call) calibration variant (paper §4.3.5 ablation)
# ---------------------------------------------------------------------------

def dynamic_topk_exponents(bits: torch.Tensor, fmt: str = "bf16",
                           k: int = 16) -> torch.Tensor:
    """Online histogram + top-k selection (the expensive path the paper's
    pre-calibration avoids): the ``k`` most frequent exponents, u8.  Equal
    counts keep the lower exponent first, as ``jax.lax.top_k`` does (a
    stable descending sort; ``torch.topk`` promises no order)."""
    e, _ = split_fields(flat_bits(bits, fmt), fmt)
    hist = torch.bincount(e.to(torch.int64), minlength=1 << FORMATS[fmt]["ebits"])
    order = torch.sort(hist, descending=True, stable=True).indices
    return order[:k].to(torch.uint8)


def encode_with_dynamic_codebook(x: torch.Tensor, fmt: str = "bf16", k: int = 16,
                                 chunk: int = DEFAULT_CHUNK, cap: int = DEFAULT_CAP):
    """Dynamic-codebook encode: rebuild the codebook per input (slow path).
    Returns ``((sign_mantissa, packed, esc_pos, esc_val, esc_count, ok),
    codebook u8[k])``."""
    bits = flat_bits(x, fmt)
    cb = dynamic_topk_exponents(bits, fmt, k)
    bits = _pad_to_chunk(bits, chunk, int(cb[0]) << FORMATS[fmt]["mbits"])
    e, a = split_fields(bits, fmt)
    eq = e[..., None] == cb
    member = eq.any(dim=-1)
    code = (eq.to(torch.int32) * torch.arange(k, device=e.device)).sum(dim=-1)
    packed = pack_nibbles(code.to(torch.uint8))
    esc_pos, esc_val, esc_count, ok = collect_escapes(e, member, chunk, cap)
    return (a, packed, esc_pos, esc_val, esc_count, ok), cb


def decode_with_dynamic_codebook(streams, cb: torch.Tensor, shape, dtype,
                                 fmt: str = "bf16",
                                 chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    a, packed, esc_pos, esc_val, _, _ = streams
    code = unpack_nibbles(packed).to(torch.int64)
    e = torch.where(code < cb.numel(), cb[torch.clamp(code, max=cb.numel() - 1)],
                    torch.zeros_like(cb[:1]))
    e = scatter_escapes(e, esc_pos, esc_val, chunk)
    bits = join_fields(e, a, fmt)
    n = int(np.prod(shape)) if shape else 1
    dtype = dtype if isinstance(dtype, torch.dtype) else dtype_from_name(str(dtype))
    return from_bits(bits[:n].reshape(shape), dtype)
