"""Paged attention over SplitZip-compressed KV pages: wrappers, plain
versions, and the tail/merge glue (the port of
``repro.kernels.splitzip_attention``).

The decode worker keeps its KV cache compressed at rest
(:mod:`repro_torch.models.kvpool`: fixed-size, codec-chunk-aligned pages of
SplitZip streams).  ``paged_gqa_attention`` and ``paged_mla_attention`` are
the consumers: one launch per attention layer walks each row's page table,
decodes the K/V (or latent) tiles on chip and runs the flash online softmax
in f32 (``csrc/splitzip_attention.cu``), returning UN-normalized partials
``(acc, m, l)`` over the FULL pages only (``cache_len // tokens_per_page``
per row).  The raw tail page is attended by :func:`tail_partials` and merged
with :func:`merge_partials`; :func:`finalize` normalizes once.  Those three
are plain PyTorch, as the JAX package computes them outside any kernel.

``decode_pages`` runs the kernels' shared page decoder over whole pages to
container bits; it is how the in-kernel decode is held bitwise against the
plain decoder, and how the pool rehydrates on the card.

Each wrapper launches its kernel for CUDA operands and runs its plain
PyTorch version (``*_plain``) only for CPU operands; anything else raises.
``launches`` on a wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import codec as C
from repro_torch.core.codebook import FORMATS
from repro_torch.kernels import build
from repro_torch.kernels.splitzip_decode import decode_lut

NEG_INF = -1e30

#: dynamic shared memory a launch may use without raising its limit
SMEM_DEFAULT = 48 * 1024
#: the most a block may opt into on Hopper (227 KB)
SMEM_MAX = 232448
#: token sub-tile sizes tried, largest first
TILE_TOKENS = (64, 32, 16, 8, 4, 2, 1)
#: query heads that share one MLA CTA's decoded latent tiles (at most)
MLA_HEADS_PER_CTA = 8
#: rows of 1024 elements per ``decode_pages`` CTA (32 KB of shared memory)
DECODE_TILE_ROWS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_PROTOTYPES = {
    "sz_decode_pages": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "sz_paged_gqa": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P, _P] + [_I] * 15 + [ctypes.c_float] + [_I] * 3
                    + [_P, _P],
    "sz_paged_mla": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P, _P, _P] + [_I] * 15 + [ctypes.c_float]
                    + [_I] * 3 + [_P, _P],
}

Streams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


def _lib():
    return build.library("splitzip_attention", _PROTOTYPES)


# ---------------------------------------------------------------------------
# operand checks
# ---------------------------------------------------------------------------

def _check_streams(streams: Sequence[torch.Tensor], name: str, chunk: int):
    """One leaf's five page streams -> (n_pages, page_elems, cap)."""
    if len(streams) != 5:
        raise ValueError(f"{name}: expected 5 streams (sm, packed, pos, val, cnt)")
    sm, packed, pos, val, cnt = streams
    if sm.dim() != 3 or pos.dim() != 2:
        raise ValueError(f"{name}: sm must be (n_pages, page_chunks, chunk) "
                         "and esc_pos (n_pages, cap)")
    npg, pc = sm.shape[0], sm.shape[1]
    cap = pos.shape[1]
    build.check_operand(sm, f"{name} sign_mantissa", torch.uint8, (npg, pc, chunk))
    build.check_operand(packed, f"{name} packed", torch.uint8, (npg, pc, chunk // 2))
    build.check_operand(pos, f"{name} esc_pos", torch.uint16, (npg, cap))
    build.check_operand(val, f"{name} esc_val", torch.uint8, (npg, cap))
    build.check_operand(cnt, f"{name} esc_cnt", torch.int32, (npg, 1))
    return npg, pc * chunk, cap


def _check_rows(pt0, pt1, cache_len, b: int):
    if pt0.dim() != 2:
        raise ValueError("page tables must be (B, P)")
    p = pt0.shape[1]
    build.check_operand(pt0, "page_table", torch.int32, (b, p))
    build.check_operand(pt1, "page_table", torch.int32, (b, p))
    build.check_operand(cache_len, "cache_len", torch.int32, (b,))
    return p


def _tile_and_smem(tp: int, floats_fixed: int, floats_per_token: int):
    """Largest token sub-tile whose shared memory fits the default limit,
    else the smallest tile with the limit raised; raises above 227 KB."""
    for tile in TILE_TOKENS:
        tile = min(tile, tp)
        smem = 4 * (floats_fixed + tile * floats_per_token)
        if smem <= SMEM_DEFAULT:
            return tile, smem
    if smem > SMEM_MAX:
        raise ValueError(f"paged attention needs {smem} bytes of shared "
                         f"memory at a 1-token tile (limit {SMEM_MAX})")
    return tile, smem


# ---------------------------------------------------------------------------
# the page decoder
# ---------------------------------------------------------------------------

def decode_pages_plain(streams: Streams, exponents: tuple, fmt: str = "bf16",
                       chunk: int = 1024) -> torch.Tensor:
    """Pages -> container bits (n_pages, page_elems) u16/u8.

    Dense decode, then each page's escape slots ``j < min(esc_cnt, cap)``
    overwrite the exponent field in slot order; slots at ``pos >=
    page_elems`` (padding) are skipped."""
    sm, packed, pos, val, cnt = streams
    s = FORMATS[fmt]
    mbits, ebits, nbits = s["mbits"], s["ebits"], s["bits"]
    npg = sm.shape[0]
    pe = sm[0].numel() if npg else sm.shape[1] * chunk
    pk = packed.reshape(npg, pe // 2).to(torch.int32)
    code = torch.stack([pk & 0xF, pk >> 4], dim=-1).reshape(npg, pe)
    lut = torch.as_tensor(decode_lut(exponents).astype(np.int32), device=sm.device)
    e = lut[code.to(torch.int64)]
    a = sm.reshape(npg, pe).to(torch.int32)
    bits = (((a >> mbits) & 1) << (nbits - 1)) | (e << mbits) \
        | (a & ((1 << mbits) - 1))
    keep = ((1 << nbits) - 1) ^ (((1 << ebits) - 1) << mbits)
    cap = pos.shape[1]
    p = C.widen(pos).to(torch.int64)
    v = val.to(torch.int32)
    n = torch.clamp(cnt.reshape(-1), min=0, max=cap)
    for j in range(int(n.max()) if npg else 0):
        r = torch.nonzero((n > j) & (p[:, j] < pe)).reshape(-1)
        at = p[r, j]
        bits[r, at] = (bits[r, at] & keep) | (v[r, j] << mbits)
    return C.narrow(bits, C.container_dtype(fmt))


def decode_pages(streams: Streams, exponents: tuple, fmt: str = "bf16",
                 chunk: int = 1024) -> torch.Tensor:
    """Whole pages -> container bits (n_pages, page_elems): the kernels'
    shared page decoder for CUDA streams, the plain decoder for CPU ones."""
    npg, pe, cap = _check_streams(streams, "pages", chunk)
    if not build.on_cuda(*streams):
        return decode_pages_plain(streams, exponents, fmt, chunk)
    out = torch.empty((npg, pe), dtype=C.container_dtype(fmt),
                      device=streams[0].device)
    lut = decode_lut(exponents)
    lib = _lib()
    with torch.cuda.device(out.device):
        err = lib.sz_decode_pages(
            build.FMT_ID[fmt], *(t.data_ptr() for t in streams), out.data_ptr(),
            npg, pe, cap, chunk, DECODE_TILE_ROWS, lut.ctypes.data,
            build.stream_of(out))
    build.check(lib, err, "decode_pages")
    decode_pages.launches += 1
    return out


def bits_to_float(bits: torch.Tensor, fmt: str) -> torch.Tensor:
    """Container bits -> f32 values."""
    if FORMATS[fmt]["bits"] == 16:
        return C.signed_view(bits).view(torch.bfloat16).float()
    dt = torch.float8_e5m2 if fmt == "fp8_e5m2" else torch.float8_e4m3fn
    return bits.view(dt).float()


def _gather_pages(streams: Streams, table: torch.Tensor, n_pages_max: int,
                  exponents, fmt, chunk) -> torch.Tensor:
    """f32 values of each row's first ``n_pages_max`` mapped pages,
    (B, n_pages_max, page_elems); unmapped ids read page 0 as the TPU
    kernel's index map does."""
    sm, packed, pos, val, cnt = streams
    ids = torch.clamp(table[:, :n_pages_max], min=0).reshape(-1).to(torch.int64)
    sel = (sm[ids], packed[ids], C.unsigned_view(C.signed_view(pos)[ids]),
           val[ids], cnt[ids])
    vals = bits_to_float(decode_pages_plain(sel, exponents, fmt, chunk), fmt)
    return vals.reshape(table.shape[0], n_pages_max, -1)


def _causal_mask(cache_len, p: int, tp: int, nq: int) -> torch.Tensor:
    """(B, nq, Tp): key position p*Tp + t visible to query j (absolute
    position cache_len - nq + 1 + j)."""
    dev = cache_len.device
    t_pos = p * tp + torch.arange(tp, device=dev)
    q_pos = cache_len[:, None].to(torch.int64) - (nq - 1) \
        + torch.arange(nq, device=dev)
    return t_pos[None, None, :] <= q_pos[:, :, None]


def _paged_softmax(shape, width: int, pmax: int, n_full, cache_len, tp: int,
                   causal: bool, score, context):
    """The TPU kernels' page-ordered f32 online softmax, the plain version of
    both families.  ``shape`` is the partials' (B, nq, ...); ``score(p)``
    gives page p's scaled scores (B, nq, ..., Tp) and ``context(p, probs)``
    its context (B, nq, ..., width).  Rows stop at their ``n_full`` pages;
    a row with none keeps ``m = -1e30``, ``l = 0``, ``acc = 0``."""
    b, nq = shape[:2]
    dev = cache_len.device
    ones = [1] * (len(shape) - 2)
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(shape, dtype=torch.float32, device=dev)
    acc = torch.zeros((*shape, width), dtype=torch.float32, device=dev)
    for p in range(pmax):
        s = score(p)
        if causal:
            mask = _causal_mask(cache_len, p, tp, nq).reshape(b, nq, *ones, tp)
            s = torch.where(mask, s, torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        pexp = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + pexp.sum(dim=-1)
        acc_new = acc * corr[..., None] + context(p, pexp)
        on = (n_full > p).reshape(b, 1, *ones)
        m = torch.where(on, m_new, m)
        l = torch.where(on, l_new, l)
        acc = torch.where(on[..., None], acc_new, acc)
    return acc, m, l


# ---------------------------------------------------------------------------
# paged GQA
# ---------------------------------------------------------------------------

def paged_gqa_attention_plain(q, k_streams, v_streams, page_table_k,
                              page_table_v, cache_len, *, exponents: tuple,
                              fmt: str = "bf16", chunk: int,
                              tokens_per_page: int, hkv: int,
                              causal: bool = True, scale=None):
    """The TPU kernel's page-ordered f32 online softmax over the pages
    decoded by :func:`decode_pages_plain`."""
    tp = tokens_per_page
    b, nq, h, hd = q.shape
    g = h // hkv
    dv = v_streams[0].shape[1] * chunk // tp // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    n_full = torch.clamp(cache_len // tp, max=page_table_k.shape[1])
    pmax = int(n_full.max()) if b else 0
    if pmax:
        kf = _gather_pages(k_streams, page_table_k, pmax, exponents, fmt,
                           chunk).reshape(b, pmax, tp, hkv, hd)
        vf = _gather_pages(v_streams, page_table_v, pmax, exponents, fmt,
                           chunk).reshape(b, pmax, tp, hkv, dv)
    qf = q.float().reshape(b, nq, hkv, g, hd)
    acc, m, l = _paged_softmax(
        (b, nq, hkv, g), dv, pmax, n_full, cache_len, tp, causal,
        lambda p: torch.einsum("bqhgd,bthd->bqhgt", qf, kf[:, p]) * scale,
        lambda p, pexp: torch.einsum("bqhgt,bthd->bqhgd", pexp, vf[:, p]))
    return acc.reshape(b, nq, h, dv), m.reshape(b, nq, h), l.reshape(b, nq, h)


def paged_gqa_attention(q, k_streams, v_streams, page_table_k, page_table_v,
                        cache_len, *, exponents: tuple, fmt: str = "bf16",
                        chunk: int, tokens_per_page: int, hkv: int,
                        causal: bool = True, scale=None):
    """Attention over compressed K/V pages -> un-normalized partials.

    q (B, nq, H, hd) bf16; K/V 5-tuples of page streams, each leaf with its
    own page_chunks and escape cap; page tables (B, P) i32; cache_len (B,)
    i32.  Returns ``acc (B, nq, H, dv)``, ``m``, ``l`` (B, nq, H) f32 over
    the full pages; merge the raw tail with :func:`tail_partials` +
    :func:`merge_partials`, then :func:`finalize`."""
    tp = tokens_per_page
    if q.dim() != 4:
        raise ValueError("q must be (B, nq, H, hd)")
    b, nq, h, hd = q.shape
    build.check_operand(q, "q", torch.bfloat16, (b, nq, h, hd))
    npg_k, pe_k, cap_k = _check_streams(k_streams, "k", chunk)
    npg_v, pe_v, cap_v = _check_streams(v_streams, "v", chunk)
    n_pages = _check_rows(page_table_k, page_table_v, cache_len, b)
    if hkv < 1 or h % hkv or pe_k % tp or pe_v % tp \
            or pe_k // tp != hkv * hd or (pe_v // tp) % hkv:
        raise ValueError(f"inconsistent GQA page geometry: H={h} hkv={hkv} "
                         f"hd={hd} Tp={tp} page_elems k={pe_k} v={pe_v}")
    dv = pe_v // tp // hkv
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    operands = (q, *k_streams, *v_streams, page_table_k, page_table_v,
                cache_len)
    if not build.on_cuda(*operands):
        return paged_gqa_attention_plain(
            q, k_streams, v_streams, page_table_k, page_table_v, cache_len,
            exponents=exponents, fmt=fmt, chunk=chunk, tokens_per_page=tp,
            hkv=hkv, causal=causal, scale=scale)
    g = h // hkv
    rows = nq * g
    tile, smem = _tile_and_smem(
        tp, rows * hd + rows * dv + 3 * rows, (hd + 1) + (dv + 1) + rows)
    dev = q.device
    acc = torch.empty((b, nq, h, dv), dtype=torch.float32, device=dev)
    m = torch.empty((b, nq, h), dtype=torch.float32, device=dev)
    l = torch.empty((b, nq, h), dtype=torch.float32, device=dev)
    lut = decode_lut(exponents)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.sz_paged_gqa(
            build.FMT_ID[fmt], q.data_ptr(), *(t.data_ptr() for t in k_streams),
            *(t.data_ptr() for t in v_streams), page_table_k.data_ptr(),
            page_table_v.data_ptr(), cache_len.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, nq, h, hkv, hd, dv, n_pages, tp,
            pe_k, cap_k, npg_k, pe_v, cap_v, npg_v, int(bool(causal)), scale,
            tile, 128, smem, lut.ctypes.data, build.stream_of(q))
    build.check(lib, err, "paged_gqa_attention")
    paged_gqa_attention.launches += 1
    return acc, m, l


# ---------------------------------------------------------------------------
# paged MLA (absorbed form)
# ---------------------------------------------------------------------------

def paged_mla_attention_plain(q_lat, q_rope, ckv_streams, krope_streams,
                              page_table_ckv, page_table_krope, cache_len, *,
                              exponents: tuple, fmt: str = "bf16", chunk: int,
                              tokens_per_page: int, scale: float,
                              causal: bool = True):
    """The TPU kernel's page-ordered f32 online softmax, absorbed MLA: score
    ``q_lat . ckv + q_rope . krope``, context over ``ckv``."""
    tp = tokens_per_page
    b, nq, h, r = q_lat.shape
    rope = q_rope.shape[-1]
    n_full = torch.clamp(cache_len // tp, max=page_table_ckv.shape[1])
    pmax = int(n_full.max()) if b else 0
    if pmax:
        cf = _gather_pages(ckv_streams, page_table_ckv, pmax, exponents, fmt,
                           chunk).reshape(b, pmax, tp, r)
        rf = _gather_pages(krope_streams, page_table_krope, pmax, exponents,
                           fmt, chunk).reshape(b, pmax, tp, rope)
    qlf, qrf = q_lat.float(), q_rope.float()
    return _paged_softmax(
        (b, nq, h), r, pmax, n_full, cache_len, tp, causal,
        lambda p: (torch.einsum("bqhr,btr->bqht", qlf, cf[:, p])
                   + torch.einsum("bqhp,btp->bqht", qrf, rf[:, p])) * scale,
        lambda p, pexp: torch.einsum("bqht,btr->bqhr", pexp, cf[:, p]))


def mla_heads_per_cta(h: int) -> int:
    """Query heads sharing one CTA: the largest divisor of H up to 8."""
    return max(d for d in range(1, min(h, MLA_HEADS_PER_CTA) + 1) if h % d == 0)


def paged_mla_attention(q_lat, q_rope, ckv_streams, krope_streams,
                        page_table_ckv, page_table_krope, cache_len, *,
                        exponents: tuple, fmt: str = "bf16", chunk: int,
                        tokens_per_page: int, scale: float,
                        causal: bool = True):
    """Absorbed-form MLA attention over compressed latent pages.

    q_lat (B, nq, H, kv_rank) and q_rope (B, nq, H, rope) bf16; ckv and
    krope 5-tuples with their own page_chunks and caps.  Returns ``acc (B,
    nq, H, kv_rank)`` (latent space), ``m``, ``l`` (B, nq, H) f32; the
    caller applies the ``w_v``/``wo`` up-projections after the tail merge."""
    tp = tokens_per_page
    if q_lat.dim() != 4 or q_rope.dim() != 4:
        raise ValueError("q_lat and q_rope must be (B, nq, H, ·)")
    b, nq, h, r = q_lat.shape
    rope = q_rope.shape[-1]
    build.check_operand(q_lat, "q_lat", torch.bfloat16, (b, nq, h, r))
    build.check_operand(q_rope, "q_rope", torch.bfloat16, (b, nq, h, rope))
    npg_c, pe_c, cap_c = _check_streams(ckv_streams, "ckv", chunk)
    npg_r, pe_r, cap_r = _check_streams(krope_streams, "krope", chunk)
    n_pages = _check_rows(page_table_ckv, page_table_krope, cache_len, b)
    if pe_c != tp * r or pe_r != tp * rope:
        raise ValueError(f"inconsistent MLA page geometry: Tp={tp} r={r} "
                         f"rope={rope} page_elems ckv={pe_c} krope={pe_r}")
    operands = (q_lat, q_rope, *ckv_streams, *krope_streams, page_table_ckv,
                page_table_krope, cache_len)
    if not build.on_cuda(*operands):
        return paged_mla_attention_plain(
            q_lat, q_rope, ckv_streams, krope_streams, page_table_ckv,
            page_table_krope, cache_len, exponents=exponents, fmt=fmt,
            chunk=chunk, tokens_per_page=tp, scale=scale, causal=causal)
    hpc = mla_heads_per_cta(h)
    rows = nq * hpc
    tile, smem = _tile_and_smem(
        tp, rows * r + rows * rope + rows * r + 3 * rows,
        (r + 1) + (rope + 1) + rows)
    dev = q_lat.device
    acc = torch.empty((b, nq, h, r), dtype=torch.float32, device=dev)
    m = torch.empty((b, nq, h), dtype=torch.float32, device=dev)
    l = torch.empty((b, nq, h), dtype=torch.float32, device=dev)
    lut = decode_lut(exponents)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.sz_paged_mla(
            build.FMT_ID[fmt], q_lat.data_ptr(), q_rope.data_ptr(),
            *(t.data_ptr() for t in ckv_streams),
            *(t.data_ptr() for t in krope_streams), page_table_ckv.data_ptr(),
            page_table_krope.data_ptr(), cache_len.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, nq, h, hpc, r, rope, n_pages, tp,
            pe_c, cap_c, npg_c, pe_r, cap_r, npg_r, int(bool(causal)),
            float(scale), tile, 256, smem, lut.ctypes.data,
            build.stream_of(q_lat))
    build.check(lib, err, "paged_mla_attention")
    paged_mla_attention.launches += 1
    return acc, m, l


decode_pages.launches = 0
paged_gqa_attention.launches = 0
paged_mla_attention.launches = 0


# ---------------------------------------------------------------------------
# tail partials + softmax-partial merge (shared by both families)
# ---------------------------------------------------------------------------

def tail_partials(s: torch.Tensor, v: torch.Tensor, valid: torch.Tensor):
    """Un-normalized flash partials for the raw tail page.

    ``s``: (B, nq, ..., T) f32 scores (already scaled), ``v``: (B, T, dv) or
    (B, T, hkv, dv) values, ``valid``: (B, T) bool.  Returns (acc, m, l)
    shaped like the kernel partials so :func:`merge_partials` composes."""
    extra = s.dim() - 3                                    # dims between nq and T
    vm = valid.reshape(valid.shape[0], *([1] * (extra + 1)), valid.shape[1])
    s = torch.where(vm, s, torch.tensor(NEG_INF, device=s.device))
    m = s.amax(dim=-1)
    pexp = torch.exp(s - m[..., None])
    l = pexp.sum(dim=-1)
    if v.dim() == 3:                                       # (B, T, dv) latent
        acc = torch.einsum("bqht,btd->bqhd", pexp, v)
    else:                                                  # (B, T, hkv, dv)
        acc = torch.einsum("bqhgt,bthd->bqhgd", pexp, v)
    return acc, m, l


def merge_partials(a, b):
    """Combine two un-normalized flash partials (acc, m, l)."""
    acc_a, m_a, l_a = a
    acc_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    ca = torch.exp(m_a - m)
    cb = torch.exp(m_b - m)
    return (acc_a * ca[..., None] + acc_b * cb[..., None],
            m, l_a * ca + l_b * cb)


def finalize(acc, l, dtype=torch.bfloat16):
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(dtype)


def attend_tail(partials, s_tail: torch.Tensor, v_tail: torch.Tensor,
                t: torch.Tensor, dtype) -> torch.Tensor:
    """The kernel's partials merged with the raw tail page's, normalized.

    ``s_tail`` (B, nq, ..., Tp) are the scaled scores over the tail page,
    ``v_tail`` its values as :func:`tail_partials` takes them, ``t`` (B,)
    each row's slot of the new token: slots ``<= t`` are valid."""
    tp = s_tail.shape[-1]
    valid = torch.arange(tp, device=s_tail.device)[None, :] < (t + 1)[:, None]
    acc, _, l = merge_partials(partials, tail_partials(s_tail, v_tail, valid))
    return finalize(acc, l, dtype)
