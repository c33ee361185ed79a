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

Both attention kernels split each row's full pages across the card
(flash-decoding): a grid of (row, KV head or head group, split) CTAs, each
over a contiguous range of the row's pages (:func:`split_count`,
:func:`split_ranges`), writes un-normalized partials per split, and a
second small kernel merges them (:func:`merge_splits` is its plain
version) into exactly the unsplit partials.  ``paged_mla_attention`` gives
one CTA all the heads of a row that fit (:func:`mla_head_group`: all 40 of
minicpm3-4b's at decode) and runs both of its products on the tensor
cores.

Each wrapper launches its kernels for CUDA operands and runs its plain
PyTorch version (``*_plain``) only for CPU operands; anything else raises.
``launches`` on a wrapper counts its calls that launched (one call launches
the split kernel and, with more than one split, the merge kernel).  Under
the dry run's abstract run (:mod:`repro_torch.core.abstract`) fake
operands get fake outputs and the kernel's work (:func:`paged_work`, every
page of the table counted full) credited to the run; nothing launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import codec as C
from repro_torch.core.codebook import FORMATS
from repro_torch.core import abstract as AB
from repro_torch.kernels import build
from repro_torch.kernels.splitzip_decode import decode_lut

NEG_INF = -1e30

#: the most shared memory a block may opt into on Hopper (227 KB)
SMEM_MAX = 232448
#: token sub-tile sizes tried, largest first
TILE_TOKENS = (64, 32, 16, 8, 4, 2, 1)
#: rows of 1024 elements per ``decode_pages`` CTA (32 KB of shared memory)
DECODE_TILE_ROWS = 8
#: a split grid covers the card's SMs at least this many times
SPLIT_WAVES = 2
#: shared memory a GQA split CTA aims under (two or three CTAs an SM)
GQA_SMEM_BUDGET = 96 * 1024
#: elements a split kernel's thread copies at once (16 B of sign-mantissa
#: bytes, 8 B of codes): GQA's hd and dv and MLA's rope must be multiples
#: of it on the card
VEC = 16
#: query rows (nq x heads) an MLA CTA takes at most: four 16-row M tiles
MLA_MAX_ROWS = 64
#: tokens an MLA tile takes at most (the score fragment's width)
MLA_TILE = 64
#: the widest kv_rank the MLA kernel takes (16 x 128 f32 of acc a warp)
MLA_MAX_RANK = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_PROTOTYPES = {
    "sz_decode_pages": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "sz_paged_gqa": [_I] + [_P] * 20 + [_I] * 15 + [ctypes.c_float]
                    + [_I] * 2 + [_P, _P],
    "sz_paged_mla": [_I] + [_P] * 21 + [_I] * 15 + [ctypes.c_float]
                    + [_I] * 2 + [_P, _P],
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
    abstract = AB.on_card(*streams)
    if not abstract and not build.on_cuda(*streams):
        return decode_pages_plain(streams, exponents, fmt, chunk)
    out = torch.empty((npg, pe), dtype=C.container_dtype(fmt),
                      device=streams[0].device)
    if abstract:
        AB.credit("decode_pages", npg * (page_bytes(streams)
                                         + pe * out.element_size()), 12 * npg * pe)
        return out
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


def page_bytes(streams: Streams) -> float:
    """Bytes one page's five streams hold: its elements' sign-mantissa
    bytes and codes, 3 bytes an escape slot and its count."""
    sm, _, pos, _, _ = streams
    return 1.5 * sm.shape[1] * sm.shape[2] + 3 * pos.shape[1] + 4


def paged_work(b: int, nq: int, h: int, n_full: int, tokens_per_page: int,
               streams0: Streams, streams1: Streams, q_bytes: int,
               width: int, out_w: int):
    """(bytes, operations) a paged attention call must move and do over
    ``n_full`` full pages in all (every row's): each page's compressed
    streams and its two page-table entries read once, q read, the f32
    partials written; ``nq * H * tokens_per_page * width`` multiply-adds a
    page, two operations each.  The dry run's static figure counts every
    page of the table full."""
    nbytes = (n_full * (page_bytes(streams0) + page_bytes(streams1) + 8)
              + q_bytes + b * nq * h * (out_w + 2) * 4 + b * 4)
    return nbytes, n_full * 2 * nq * h * tokens_per_page * width


def _abstract_partials(kernel: str, b, nq, h, out_w, n_pages, tp, s0, s1,
                       q_bytes, width, device):
    """The abstract form of a paged kernel: fake partials, its work
    credited with every page of the table full."""
    AB.credit(kernel, *paged_work(b, nq, h, b * n_pages, tp, s0, s1, q_bytes,
                                  width, out_w))
    return (torch.empty((b, nq, h, out_w), dtype=torch.float32, device=device),
            torch.empty((b, nq, h), dtype=torch.float32, device=device),
            torch.empty((b, nq, h), dtype=torch.float32, device=device))


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
                   causal: bool, score, context, first: int = 0):
    """The TPU kernels' page-ordered f32 online softmax, the plain version of
    both families.  ``shape`` is the partials' (B, nq, ...); ``score(p)``
    gives page p's scaled scores (B, nq, ..., Tp) and ``context(p, probs)``
    its context (B, nq, ..., width).  Rows run pages ``first`` to their
    ``n_full``; a row with none keeps ``m = -1e30``, ``l = 0``,
    ``acc = 0``."""
    b, nq = shape[:2]
    dev = cache_len.device
    ones = [1] * (len(shape) - 2)
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(shape, dtype=torch.float32, device=dev)
    acc = torch.zeros((*shape, width), dtype=torch.float32, device=dev)
    for p in range(first, pmax):
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


def split_count(n_sm: int, b: int, groups: int, n_pages: int) -> int:
    """How many contiguous ranges each row's pages are split into: enough
    (row, group, split) CTAs to cover ``n_sm`` SMs :data:`SPLIT_WAVES`
    times, at most one split a page.  ``groups`` is the grid's other axis
    (GQA: the KV heads; MLA: the head groups).  ``n_pages`` is the page
    table's width (the most full pages a row can have): reading the rows'
    lengths back from the card would stall every launch."""
    if b * groups <= 0 or n_pages <= 0:
        return 1
    return max(1, min(n_pages, -(-SPLIT_WAVES * n_sm // (b * groups))))


def split_ranges(n_split: int, n_pages: int, n_full: int):
    """Split s's pages of a row with ``n_full`` full pages, as the kernel
    computes them: ``[s P / n, min((s + 1) P / n, n_full))`` (integer
    division, ``P = n_pages``), empty where the row ends before it."""
    out = []
    for s in range(n_split):
        lo = s * n_pages // n_split
        hi = min((s + 1) * n_pages // n_split, n_full)
        out.append((lo, max(lo, hi)))
    return out


def gqa_smem_bytes(tile: int, rows: int, hd: int, dv: int, sz: int) -> int:
    """Shared memory of one split CTA (``gqa_smem`` in the CUDA source):
    two stages of a tile's raw streams, two of its container bits (rows
    padded by 4 bytes), then q, p, acc, m, l of its ``rows`` query rows;
    ``sz`` is the container's bytes (2 bf16, 1 fp8)."""
    chunks = tile * (hd + dv) // VEC
    raw = (chunks * 24 + 15) // 16 * 16
    bits = tile * ((hd * sz + 4) // 4 + (dv * sz + 4) // 4) * 4
    return 2 * raw + 2 * bits + 4 * rows * (hd + tile + dv + 2)


def _gqa_tile(tp: int, rows: int, hd: int, dv: int, sz: int) -> int:
    """Token tile of the split kernel: a whole page if it fits the budget,
    else the largest power of two that does; raises above 227 KB."""
    for tile in (tp,) + TILE_TOKENS:
        tile = min(tile, tp)
        if gqa_smem_bytes(tile, rows, hd, dv, sz) <= GQA_SMEM_BUDGET:
            return tile
    if gqa_smem_bytes(1, rows, hd, dv, sz) > SMEM_MAX:
        raise ValueError("paged GQA needs more than 227 KB of shared memory "
                         "at a 1-token tile")
    return 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gqa_geometry(q, k_streams, v_streams, page_table_k, page_table_v,
                  cache_len, chunk: int, tp: int, hkv: int):
    """Checked operands -> (b, nq, h, hd, dv, P, (npg, pe, cap) of K and V)."""
    if q.dim() != 4:
        raise ValueError("q must be (B, nq, H, hd)")
    b, nq, h, hd = q.shape
    build.check_operand(q, "q", torch.bfloat16, (b, nq, h, hd))
    kg = _check_streams(k_streams, "k", chunk)
    vg = _check_streams(v_streams, "v", chunk)
    n_pages = _check_rows(page_table_k, page_table_v, cache_len, b)
    pe_k, pe_v = kg[1], vg[1]
    if hkv < 1 or h % hkv or pe_k % tp or pe_v % tp \
            or pe_k // tp != hkv * hd or (pe_v // tp) % hkv:
        raise ValueError(f"inconsistent GQA page geometry: H={h} hkv={hkv} "
                         f"hd={hd} Tp={tp} page_elems k={pe_k} v={pe_v}")
    return b, nq, h, hd, pe_v // tp // hkv, n_pages, kg, vg


def paged_gqa_attention(q, k_streams, v_streams, page_table_k, page_table_v,
                        cache_len, *, exponents: tuple, fmt: str = "bf16",
                        chunk: int, tokens_per_page: int, hkv: int,
                        causal: bool = True, scale=None):
    """Attention over compressed K/V pages -> un-normalized partials.

    q (B, nq, H, hd) bf16; K/V 5-tuples of page streams, each leaf with its
    own page_chunks and escape cap; page tables (B, P) i32; cache_len (B,)
    i32.  Returns ``acc (B, nq, H, dv)``, ``m``, ``l`` (B, nq, H) f32 over
    the full pages; merge the raw tail with :func:`tail_partials` +
    :func:`merge_partials`, then :func:`finalize`.  On the card each row's
    pages are split :func:`split_count` ways and merged; hd and dv
    must be multiples of 16 there."""
    geo = _gqa_geometry(q, k_streams, v_streams, page_table_k, page_table_v,
                        cache_len, chunk, tokens_per_page, hkv)
    b, hd, n_pages = geo[0], geo[3], geo[5]
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    operands = (q, *k_streams, *v_streams, page_table_k, page_table_v,
                cache_len)
    if AB.on_card(*operands):
        nq, h, dv = geo[1], geo[2], geo[4]
        return _abstract_partials("paged_gqa_attention", b, nq, h, dv, n_pages,
                                  tokens_per_page, k_streams, v_streams,
                                  q.numel() * q.element_size(), hd + dv,
                                  q.device)
    if not build.on_cuda(*operands):
        return paged_gqa_attention_plain(
            q, k_streams, v_streams, page_table_k, page_table_v, cache_len,
            exponents=exponents, fmt=fmt, chunk=chunk,
            tokens_per_page=tokens_per_page, hkv=hkv, causal=causal,
            scale=scale)
    n_split = split_count(_sm_count(q.device.index or 0), b, hkv, n_pages)
    return _launch_gqa(geo, q, k_streams, v_streams, page_table_k,
                       page_table_v, cache_len, exponents, fmt,
                       tokens_per_page, hkv, causal, scale, n_split)


def launch_paged_gqa(q, k_streams, v_streams, page_table_k, page_table_v,
                     cache_len, *, exponents: tuple, fmt: str, chunk: int,
                     tokens_per_page: int, hkv: int, causal: bool,
                     scale: float, n_split: int):
    """The card's GQA kernels with ``n_split`` ranges a row (the wrapper
    picks :func:`split_count`; tests force others).  CUDA operands
    only; adds one to ``paged_gqa_attention.launches``."""
    geo = _gqa_geometry(q, k_streams, v_streams, page_table_k, page_table_v,
                        cache_len, chunk, tokens_per_page, hkv)
    if not build.on_cuda(q, *k_streams, *v_streams, page_table_k,
                         page_table_v, cache_len):
        raise ValueError("launch_paged_gqa takes CUDA operands only")
    return _launch_gqa(geo, q, k_streams, v_streams, page_table_k,
                       page_table_v, cache_len, exponents, fmt,
                       tokens_per_page, hkv, causal, scale, n_split)


def _launch_gqa(geo, q, k_streams, v_streams, page_table_k, page_table_v,
                cache_len, exponents, fmt, tp, hkv, causal, scale, n_split):
    """Launch the split kernel (and the merge kernel when ``n_split > 1``)
    on checked CUDA operands; ``geo`` is :func:`_gqa_geometry`'s."""
    b, nq, h, hd, dv, n_pages, (npg_k, pe_k, cap_k), (npg_v, pe_v, cap_v) = geo
    if hd % VEC or dv % VEC or n_split < 1:
        raise ValueError(f"hd={hd}, dv={dv}, n_split={n_split}: the kernel "
                         f"needs widths that are multiples of {VEC} and "
                         "n_split >= 1")
    for t in (k_streams[0], k_streams[1], v_streams[0], v_streams[1]):
        if t.data_ptr() % 16:
            raise ValueError("page streams must be 16-byte aligned")
    sz = FORMATS[fmt]["bits"] // 8
    tile = _gqa_tile(tp, nq * (h // hkv), hd, dv, sz)
    acc, m, l, parts = _partials(b, nq, h, dv, n_split, q.device)
    lut = decode_lut(exponents)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.sz_paged_gqa(
            build.FMT_ID[fmt], q.data_ptr(), *(t.data_ptr() for t in k_streams),
            *(t.data_ptr() for t in v_streams), page_table_k.data_ptr(),
            page_table_v.data_ptr(), cache_len.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(),
            *parts, b, nq, h, hkv, hd, dv, n_pages, tp, pe_k, cap_k, npg_k, pe_v, cap_v,
            npg_v, int(bool(causal)), float(scale), tile, n_split,
            lut.ctypes.data, build.stream_of(q))
    build.check(lib, err, "paged_gqa_attention")
    paged_gqa_attention.launches += 1
    return acc, m, l


def _partials(b: int, nq: int, h: int, dv: int, n_split: int, device):
    """The partials ``acc (B, nq, H, dv)``, ``m``, ``l`` and, split, the
    data pointers of their per-split scratch (else three None): one
    allocation, since this runs once per layer and decode step, where host
    time counts."""
    rows = b * nq * h
    n_parts = n_split if n_split > 1 else 0
    buf = torch.empty(((1 + n_parts) * rows * (dv + 2),), dtype=torch.float32,
                      device=device)
    acc, m, l, *parts = torch.split(
        buf, [rows * dv, rows, rows] + ([n_parts * rows * dv, n_parts * rows,
                                         n_parts * rows] if n_parts else []))
    ptrs = tuple(t.data_ptr() for t in parts) if parts else (None,) * 3
    return acc.view(b, nq, h, dv), m.view(b, nq, h), l.view(b, nq, h), ptrs


def _split_partials(n_split: int, n_pages: int, pmax: int, n_full, run):
    """Per-split partials stacked on a leading split axis: ``run(first,
    stop, n_full)`` is the page-ordered softmax over pages ``first`` to
    ``stop`` of rows with ``n_full`` full pages, returning ``(acc, m, l)``
    in the output layout; a split with no visible token gives ``m =
    -1e30``, ``l = 0``, ``acc = 0``."""
    out = []
    for s in range(n_split):
        lo = s * n_pages // n_split
        hi = (s + 1) * n_pages // n_split
        acc, m, l = run(lo, min(hi, pmax), torch.clamp(n_full, max=hi))
        dead = m <= NEG_INF
        out.append((torch.where(dead[..., None], 0.0, acc), m,
                    torch.where(dead, 0.0, l)))
    return tuple(torch.stack(x) for x in zip(*out))


def paged_gqa_splits_plain(q, k_streams, v_streams, page_table_k,
                           page_table_v, cache_len, *, exponents: tuple,
                           fmt: str = "bf16", chunk: int,
                           tokens_per_page: int, hkv: int, n_split: int,
                           causal: bool = True, scale=None):
    """The split kernel's partials, plain: split s runs the page-ordered
    online softmax over its range (:func:`split_ranges`) of each row's
    full pages; a split with no visible token gives ``m = -1e30``,
    ``l = 0``, ``acc = 0``.  Returns ``acc (n_split, B, nq, H, dv)``,
    ``m``, ``l`` (n_split, B, nq, H)."""
    tp = tokens_per_page
    b, nq, h, hd = q.shape
    g = h // hkv
    n_pages = page_table_k.shape[1]
    dv = v_streams[0].shape[1] * chunk // tp // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    n_full = torch.clamp(cache_len // tp, max=n_pages)
    pmax = int(n_full.max()) if b else 0
    if pmax:
        kf = _gather_pages(k_streams, page_table_k, pmax, exponents, fmt,
                           chunk).reshape(b, pmax, tp, hkv, hd)
        vf = _gather_pages(v_streams, page_table_v, pmax, exponents, fmt,
                           chunk).reshape(b, pmax, tp, hkv, dv)
    qf = q.float().reshape(b, nq, hkv, g, hd)

    def run(first, stop, n_full_s):
        acc, m, l = _paged_softmax(
            (b, nq, hkv, g), dv, stop, n_full_s, cache_len, tp, causal,
            lambda p: torch.einsum("bqhgd,bthd->bqhgt", qf, kf[:, p]) * scale,
            lambda p, pexp: torch.einsum("bqhgt,bthd->bqhgd", pexp, vf[:, p]),
            first=first)
        return acc.reshape(b, nq, h, dv), m.reshape(b, nq, h), l.reshape(b, nq, h)

    return _split_partials(n_split, n_pages, pmax, n_full, run)


def merge_splits(acc, m, l):
    """The merge kernel's plain version: per-split partials (leading split
    axis) -> the unsplit partials.  ``m`` is the maximum over the splits;
    ``l`` and ``acc`` are rescaled by ``exp(m_s - m)`` and summed in split
    order."""
    mx = m.amax(dim=0)
    acc_out = torch.zeros_like(acc[0])
    l_out = torch.zeros_like(l[0])
    for s in range(m.shape[0]):
        w = torch.exp(m[s] - mx)
        acc_out = acc_out + acc[s] * w[..., None]
        l_out = l_out + l[s] * w
    return acc_out, mx, l_out


# ---------------------------------------------------------------------------
# paged MLA (absorbed form)
# ---------------------------------------------------------------------------

def _mla_pages(q_lat, q_rope, ckv_streams, krope_streams, page_table_ckv,
               page_table_krope, cache_len, exponents, fmt, chunk, tp):
    """Plain-version inputs: (n_full, pmax, ckv f32 (B, pmax, Tp, r), krope
    f32 (B, pmax, Tp, rope), q_lat f32, q_rope f32)."""
    b, _, _, r = q_lat.shape
    rope = q_rope.shape[-1]
    n_full = torch.clamp(cache_len // tp, max=page_table_ckv.shape[1])
    pmax = int(n_full.max()) if b else 0
    cf = rf = None
    if pmax:
        cf = _gather_pages(ckv_streams, page_table_ckv, pmax, exponents, fmt,
                           chunk).reshape(b, pmax, tp, r)
        rf = _gather_pages(krope_streams, page_table_krope, pmax, exponents,
                           fmt, chunk).reshape(b, pmax, tp, rope)
    return n_full, pmax, cf, rf, q_lat.float(), q_rope.float()


def _mla_score(qlf, qrf, cf, rf, scale):
    return lambda p: (torch.einsum("bqhr,btr->bqht", qlf, cf[:, p])
                      + torch.einsum("bqhp,btp->bqht", qrf, rf[:, p])) * scale


def _mla_context(cf):
    return lambda p, pexp: torch.einsum("bqht,btr->bqhr", pexp, cf[:, p])


def paged_mla_attention_plain(q_lat, q_rope, ckv_streams, krope_streams,
                              page_table_ckv, page_table_krope, cache_len, *,
                              exponents: tuple, fmt: str = "bf16", chunk: int,
                              tokens_per_page: int, scale: float,
                              causal: bool = True):
    """The TPU kernel's page-ordered f32 online softmax, absorbed MLA: score
    ``q_lat . ckv + q_rope . krope``, context over ``ckv``."""
    b, nq, h, r = q_lat.shape
    n_full, pmax, cf, rf, qlf, qrf = _mla_pages(
        q_lat, q_rope, ckv_streams, krope_streams, page_table_ckv,
        page_table_krope, cache_len, exponents, fmt, chunk, tokens_per_page)
    return _paged_softmax((b, nq, h), r, pmax, n_full, cache_len,
                          tokens_per_page, causal,
                          _mla_score(qlf, qrf, cf, rf, scale), _mla_context(cf))


def paged_mla_splits_plain(q_lat, q_rope, ckv_streams, krope_streams,
                           page_table_ckv, page_table_krope, cache_len, *,
                           exponents: tuple, fmt: str = "bf16", chunk: int,
                           tokens_per_page: int, scale: float, n_split: int,
                           causal: bool = True):
    """The MLA split kernel's partials, plain, as
    :func:`paged_gqa_splits_plain`: ``acc (n_split, B, nq, H, kv_rank)``,
    ``m``, ``l`` (n_split, B, nq, H)."""
    b, nq, h, r = q_lat.shape
    n_full, pmax, cf, rf, qlf, qrf = _mla_pages(
        q_lat, q_rope, ckv_streams, krope_streams, page_table_ckv,
        page_table_krope, cache_len, exponents, fmt, chunk, tokens_per_page)
    score, context = _mla_score(qlf, qrf, cf, rf, scale), _mla_context(cf)
    return _split_partials(
        n_split, page_table_ckv.shape[1], pmax, n_full,
        lambda first, stop, n_full_s: _paged_softmax(
            (b, nq, h), r, stop, n_full_s, cache_len, tokens_per_page, causal,
            score, context, first=first))


def mla_head_group(h: int, nq: int) -> int:
    """Query heads one MLA CTA takes: the largest divisor of H with
    ``nq * heads <= MLA_MAX_ROWS``, so at decode (nq 1) one CTA holds all
    of a row's heads (up to 64) and decodes each page once for them."""
    fits = [d for d in range(1, h + 1) if h % d == 0 and nq * d <= MLA_MAX_ROWS]
    if not fits:
        raise ValueError(f"paged MLA on the card takes at most {MLA_MAX_ROWS} "
                         f"queries a row (nq={nq})")
    return max(fits)


def mla_grid(b: int, nq: int, h: int, n_pages: int, n_sm: int):
    """The MLA split kernel's grid ``(B, head groups, n_split)`` on a card
    of ``n_sm`` SMs, as the wrapper launches it."""
    groups = h // mla_head_group(h, nq)
    return b, groups, split_count(n_sm, b, groups, n_pages)


def mla_smem_bytes(tile: int, rows: int, r: int, rope: int) -> int:
    """Shared memory of one MLA split CTA (``mla_smem`` in the CUDA source):
    Q and two tile stages in bf16, rows of ``r + rope + 8`` elements (Q's
    rows and a tile's tokens padded to 16), then two raw stages of a tile's
    streams."""
    ld = r + rope + 8
    chunks = tile * (r + rope) // VEC
    return (-(-rows // 16) * 16 * ld * 2 + 2 * (-(-tile // 16) * 16 * ld * 2)
            + 2 * ((chunks * 24 + 15) // 16 * 16))


def _mla_tile(tp: int, rows: int, r: int, rope: int) -> int:
    """Token tile of the MLA kernel: a page up to 64 tokens, smaller where
    shared memory does not fit; raises above 227 KB at a 16-token tile."""
    for tile in (MLA_TILE, 32, 16):
        tile = min(tile, tp)
        if mla_smem_bytes(tile, rows, r, rope) <= SMEM_MAX:
            return tile
    raise ValueError("paged MLA needs more than 227 KB of shared memory at a "
                     "16-token tile")


def _mla_geometry(q_lat, q_rope, ckv_streams, krope_streams, page_table_ckv,
                  page_table_krope, cache_len, chunk: int, tp: int):
    """Checked operands -> (b, nq, h, r, rope, P, (npg, pe, cap) of ckv and
    krope)."""
    if q_lat.dim() != 4 or q_rope.dim() != 4:
        raise ValueError("q_lat and q_rope must be (B, nq, H, ·)")
    b, nq, h, r = q_lat.shape
    rope = q_rope.shape[-1]
    build.check_operand(q_lat, "q_lat", torch.bfloat16, (b, nq, h, r))
    build.check_operand(q_rope, "q_rope", torch.bfloat16, (b, nq, h, rope))
    cg = _check_streams(ckv_streams, "ckv", chunk)
    rg = _check_streams(krope_streams, "krope", chunk)
    n_pages = _check_rows(page_table_ckv, page_table_krope, cache_len, b)
    if cg[1] != tp * r or rg[1] != tp * rope:
        raise ValueError(f"inconsistent MLA page geometry: Tp={tp} r={r} "
                         f"rope={rope} page_elems ckv={cg[1]} krope={rg[1]}")
    return b, nq, h, r, rope, n_pages, cg, rg


def paged_mla_attention(q_lat, q_rope, ckv_streams, krope_streams,
                        page_table_ckv, page_table_krope, cache_len, *,
                        exponents: tuple, fmt: str = "bf16", chunk: int,
                        tokens_per_page: int, scale: float,
                        causal: bool = True):
    """Absorbed-form MLA attention over compressed latent pages.

    q_lat (B, nq, H, kv_rank) and q_rope (B, nq, H, rope) bf16; ckv and
    krope 5-tuples with their own page_chunks and caps.  Returns ``acc (B,
    nq, H, kv_rank)`` (latent space), ``m``, ``l`` (B, nq, H) f32; the
    caller applies the ``w_v``/``wo`` up-projections after the tail merge.
    On the card the grid is :func:`mla_grid`'s; kv_rank must be a multiple
    of 32 up to 256, rope a multiple of 16, nq at most 64, and q and the
    page streams 16-byte aligned there."""
    geo = _mla_geometry(q_lat, q_rope, ckv_streams, krope_streams,
                        page_table_ckv, page_table_krope, cache_len, chunk,
                        tokens_per_page)
    operands = (q_lat, q_rope, *ckv_streams, *krope_streams, page_table_ckv,
                page_table_krope, cache_len)
    if AB.on_card(*operands):
        b, nq, h, r, rope, n_pages = geo[:6]
        return _abstract_partials(
            "paged_mla_attention", b, nq, h, r, n_pages, tokens_per_page,
            ckv_streams, krope_streams,
            (q_lat.numel() + q_rope.numel()) * q_lat.element_size(),
            2 * r + rope, q_lat.device)
    if not build.on_cuda(*operands):
        return paged_mla_attention_plain(
            q_lat, q_rope, ckv_streams, krope_streams, page_table_ckv,
            page_table_krope, cache_len, exponents=exponents, fmt=fmt,
            chunk=chunk, tokens_per_page=tokens_per_page, scale=scale,
            causal=causal)
    b, nq, h, n_pages = geo[0], geo[1], geo[2], geo[5]
    n_split = mla_grid(b, nq, h, n_pages, _sm_count(q_lat.device.index or 0))[2]
    return _launch_mla(geo, q_lat, q_rope, ckv_streams, krope_streams,
                       page_table_ckv, page_table_krope, cache_len, exponents,
                       fmt, tokens_per_page, causal, scale, n_split)


def launch_paged_mla(q_lat, q_rope, ckv_streams, krope_streams,
                     page_table_ckv, page_table_krope, cache_len, *,
                     exponents: tuple, fmt: str, chunk: int,
                     tokens_per_page: int, scale: float, causal: bool,
                     n_split: int):
    """The card's MLA kernels with ``n_split`` ranges a row (the wrapper
    picks :func:`mla_grid`'s; tests force others).  CUDA operands only;
    adds one to ``paged_mla_attention.launches``."""
    geo = _mla_geometry(q_lat, q_rope, ckv_streams, krope_streams,
                        page_table_ckv, page_table_krope, cache_len, chunk,
                        tokens_per_page)
    if not build.on_cuda(q_lat, q_rope, *ckv_streams, *krope_streams,
                         page_table_ckv, page_table_krope, cache_len):
        raise ValueError("launch_paged_mla takes CUDA operands only")
    return _launch_mla(geo, q_lat, q_rope, ckv_streams, krope_streams,
                       page_table_ckv, page_table_krope, cache_len, exponents,
                       fmt, tokens_per_page, causal, scale, n_split)


def _launch_mla(geo, q_lat, q_rope, ckv_streams, krope_streams, page_table_ckv,
                page_table_krope, cache_len, exponents, fmt, tp, causal, scale,
                n_split):
    """Launch the MLA split kernel (and the merge kernel when ``n_split >
    1``) on checked CUDA operands; ``geo`` is :func:`_mla_geometry`'s."""
    b, nq, h, r, rope, n_pages, (npg_c, pe_c, cap_c), (npg_r, pe_r, cap_r) = geo
    if r % 32 or r > MLA_MAX_RANK or rope % VEC or not rope or n_split < 1:
        raise ValueError(f"kv_rank={r}, rope={rope}, n_split={n_split}: the "
                         f"kernel needs kv_rank a multiple of 32 up to "
                         f"{MLA_MAX_RANK}, rope a multiple of {VEC}, "
                         "n_split >= 1")
    for t in (q_lat, q_rope, ckv_streams[0], ckv_streams[1], krope_streams[0],
              krope_streams[1]):
        if t.data_ptr() % 16:
            raise ValueError("q_lat, q_rope and the page streams must be "
                             "16-byte aligned")
    hpc = mla_head_group(h, nq)
    tile = _mla_tile(tp, nq * hpc, r, rope)
    acc, m, l, parts = _partials(b, nq, h, r, n_split, q_lat.device)
    lut = decode_lut(exponents)
    lib = _lib()
    with torch.cuda.device(q_lat.device):
        err = lib.sz_paged_mla(
            build.FMT_ID[fmt], q_lat.data_ptr(), q_rope.data_ptr(),
            *(t.data_ptr() for t in ckv_streams),
            *(t.data_ptr() for t in krope_streams), page_table_ckv.data_ptr(),
            page_table_krope.data_ptr(), cache_len.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), *parts, b, nq, h, hpc, r, rope,
            n_pages, tp, pe_c, cap_c, npg_c, pe_r, cap_r, npg_r,
            int(bool(causal)), float(scale), tile, n_split, lut.ctypes.data,
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
