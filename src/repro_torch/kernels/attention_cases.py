"""Seeded inputs for holding the attention kernels against their plain
versions: the paged-attention kernels and, at the end, prefill flash
attention (``FLASH_EDGE``, with its tolerances).

Page streams are made directly (numpy from a seed), not by encoding: every
byte of ``sign_mantissa`` and ``packed`` is drawn, and the escape list of
each page is chosen to hit the decoder's edges — ``count == 0``, ``count ==
cap``, ``count > cap`` (slots beyond ``cap`` are ignored), padding slots
inside the count (``pos == page_elems`` never matches), a repeated position
(slot order decides), and escaped exponents that make NaN, ±Inf, ±0 and
subnormal payloads.  Attention inputs keep their values finite and of
moderate size (exponent codes near the format's bias, escapes a few
exponents off the band) so the f32 comparison measures reduction order, not
overflow.  The CPU tests and ``chip_smoke.py`` draw the same inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import codec as C
from repro_torch.core.codebook import FORMATS, Codebook
from repro_torch.kernels.cases import CODEBOOKS

#: per format: the bias (exponent of 1.0)
BIAS = {"bf16": 127, "fp8_e5m2": 15, "fp8_e4m3": 7}


def _u16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint16).view(np.int16)).view(torch.uint16)


def page_streams(cb: Codebook, n_pages: int, page_elems: int, cap: int,
                 chunk: int, rng: np.random.Generator, *,
                 finite: bool = False, counts=None):
    """One leaf's five page streams (CPU tensors) for ``n_pages`` pages.

    ``finite``: codes and escapes keep values finite and within a few
    exponents of 1.0 (attention inputs); otherwise every byte is random and
    escapes carry any exponent (NaN/Inf/zero/subnormal payloads included).
    ``counts``: per-page escape counts (default: a cycle over 0, a few,
    ``cap`` and ``cap + 3``)."""
    s = FORMATS[cb.fmt]
    ebits = s["ebits"]
    pc = page_elems // chunk
    sm = rng.integers(0, 256, (n_pages, pc, chunk), dtype=np.int64)
    if finite:
        bias = BIAS[cb.fmt]
        near = [i for i, e in enumerate(cb.exponents) if bias - 4 <= e <= bias + 1]
        codes = rng.choice(np.asarray(near), size=(n_pages, page_elems))
        packed = codes[:, 0::2] | (codes[:, 1::2] << 4)
    else:
        packed = rng.integers(0, 256, (n_pages, page_elems // 2), dtype=np.int64)
    if counts is None:
        cycle = [0, 3, cap, cap + 3, 1]
        counts = [cycle[i % len(cycle)] for i in range(n_pages)]
    pos = np.full((n_pages, cap), page_elems, dtype=np.int64)
    val = np.zeros((n_pages, cap), dtype=np.int64)
    for i, n in enumerate(counts):
        k = min(n, cap)
        if k == 0:
            continue
        pos[i, :k] = np.sort(rng.choice(page_elems, size=k, replace=False))
        if finite:
            bias = BIAS[cb.fmt]
            val[i, :k] = rng.integers(bias - 6, bias + 3, k)
        else:
            val[i, :k] = rng.integers(0, 1 << ebits, k)
            if k >= 3 and i % 2:
                pos[i, 1] = page_elems            # padding inside the count
                pos[i, k - 1] = pos[i, 0]         # a repeated position
    cnt = np.asarray(counts, dtype=np.int32).reshape(n_pages, 1)
    return (torch.from_numpy(sm.astype(np.uint8)),
            torch.from_numpy(packed.astype(np.uint8)).reshape(n_pages, pc, chunk // 2),
            _u16(pos), torch.from_numpy(val.astype(np.uint8)),
            torch.from_numpy(cnt))


def decode_cases(seed: int = 0, chunk: int = 1024
                 ) -> List[Tuple[str, str, tuple, tuple]]:
    """``[(name, fmt, exponents, streams), ...]``: every format, caps 8 and
    64, page sizes of one and several chunks."""
    rng = np.random.default_rng(seed)
    out = []
    for fmt, cb in CODEBOOKS.items():
        for pc, cap in ((1, 8), (4, 64)):
            pe = pc * chunk
            out.append((f"{fmt}_pe{pe}_cap{cap}", fmt, tuple(cb.exponents),
                        page_streams(cb, 10, pe, cap, chunk, rng)))
    return out


def _tables(rng, b: int, p: int, n_full: np.ndarray, n_pages: int):
    """(B, P) page tables: distinct random ids for each row's full pages,
    -1 beyond."""
    ids = rng.permutation(n_pages)[: b * p].reshape(b, p).astype(np.int32)
    ids[np.arange(p)[None, :] >= n_full[:, None]] = -1
    return torch.from_numpy(ids)


def gqa_case(fmt: str, seed: int, *, batch: int, nq: int, heads: int, hkv: int,
             hd: int, dv: int, tp: int, pages: int, lens, chunk: int = 1024
             ) -> Dict:
    """Keyword arguments of ``paged_gqa_attention`` (CPU tensors): pools of
    ``batch * pages`` pages per leaf, K and V with their own page_chunks and
    escape caps, causal, rows of the given lengths."""
    rng = np.random.default_rng(seed)
    cb = CODEBOOKS[fmt]
    lens = np.asarray(lens, dtype=np.int32)
    n_pages = batch * pages
    pe_k, pe_v = tp * hkv * hd, tp * hkv * dv
    ks = page_streams(cb, n_pages, pe_k, max(8, pe_k // 256), chunk, rng,
                      finite=True)
    vs = page_streams(cb, n_pages, pe_v, max(8, pe_v // 256), chunk, rng,
                      finite=True)
    n_full = np.minimum(lens // tp, pages)
    q = torch.from_numpy(rng.standard_normal((batch, nq, heads, hd)).astype(
        np.float32) * 0.25).to(torch.bfloat16)
    return dict(q=q, k_streams=ks, v_streams=vs,
                page_table_k=_tables(rng, batch, pages, n_full, n_pages),
                page_table_v=_tables(rng, batch, pages, n_full, n_pages),
                cache_len=torch.from_numpy(lens), exponents=tuple(cb.exponents),
                fmt=fmt, chunk=chunk, tokens_per_page=tp, hkv=hkv, causal=True,
                scale=1.0 / np.sqrt(hd))


#: the served resident geometries of the GQA kernel: smollm-135m at batch
#: 8 after a 2048-token prompt (80-token pages, 25 full of 27), and
#: qwen3-moe-30b-a3b at batch 4 after 2088 tokens (32-token pages, 65 full
#: of 66: the resident run's cache mid-way through its 40 new tokens), and
#: pixtral-12b at batch 4 after its 2048 positions and 16 new tokens
#: (16-token pages, 129 full of 130)
GQA_SERVED = {
    "smollm-135m": dict(batch=8, nq=1, heads=9, hkv=3, hd=64, dv=64, tp=80,
                        pages=27, lens=[2048] * 8),
    "qwen3-moe-30b-a3b": dict(batch=4, nq=1, heads=32, hkv=4, hd=128, dv=128,
                              tp=32, pages=66, lens=[2088] * 4),
    "pixtral-12b": dict(batch=4, nq=1, heads=32, hkv=8, hd=128, dv=128, tp=16,
                        pages=130, lens=[2064] * 4),
}

#: the GQA split kernel's edges, ``{name: (gqa_case keywords, n_split)}``:
#: more splits than a row's pages (empty ranges), ragged rows that end
#: below a split's start, a row with no full page, and nq 4 causal with
#: 2-token pages and one page a split, so the last split of the first
#: query row sees only keys above its diagonal (a wholly masked split)
GQA_SPLIT_EDGE = {
    "more_splits_than_pages": (dict(batch=2, nq=1, heads=4, hkv=2, hd=32,
                                    dv=64, tp=16, pages=3, lens=[48, 20]), 5),
    "ragged_rows_below_split_start": (dict(
        batch=4, nq=1, heads=8, hkv=2, hd=64, dv=64, tp=16, pages=6,
        lens=[96, 70, 20, 33]), 4),
    "empty_row": (dict(batch=3, nq=1, heads=4, hkv=2, hd=32, dv=128, tp=16,
                       pages=4, lens=[64, 9, 40]), 3),
    "nq4_causal_masked_split": (dict(batch=2, nq=4, heads=4, hkv=2, hd=64,
                                     dv=64, tp=2, pages=20, lens=[40, 33],
                                     chunk=256), 20),
}


def mla_case(fmt: str, seed: int, *, batch: int, nq: int, heads: int,
             rank: int, rope: int, tp: int, pages: int, lens,
             chunk: int = 1024) -> Dict:
    """Keyword arguments of ``paged_mla_attention`` (CPU tensors); ckv and
    krope pools with their own page_chunks and escape caps."""
    rng = np.random.default_rng(seed)
    cb = CODEBOOKS[fmt]
    lens = np.asarray(lens, dtype=np.int32)
    n_pages = batch * pages
    pe_c, pe_r = tp * rank, tp * rope
    cs = page_streams(cb, n_pages, pe_c, max(8, pe_c // 256), chunk, rng,
                      finite=True)
    rs = page_streams(cb, n_pages, pe_r, max(8, pe_r // 256), chunk, rng,
                      finite=True)
    n_full = np.minimum(lens // tp, pages)

    def q(d):
        return torch.from_numpy(rng.standard_normal((batch, nq, heads, d)).astype(
            np.float32) * 0.25).to(torch.bfloat16)

    return dict(q_lat=q(rank), q_rope=q(rope), ckv_streams=cs, krope_streams=rs,
                page_table_ckv=_tables(rng, batch, pages, n_full, n_pages),
                page_table_krope=_tables(rng, batch, pages, n_full, n_pages),
                cache_len=torch.from_numpy(lens), exponents=tuple(cb.exponents),
                fmt=fmt, chunk=chunk, tokens_per_page=tp,
                scale=1.0 / np.sqrt(rank + rope), causal=True)


#: the served resident geometry of the MLA kernel: minicpm3-4b at batch 4
#: after a 1000-token prompt (64-token pages, 15 full of the page table's
#: 17)
MLA_SERVED = {
    "minicpm3-4b": dict(batch=4, nq=1, heads=40, rank=256, rope=32, tp=64,
                        pages=17, lens=[1000] * 4),
}

#: the MLA split kernel's edges, ``{name: (mla_case keywords, n_split)}``:
#: more splits than a row's pages (empty ranges), a row with no full page,
#: nq 4 causal with 2-token pages and one page a split (the last split of
#: the first query row sees only keys above its diagonal), nq 4 x H 40
#: (four CTAs a row of 10 heads each, 40 rows), rope 64, ckv and krope
#: escape caps of 32 and 8 at kv_rank 256, and 72-token pages (a 64-token
#: tile, then 8 tokens padded to 16)
MLA_SPLIT_EDGE = {
    "more_splits_than_pages": (dict(batch=2, nq=1, heads=8, rank=128, rope=32,
                                    tp=32, pages=3, lens=[96, 40]), 5),
    "empty_row": (dict(batch=3, nq=1, heads=8, rank=128, rope=32, tp=32,
                       pages=4, lens=[128, 9, 70]), 3),
    "nq4_causal_masked_split": (dict(batch=2, nq=4, heads=4, rank=128,
                                     rope=32, tp=2, pages=20, lens=[40, 33],
                                     chunk=64), 20),
    "nq4_h40_four_groups": (dict(batch=2, nq=4, heads=40, rank=128, rope=32,
                                 tp=32, pages=3, lens=[96, 70]), 2),
    "rope64": (dict(batch=2, nq=2, heads=8, rank=128, rope=64, tp=16,
                    pages=4, lens=[64, 47]), 2),
    "distinct_caps_rank256": (dict(batch=2, nq=1, heads=16, rank=256, rope=32,
                                   tp=32, pages=5, lens=[160, 100]), 3),
    "two_tiles_a_page": (dict(batch=2, nq=1, heads=8, rank=128, rope=32,
                              tp=72, pages=3, lens=[216, 150], chunk=256), 2),
}


def to_device(case: Dict, device) -> Dict:
    """The same case with every tensor (and tensor tuple) on ``device``."""
    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            return tuple(t.to(device) for t in v)
        return v
    return {k: move(v) for k, v in case.items()}


#: kernel vs plain tolerance on the partials (acc, m, l): the kernel sums in
#: another order (token sub-tiles of up to 64 with fused multiply-adds or
#: tensor-core products, the softmax rescaled per sub-tile) than the plain
#: version (one einsum per page), and the MLA kernel carries p into P.V as
#: two bf16 terms (about 16 bits); at the scores these cases make (|s| of
#: order 1 to 10) that stays near 1e-6 relative, so 1e-4 leaves margin
#: without hiding a wrong page, mask or scale (those move values by O(1)).
PARTIALS_RTOL = 1e-4


def check_partials(got, want, rtol: float = PARTIALS_RTOL) -> float:
    """Hold kernel partials (acc, m, l) against the plain version's:
    ``|got - want| <= rtol * (|want| + max |want|)`` elementwise, the
    ``-1e30`` of an empty row exactly.  Returns the largest absolute
    difference; raises ``AssertionError`` past the tolerance."""
    worst = 0.0
    for name, g, w in zip(("acc", "m", "l"), got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
        if not g.numel():
            continue
        g, w = g.double().cpu(), w.double().cpu()
        sentinel = w <= -1e29
        if not torch.equal(g[sentinel], w[sentinel]):
            raise AssertionError(f"{name}: empty-row sentinel differs")
        g, w = g[~sentinel], w[~sentinel]
        if not g.numel():
            continue
        d = (g - w).abs()
        bound = rtol * (w.abs() + w.abs().max())
        if not bool(torch.isfinite(g).all()) or bool((d > bound).any()):
            raise AssertionError(f"{name}: max |diff| {float(d.max())} exceeds "
                                 f"rtol {rtol}")
        worst = max(worst, float(d.max()))
    return worst


# ---------------------------------------------------------------------------
# prefill flash attention
# ---------------------------------------------------------------------------

#: (name, B, Sq, Skv, H, Hkv, d, dv, causal, dtype, score scale[, v
#: offset]): causal and not, GQA groups 1, 3 and 8, dv != d (MLA), d 64 and
#: 128, lengths that are not multiples of the kernel's 64-row tiles, B = 1,
#: a single query, a KV length past the queries, scores scaled x30, bf16
#: and f32; for the tensor-core kernel, five key tiles (its two-stage ring
#: wraps) and an MLA ``v`` that is a head slice of a wider tensor (the
#: optional 12th field: ``v`` is ``wide[..., offset:]``, here 128 bytes in,
#: as ``mla_prefill`` passes it); then sliding windows (the optional 13th
#: field): a window of 1, one that is not a multiple of the 64-key tile,
#: one of at least Skv (the causal result), one shorter than a tile, one
#: without the causal mask, and recurrentgemma's d 256 with one KV head,
#: on both kernels; last hubert's width, d = dv = 80 (a 64-wide head box
#: and a mostly empty second one, five 16-deep score steps), without the
#: causal mask at ragged lengths and with more keys than queries, and
#: pixtral's GQA group of 4 at d 128, causal
FLASH_EDGE = (
    ("mha_causal_f32", 2, 128, 128, 4, 4, 64, 64, True, "f32", 1.0),
    ("mha_full_bf16", 2, 96, 96, 4, 4, 64, 64, False, "bf16", 1.0),
    ("gqa3_ragged_bf16", 1, 100, 100, 6, 2, 64, 64, True, "bf16", 1.0),
    ("gqa3_ragged_f32", 1, 65, 65, 6, 2, 64, 64, True, "f32", 1.0),
    ("gqa8_d128_bf16", 1, 130, 130, 8, 1, 128, 128, True, "bf16", 1.0),
    ("gqa8_d128_f32", 2, 127, 127, 16, 2, 128, 128, True, "f32", 1.0),
    ("mla_96_64_bf16", 2, 77, 77, 4, 4, 96, 64, True, "bf16", 1.0),
    ("mla_96_64_f32", 1, 129, 129, 4, 4, 96, 64, True, "f32", 1.0),
    ("cross_kv_longer_f32", 1, 37, 150, 4, 2, 64, 64, False, "f32", 1.0),
    ("single_query_bf16", 1, 1, 200, 4, 2, 128, 128, False, "bf16", 1.0),
    ("causal_kv_longer_bf16", 1, 50, 70, 4, 2, 64, 64, True, "bf16", 1.0),
    ("scores_x30_f32", 1, 64, 64, 2, 2, 32, 32, True, "f32", 30.0),
    ("ring_wrap_d128_bf16", 1, 320, 320, 8, 2, 128, 128, True, "bf16", 1.0),
    ("mla_v_slice_bf16", 2, 150, 150, 4, 4, 96, 64, True, "bf16", 1.0, 64),
    ("win1_bf16", 1, 130, 130, 4, 2, 64, 64, True, "bf16", 1.0, 0, 1),
    ("win1_f32", 1, 70, 70, 2, 1, 32, 32, True, "f32", 1.0, 0, 1),
    ("win100_ragged_bf16", 2, 300, 300, 4, 1, 128, 128, True, "bf16", 1.0, 0, 100),
    ("win100_ragged_f32", 1, 260, 260, 4, 2, 64, 64, True, "f32", 1.0, 0, 100),
    ("win_ge_skv_bf16", 1, 150, 150, 4, 2, 64, 64, True, "bf16", 1.0, 0, 150),
    ("win16_bf16", 1, 200, 200, 4, 4, 64, 64, True, "bf16", 1.0, 0, 16),
    ("win16_f32", 1, 200, 200, 4, 4, 64, 64, True, "f32", 1.0, 0, 16),
    ("win70_full_bf16", 1, 200, 200, 4, 2, 64, 64, False, "bf16", 1.0, 0, 70),
    ("win70_full_f32", 1, 150, 180, 4, 2, 64, 64, False, "f32", 1.0, 0, 70),
    ("win128_d256_mqa_bf16", 1, 330, 330, 16, 1, 256, 256, True, "bf16", 1.0, 0, 128),
    ("mha_d80_full_bf16", 1, 150, 150, 4, 4, 80, 80, False, "bf16", 1.0),
    ("mha_d80_cross_bf16", 2, 37, 150, 4, 4, 80, 80, False, "bf16", 1.0),
    ("gqa4_d128_bf16", 1, 200, 200, 8, 2, 128, 128, True, "bf16", 1.0),
)

#: kernel vs plain tolerances (atol = rtol), by case kind.  f32: the JAX
#: test's own 2e-5, f32 sums in another order; x30: 2e-3, the JAX test's
#: own for |logits| near 900, where the order of the f32 sums moves the
#: softmax by about 5e-4; bf16: the f32 values agree to about 1e-6 and are
#: each rounded once to bf16, so the outputs differ by at most one bf16 ulp
#: (2**-7 relative at most: rtol 8e-3), with atol 1e-3 for outputs near 0.
FLASH_TOL = {"f32": (2e-5, 2e-5), "x30": (2e-3, 2e-3), "bf16": (1e-3, 8e-3)}
#: the kernel (f32 p) against ``chunked_attention`` (bf16 p): the JAX
#: package's own bound between its flash kernel and its XLA attention
FLASH_VS_CHUNKED = 3e-2

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def flash_case(name: str, b: int, sq: int, skv: int, h: int, hkv: int, d: int,
               dv: int, causal: bool, dtype: str, amp: float,
               v_offset: int = 0, window: Optional[int] = None,
               seed: int = 0) -> Dict:
    """Seeded (numpy) ``q``, ``k``, ``v`` (CPU tensors) and the call's
    keywords (``causal``, ``window``); ``tol`` is ``(atol, rtol)`` for the
    kernel against the plain version.  ``v_offset > 0`` makes ``v`` the last
    ``dv`` of ``v_offset + dv`` head columns (a strided view)."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        x = rng.standard_normal(shape).astype(np.float32) * amp
        return torch.from_numpy(x).to(_DTYPES[dtype])

    kind = "x30" if amp != 1.0 else dtype
    q, k = draw(b, sq, h, d), draw(b, skv, hkv, d)
    wide = draw(b, skv, hkv, v_offset + dv)
    return dict(name=name, q=q, k=k, v=wide[..., v_offset:], v_wide=wide,
                v_offset=v_offset, causal=causal, window=window,
                tol=FLASH_TOL[kind])


def flash_operands(case: Dict, device) -> Tuple[torch.Tensor, ...]:
    """A flash case's ``q``, ``k``, ``v`` on ``device``, ``v`` still a view
    of its wider tensor where the case has one (``Tensor.to`` would make
    the slice contiguous)."""
    v = case["v_wide"].to(device)[..., case["v_offset"]:]
    return case["q"].to(device), case["k"].to(device), v


def flash_cases(seed: int = 0) -> List[Dict]:
    """Every case of :data:`FLASH_EDGE`, seeded ``seed + i``."""
    return [flash_case(*row, seed=seed + i) for i, row in enumerate(FLASH_EDGE)]


def check_close(got: torch.Tensor, want: torch.Tensor, atol: float,
                rtol: float) -> float:
    """``|got - want| <= atol + rtol |want|`` elementwise, both finite, the
    same shape and dtype.  Returns the largest absolute difference; raises
    ``AssertionError`` past the tolerance."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.double().cpu(), want.double().cpu()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite output")
    d = (g - w).abs()
    if bool((d > atol + rtol * w.abs()).any()):
        raise AssertionError(f"max |diff| {float(d.max())} exceeds atol {atol}, "
                             f"rtol {rtol}")
    return float(d.max()) if d.numel() else 0.0
