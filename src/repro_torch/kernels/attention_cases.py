"""Seeded inputs for holding the paged-attention kernels against their plain
versions.

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

from typing import Dict, List, Tuple

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
#: another order (token sub-tiles of up to 64 with fused multiply-adds, the
#: softmax rescaled per sub-tile) than the plain version (one einsum per
#: page); at the scores these cases make (|s| of order 1 to 10) f32 rounding
#: stays near 1e-6 relative, so 1e-4 leaves margin without hiding a wrong
#: page, mask or scale (those move values by O(1)).
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
