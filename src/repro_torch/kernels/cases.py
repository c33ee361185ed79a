"""Edge-case inputs for holding the codec kernels against their plain versions.

Each case is container bits (u16 for bf16, u8 for fp8) plus an escape
capacity, chosen where a kernel is most likely to differ from its plain
version: special values (NaN payloads, infinities, signed zeros,
subnormals), rows without escapes, rows that are all escapes, escape counts
at ``cap`` and ``cap + 1``, capacities 1/64/128, and a ragged tail that
``_pad_to_chunk`` pads.  Made with numpy from a seed, so the CPU tests and
the on-card check draw the same inputs.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import codec as C
from repro_torch.core.codebook import FORMATS, Codebook
from repro_torch.kernels import splitzip_decode as D
from repro_torch.kernels import splitzip_encode as E

#: codebooks the cases are encoded under: a 16-exponent band per format
CODEBOOKS = {
    "bf16": Codebook(fmt="bf16", exponents=tuple(range(118, 134))),
    "fp8_e5m2": Codebook(fmt="fp8_e5m2", exponents=tuple(range(8, 24))),
    # e4m3 has only 16 exponents: a 14-entry book leaves 0 and 15 escaping
    "fp8_e4m3": Codebook(fmt="fp8_e4m3", exponents=tuple(range(1, 15))),
}

SPECIALS = {
    # NaN payloads, +-Inf, +-0, subnormals, +-max, all-ones
    "bf16": [0x7FC0, 0x7FC1, 0xFFC0, 0x7F81, 0x7F80, 0xFF80, 0x0000, 0x8000,
             0x0001, 0x8001, 0x007F, 0x7F7F, 0xFF7F, 0x0080, 0xFFFF, 0x7FFF],
    "fp8_e5m2": [0x7F, 0x7D, 0xFE, 0x7C, 0xFC, 0x00, 0x80, 0x01, 0x81, 0x7B,
                 0xFB, 0x04, 0xFF],
    "fp8_e4m3": [0x7F, 0xFF, 0x00, 0x80, 0x01, 0x81, 0x07, 0x7E, 0xFE, 0x08],
}

CAPS = (1, 64, 128)


def _escape_exponent(cb: Codebook) -> int:
    return next(e for e in range(1 << cb.ebits) if e not in cb.exponents)


def _compose(e: np.ndarray, mant: np.ndarray, sign: np.ndarray,
             fmt: str) -> np.ndarray:
    s = FORMATS[fmt]
    bits = (sign.astype(np.uint32) << (s["bits"] - 1)) \
        | (e.astype(np.uint32) << s["mbits"]) | mant.astype(np.uint32)
    return bits.astype(s["npdtype"])


def _row_with_escapes(cb: Codebook, n_esc: int, chunk: int,
                      rng: np.random.Generator) -> np.ndarray:
    """One chunk whose exponents are in the codebook except at ``n_esc``
    scattered positions."""
    fmt = cb.fmt
    mbits = FORMATS[fmt]["mbits"]
    e = rng.choice(np.asarray(cb.exponents), size=chunk)
    pos = rng.choice(chunk, size=n_esc, replace=False)
    e[pos] = _escape_exponent(cb)
    mant = rng.integers(0, 1 << mbits, chunk)
    sign = rng.integers(0, 2, chunk)
    return _compose(e, mant, sign, fmt)


def kernel_cases(fmt: str, seed: int = 0, chunk: int = 1024
                 ) -> List[Tuple[str, np.ndarray, int]]:
    """``[(name, flat container bits, cap), ...]`` for one format."""
    rng = np.random.default_rng(seed)
    cb = CODEBOOKS[fmt]
    s = FORMATS[fmt]
    nbits, mbits = s["bits"], s["mbits"]
    out: List[Tuple[str, np.ndarray, int]] = []

    # mostly-covered random rows with every special value, ragged tail
    n = 8 * chunk + 37
    e = rng.choice(np.asarray(cb.exponents), size=n)
    bits = _compose(e, rng.integers(0, 1 << mbits, n), rng.integers(0, 2, n), fmt)
    sp = np.asarray(SPECIALS[fmt], dtype=s["npdtype"])
    bits[rng.choice(n, size=4 * sp.size, replace=False)] = np.tile(sp, 4)
    out.append(("specials_ragged", bits, 64))
    # fully random bits (any exponent): heavy escapes, overflowing rows
    out.append(("random_bits", rng.integers(0, 1 << nbits, 4 * chunk,
                                            dtype=np.int64).astype(s["npdtype"]), 64))
    # zero-escape rows
    zero = _compose(np.full(2 * chunk, cb.exponents[0]),
                    rng.integers(0, 1 << mbits, 2 * chunk),
                    rng.integers(0, 2, 2 * chunk), fmt)
    out.append(("zero_escape", zero, 64))
    for cap in CAPS:
        # all-escape rows: count == chunk > cap
        out.append((f"all_escape_cap{cap}",
                    _row_with_escapes(cb, chunk, chunk, rng), cap))
        # count == cap (fits) and count == cap + 1 (overflows by one)
        for n_esc in (cap, cap + 1):
            rows = [_row_with_escapes(cb, n_esc, chunk, rng),
                    _row_with_escapes(cb, 0, chunk, rng)]
            out.append((f"count{n_esc}_cap{cap}", np.concatenate(rows), cap))
    return out


def max_abs_err(got, want) -> int:
    """Largest integer difference between two tuples of integer tensors."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {tuple(g.shape)}/{g.dtype} vs "
                                 f"{tuple(w.shape)}/{w.dtype}")
        if g.numel():
            d = (C.widen(g).to(torch.int64) - C.widen(w).to(torch.int64)).abs()
            err = max(err, int(d.max()))
    return err


def check_case(bits, cb: Codebook, cap: int, chunk: int = 1024) -> dict:
    """Run all four kernel wrappers and their plain versions on one case.

    ``bits`` is a flat container tensor; its device decides whether the
    wrappers launch kernels (CUDA) or run the plain versions (CPU).  Returns
    ``{kernel name: max abs integer error vs the plain version}`` and checks
    that rows within capacity decode back to the input bits."""
    fmt, exps = cb.fmt, tuple(cb.exponents)
    flat = C._pad_to_chunk(bits, chunk, C.pad_bits_for(cb))
    x = flat.reshape(-1, chunk)
    errs = {}
    enc = E.encode_fused(x, exps, fmt, chunk, cap)
    errs["encode_fused"] = max_abs_err(enc, E.encode_fused_plain(x, exps, fmt, chunk, cap))
    sm, packed, pos, val, cnt = enc
    cnt = torch.clamp(cnt, max=cap)
    dec = D.decode_fused(packed, sm, pos, val, cnt, exps, fmt, chunk)
    errs["decode_fused"] = max_abs_err(
        (dec,), (D.decode_fused_plain(packed, sm, pos, val, cnt, exps, fmt, chunk),))
    dense = E.encode_dense(x, exps, fmt, chunk)
    errs["encode_dense"] = max_abs_err(dense, E.encode_dense_plain(x, exps, fmt, chunk))
    ddec = D.decode_dense(dense[1], dense[0], exps, fmt, chunk)
    errs["decode_dense"] = max_abs_err(
        (ddec,), (D.decode_dense_plain(dense[1], dense[0], exps, fmt, chunk),))
    fits = (enc[4].reshape(-1) <= cap)
    if not C.bits_equal(C.signed_view(dec)[fits], C.signed_view(x)[fits]):
        raise AssertionError("decode_fused does not invert encode_fused on "
                             "rows within capacity")
    return errs
