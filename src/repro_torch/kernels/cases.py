"""Edge-case inputs for holding the codec kernels against their plain versions.

Each case is container bits (u16 for bf16, u8 for fp8) plus an escape
capacity, chosen where a kernel is most likely to differ from its plain
version: special values (NaN payloads, infinities, signed zeros,
subnormals), rows without escapes, rows that are all escapes, escape counts
at ``cap`` and ``cap + 1``, capacities 1/64/128, and a ragged tail that
``_pad_to_chunk`` pads.  :func:`fused_cases` adds the edges of the
persistent warp-a-row fused kernels (other chunk widths, 1 and 7 rows,
counts around the 32-slot prefetch, escapes packed into one lane's
elements) and :func:`repeated_slot_case` a decode input whose slots 31 and
32 name one position.  Made with numpy from a seed, so the CPU tests and the
on-card check draw the same inputs.

:func:`codec_leaf` and :func:`escape_heavy` make the timed inputs, on the
card: one smollm-135m KV leaf of seeded normal bf16 values, and the same
leaf with about two escapes a row.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
#: 8-exponent books (3-bit codes in the size model, still nibble-packed):
#: ``fp8.RECOMMENDED``'s k for e4m3 and Appendix B's other e5m2 variant
CODEBOOKS_K8 = {
    "bf16": Codebook(fmt="bf16", exponents=tuple(range(122, 130))),
    "fp8_e5m2": Codebook(fmt="fp8_e5m2", exponents=tuple(range(11, 19))),
    "fp8_e4m3": Codebook(fmt="fp8_e4m3", exponents=tuple(range(4, 12))),
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


def kernel_cases(fmt: str, seed: int = 0, chunk: int = 1024,
                 cb: Optional[Codebook] = None
                 ) -> List[Tuple[str, np.ndarray, int]]:
    """``[(name, flat container bits, cap), ...]`` for one format, under
    ``cb`` (default ``CODEBOOKS[fmt]``)."""
    rng = np.random.default_rng(seed)
    cb = cb or CODEBOOKS[fmt]
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


def _rows(cb: Codebook, counts, chunk: int, rng: np.random.Generator) -> np.ndarray:
    return np.concatenate([_row_with_escapes(cb, n, chunk, rng) for n in counts])


def _row_escaping_at(cb: Codebook, positions, chunk: int,
                     rng: np.random.Generator) -> np.ndarray:
    """One chunk whose exponents are in the codebook except at ``positions``."""
    row = _row_with_escapes(cb, 0, chunk, rng)
    mbits, ebits = FORMATS[cb.fmt]["mbits"], FORMATS[cb.fmt]["ebits"]
    field = np.asarray(((1 << ebits) - 1) << mbits, dtype=row.dtype)
    esc = np.asarray(_escape_exponent(cb) << mbits, dtype=row.dtype)
    row[list(positions)] = (row[list(positions)] & ~field) | esc
    return row


#: (chunk, per-row escape counts, cap): chunks of 1 to 32 steps of 256
#: elements, with counts under, at and over the cap
FUSED_CHUNKS = ((256, (0, 3, 4, 5), 4), (768, (2, 0, 9, 8), 8),
                (2048, (1, 7, 0), 6), (8192, (40, 3, 0), 33))


def fused_cases(fmt: str, seed: int = 0, cb: Optional[Codebook] = None
                ) -> List[Tuple[str, np.ndarray, int, int]]:
    """``[(name, flat container bits, cap, chunk), ...]``: where a
    persistent kernel that takes a warp a row is most likely to go wrong
    (under ``cb``, default ``CODEBOOKS[fmt]``)."""
    rng = np.random.default_rng(seed)
    cb = cb or CODEBOOKS[fmt]
    out = [(f"chunk{chunk}", _rows(cb, counts, chunk, rng), cap, chunk)
           for chunk, counts, cap in FUSED_CHUNKS]
    out.append(("rows1", _rows(cb, (5,), 1024, rng), 8, 1024))
    out.append(("rows7", _rows(cb, (0, 1, 8, 9, 3, 0, 2), 1024, rng), 8, 1024))
    # around the 32 slots decode reads with the streams, and at cap / cap + 1
    out.append(("count31_32_33_cap40",
                _rows(cb, (31, 32, 33, 40, 41), 1024, rng), 40, 1024))
    # every escape of a row inside one 16-element span (first, middle, last)
    out.append(("one_lane16", np.concatenate(
        [_row_escaping_at(cb, range(16 * l, 16 * l + 16), 1024, rng)
         for l in (0, 13, 63)]), 16, 1024))
    return out


def repeated_slot_case(fmt: str, seed: int = 0, chunk: int = 1024,
                       cap: int = 40):
    """Decode streams (packed, sign_mantissa, esc_pos, esc_val, esc_count) of
    two rows whose first row's slots 31 and 32 name one position with
    different values (count 40 == cap): the later slot must win."""
    rng = np.random.default_rng(seed)
    cb = CODEBOOKS[fmt]
    bits = _rows(cb, (cap, 2), chunk, rng)
    t = torch.from_numpy(bits.view(np.int16)).view(torch.uint16) \
        if bits.dtype == np.uint16 else torch.from_numpy(bits)
    sm, packed, pos, val, cnt = E.encode_fused_plain(
        t.reshape(-1, chunk), tuple(cb.exponents), fmt, chunk, cap)
    pos, val = C.signed_view(pos).clone(), val.clone()
    pos[0, 32] = pos[0, 31]
    val[0, 32] = (int(val[0, 31]) + 1) % (1 << FORMATS[fmt]["ebits"])
    return packed, sm, C.unsigned_view(pos), val, torch.clamp(cnt, max=cap)


def many_rows(fmt: str, rows: int, seed: int = 0, chunk: int = 1024,
              rate: float = 2 / 1024) -> np.ndarray:
    """``rows`` chunks whose elements escape independently with probability
    ``rate``: enough rows to take a persistent grid more than one pass."""
    rng = np.random.default_rng(seed)
    cb = CODEBOOKS[fmt]
    n = rows * chunk
    e = rng.choice(np.asarray(cb.exponents), size=n)
    e[rng.random(n) < rate] = _escape_exponent(cb)
    mbits = FORMATS[fmt]["mbits"]
    return _compose(e, rng.integers(0, 1 << mbits, n), rng.integers(0, 2, n), fmt)


# ---------------------------------------------------------------------------
# the timed inputs (on the card)
# ---------------------------------------------------------------------------

#: one smollm-135m KV leaf (layers, batch, sequence, KV heads, head_dim) at
#: chip_smoke's main path: batch 8, a 2048-token prompt plus 1 + 16 tokens
MAIN_LEAF_SHAPE = (30, 8, 2048 + 1 + 16, 3, 64)


def codec_leaf(device, shape=MAIN_LEAF_SHAPE, seed: int = 7):
    """Seeded normal bf16 values of ``shape`` as (rows, 1024) u16 container
    bits, and the 16-exponent codebook calibrated on their first 4 Mi."""
    from repro_torch.core.codebook import calibrate
    gen = torch.Generator(device=device).manual_seed(seed)
    leaf = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    sample = leaf.reshape(-1)[: 1 << 22].view(torch.int16).cpu().numpy().view("uint16")
    cb = calibrate([sample], k=16)
    return C.to_bits(leaf, "bf16").reshape(-1, 1024), cb


def escape_heavy(bits: torch.Tensor, cb: Codebook, rate: float = 2 / 1024,
                 seed: int = 11) -> torch.Tensor:
    """A copy of container ``bits`` in which each element, chosen
    independently with probability ``rate`` by a seeded generator, gets an
    exponent outside ``cb`` (uniform over those), sign and mantissa kept."""
    s = FORMATS[cb.fmt]
    gen = torch.Generator(device=bits.device).manual_seed(seed)
    hit = torch.nonzero(torch.rand(bits.numel(), generator=gen,
                                   device=bits.device) < rate).reshape(-1)
    outside = torch.tensor([e for e in range(1 << s["ebits"])
                            if e not in cb.exponents], device=bits.device)
    e = outside[torch.randint(outside.numel(), (hit.numel(),), generator=gen,
                              device=bits.device)]
    keep = ((1 << s["bits"]) - 1) ^ (((1 << s["ebits"]) - 1) << s["mbits"])
    x = C.widen(bits).reshape(-1).clone()
    x[hit] = (x[hit] & keep) | (e.to(x.dtype) << s["mbits"])
    return C.narrow(x, bits.dtype).reshape(bits.shape)


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


def check_decode_case(streams, cb: Codebook, chunk: int = 1024) -> int:
    """``decode_fused`` against its plain version on given streams (their
    device decides kernel or plain): the max abs integer error."""
    fmt, exps = cb.fmt, tuple(cb.exponents)
    got = D.decode_fused(*streams, exps, fmt, chunk)
    return max_abs_err((got,), (D.decode_fused_plain(*streams, exps, fmt, chunk),))
