"""Offline calibration of SplitZip exponent codebooks (paper §3.3).

A numpy-only copy of ``repro.core.codebook``: the port keeps its own so that
it never imports the JAX package (whose ``core`` package pulls in JAX).  The
parity tests hold both copies to identical tables and JSON.

Calibration extracts all exponent values from representative tensors, counts
their frequencies, selects the top-K exponents, and builds three tables:

* ``encode_table``  — raw exponent value (0..2**ebits-1) -> K-bit code, with
  escapes marked (membership folded in: code is only valid where
  ``member_table`` is True).
* ``decode_table``  — K-bit code -> raw exponent value.
* ``member_table``  — raw exponent value -> bool (is it in the codebook?).

The codebook is a frozen, hashable dataclass: the kernels bake its tables
into their launch parameters.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable

import numpy as np

# Number formats SplitZip understands.  ``ebits``/``mbits`` exclude the sign.
FORMATS = {
    "bf16": dict(bits=16, ebits=8, mbits=7, npdtype=np.uint16),
    "fp8_e5m2": dict(bits=8, ebits=5, mbits=2, npdtype=np.uint8),
    "fp8_e4m3": dict(bits=8, ebits=4, mbits=3, npdtype=np.uint8),
}


def _spec(fmt: str) -> dict:
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; expected one of {sorted(FORMATS)}")
    return FORMATS[fmt]


def extract_exponents(bits: np.ndarray, fmt: str = "bf16") -> np.ndarray:
    """Raw-bit tensor -> exponent field (paper §3.2 `e_i = (x>>7)&0xff`)."""
    s = _spec(fmt)
    bits = np.asarray(bits).view(s["npdtype"]).ravel()
    return ((bits >> s["mbits"]) & ((1 << s["ebits"]) - 1)).astype(np.int32)


def extract_sign_mantissa(bits: np.ndarray, fmt: str = "bf16") -> np.ndarray:
    """Raw-bit tensor -> exact sign+mantissa byte (`a_i` in the paper)."""
    s = _spec(fmt)
    bits = np.asarray(bits).view(s["npdtype"]).ravel()
    sign_shift = s["ebits"]  # sign sits above the exponent field
    sign = (bits >> sign_shift) & (1 << s["mbits"])  # sign moved to bit mbits
    # Pack sign into the bit right above the mantissa so a_i fits mbits+1 bits.
    return (sign | (bits & ((1 << s["mbits"]) - 1))).astype(np.uint8)


def reassemble(sign_mantissa: np.ndarray, exponents: np.ndarray, fmt: str = "bf16") -> np.ndarray:
    """Inverse of (extract_sign_mantissa, extract_exponents): bit-exact."""
    s = _spec(fmt)
    a = sign_mantissa.astype(np.uint32)
    e = exponents.astype(np.uint32)
    mant_mask = (1 << s["mbits"]) - 1
    sign = (a >> s["mbits"]) & 1
    out = (sign << (s["bits"] - 1)) | (e << s["mbits"]) | (a & mant_mask)
    return out.astype(s["npdtype"])


def exponent_histogram(bits: np.ndarray, fmt: str = "bf16") -> np.ndarray:
    """Counts over the full exponent range (2**ebits bins)."""
    s = _spec(fmt)
    e = extract_exponents(bits, fmt)
    return np.bincount(e, minlength=1 << s["ebits"]).astype(np.int64)


def exponent_entropy(hist: np.ndarray) -> float:
    """Shannon entropy (bits) of an exponent histogram (paper Table 1)."""
    total = hist.sum()
    if total == 0:
        return 0.0
    p = hist[hist > 0] / total
    return float(-(p * np.log2(p)).sum())


def topk_coverage(hist: np.ndarray, k: int) -> float:
    """Fraction of mass covered by the k most frequent exponents."""
    total = hist.sum()
    if total == 0:
        return 1.0
    return float(np.sort(hist)[::-1][:k].sum() / total)


@dataclasses.dataclass(frozen=True)
class Codebook:
    """A calibrated top-K exponent codebook (paper §3.3).

    ``exponents`` is the tuple of the K most frequent exponent values, in
    descending frequency order; code ``j`` decodes to ``exponents[j]``.
    """

    fmt: str
    exponents: tuple  # length K, each in [0, 2**ebits)

    # -- derived sizes ------------------------------------------------------
    @property
    def k(self) -> int:
        return len(self.exponents)

    @property
    def code_bits(self) -> int:
        return max(1, int(np.ceil(np.log2(max(2, self.k)))))

    @property
    def ebits(self) -> int:
        return _spec(self.fmt)["ebits"]

    @property
    def mbits(self) -> int:
        return _spec(self.fmt)["mbits"]

    @property
    def container_bits(self) -> int:
        return _spec(self.fmt)["bits"]

    # -- tables --------------------------------------------------------------
    def encode_table(self) -> np.ndarray:
        """exponent value -> code (escapes get code 0, the dummy code)."""
        table = np.zeros(1 << self.ebits, dtype=np.int32)
        for code, e in enumerate(self.exponents):
            table[e] = code
        return table

    def member_table(self) -> np.ndarray:
        table = np.zeros(1 << self.ebits, dtype=bool)
        for e in self.exponents:
            table[e] = True
        return table

    def decode_table(self) -> np.ndarray:
        """code -> exponent value, padded to 2**code_bits entries."""
        table = np.zeros(1 << self.code_bits, dtype=np.int32)
        for code, e in enumerate(self.exponents):
            table[code] = e
        return table

    # -- persistence ----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"fmt": self.fmt, "exponents": list(map(int, self.exponents))})

    @staticmethod
    def from_json(s: str) -> "Codebook":
        d = json.loads(s)
        return Codebook(fmt=d["fmt"], exponents=tuple(d["exponents"]))


# The uncalibrated bf16 fallback: the 16-exponent normal-activation band
# below the bias.  Every consumer that needs a codebook before (or without)
# a calibration pass — serve/dryrun launchers, the scheduler's analytic
# bucket plans, gradient compression — must share THIS object so the default
# band can never silently diverge between them.
DEFAULT_BF16_CODEBOOK = Codebook(fmt="bf16", exponents=tuple(range(112, 128)))


def calibrate(
    tensors: Iterable[np.ndarray],
    k: int = 16,
    fmt: str = "bf16",
    ensure_zero: bool = True,
) -> Codebook:
    """One-time offline calibration (paper §3.3).

    ``tensors`` are raw-bit views (u16 for bf16, u8 for fp8) or arrays whose
    byte view matches the format; all exponents are pooled into one histogram
    and the top-``k`` most frequent exponents become the codebook.

    ``ensure_zero`` guarantees exponent 0 is in the codebook even when absent
    from the calibration sample: production caches carry structural zeros
    (padded slots, masked positions) whose exponent field is 0, and an
    uncovered zero-run explodes the escape rate.  (A deployment detail the
    paper doesn't discuss; costs at most the k-th most frequent exponent.)
    """
    s = _spec(fmt)
    hist = np.zeros(1 << s["ebits"], dtype=np.int64)
    for t in tensors:
        hist += exponent_histogram(t, fmt)
    return codebook_from_histogram(hist, k=k, fmt=fmt, ensure_zero=ensure_zero)


def codebook_from_histogram(hist: np.ndarray, k: int = 16, fmt: str = "bf16",
                            ensure_zero: bool = True) -> Codebook:
    order = np.argsort(hist, kind="stable")[::-1]  # descending frequency
    top = [int(e) for e in order[:k]]
    if ensure_zero and 0 not in top:
        top[-1] = 0
    return Codebook(fmt=fmt, exponents=tuple(top))


def coverage(cb: Codebook, bits: np.ndarray) -> float:
    """Fraction of elements of ``bits`` whose exponent is in the codebook."""
    e = extract_exponents(bits, cb.fmt)
    return float(cb.member_table()[e].mean()) if e.size else 1.0


def escape_rate(cb: Codebook, bits: np.ndarray) -> float:
    return 1.0 - coverage(cb, bits)


def calibrate_per_axis(
    tensor_bits: np.ndarray,
    axis: int,
    k: int = 16,
    fmt: str = "bf16",
) -> list:
    """Fine-grained calibration for the paper's granularity ablation (§4.3.3).

    Returns one Codebook per slice along ``axis`` (per-token or per-channel).
    Deliberately slow — the ablation's point is that this loses orders of
    magnitude of throughput for ~0.06% coverage gain.
    """
    tensor_bits = np.asarray(tensor_bits)
    n = tensor_bits.shape[axis]
    books = []
    for i in range(n):
        sl = np.take(tensor_bits, i, axis=axis)
        books.append(calibrate([sl], k=k, fmt=fmt))
    return books
