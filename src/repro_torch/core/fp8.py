"""SplitZip on FP8 (paper Appendix B), the port of ``repro.core.fp8``.

E5M2: 5-bit exponent -> top-16 (4-bit codes, preferred) or top-8 (3-bit).
E4M3: 4-bit exponent -> only top-8 (3-bit) is meaningful; a 4-bit code would
not shrink the exponent at all.

The codebook and codec already take both formats through ``fmt=``; this
module pins down the paper's recommended settings and the per-variant size
model.  The size model counts ``code_bits`` a code; the codec's streams stay
nibble-packed for every book of at most 16 exponents, as the JAX package's
do, so a k-8 stream's bytes follow 4-bit codes (``codec.compressed_bytes``
counts the model's 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import codec
from repro_torch.core.codebook import FORMATS, Codebook, calibrate

# paper Appendix B: preferred settings per format
RECOMMENDED = {
    "bf16": dict(k=16),
    "fp8_e5m2": dict(k=16),   # highest ratio AND lowest escape rate (Table 8)
    "fp8_e4m3": dict(k=8),    # 4-bit codes would not compress a 4-bit exponent
}


def recommended_k(fmt: str) -> int:
    return RECOMMENDED[fmt]["k"]


def calibrate_fp8(tensors, fmt: str = "fp8_e5m2", k: int | None = None) -> Codebook:
    return calibrate(tensors, k=k or recommended_k(fmt), fmt=fmt)


def ratio_vs_native(fmt: str, k: int, escape_rate: float) -> float:
    """Compression ratio against the same-format native payload."""
    return codec.theoretical_ratio(fmt, k, escape_rate)


def ratio_vs_bf16(fmt: str, k: int, escape_rate: float) -> float:
    """Ratio against the BF16 baseline (paper Table 8): FP8 already halves
    the payload, so multiply by bf16_bits / fp8_bits."""
    return ratio_vs_native(fmt, k, escape_rate) * (16.0 / FORMATS[fmt]["bits"])


@dataclasses.dataclass(frozen=True)
class Fp8Variant:
    fmt: str
    k: int

    @property
    def code_bits(self) -> int:
        return max(1, int(np.ceil(np.log2(max(2, self.k)))))


VARIANTS = (
    Fp8Variant("fp8_e4m3", 8),
    Fp8Variant("fp8_e5m2", 8),
    Fp8Variant("fp8_e5m2", 16),
)
