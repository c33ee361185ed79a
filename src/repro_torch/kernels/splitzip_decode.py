"""SplitZip decode kernels (paper §3.2): wrappers and their plain versions.

``decode_fused`` unpacks the 4-bit codes, maps them through the codebook,
reassembles the container bits from the sign-mantissa stream AND applies the
sparse escape correction in one CUDA launch (``csrc/splitzip_decode.cu``, the
port of the Pallas ``decode_fused``: a persistent grid, a warp per chunk row,
escapes patched in registers).  ``decode_dense`` is the dense stage alone,
for layouts whose correction stays outside the kernel (``layout='global'``
and capacities above ``MAX_FUSED_CAP``): the same kernel with the escapes
compiled out.  :func:`fused_grid` and :func:`dense_grid` say how many CTAs
each launches, from its own occupancy (:func:`ctas_per_sm`).

Each wrapper launches its kernel for CUDA operands and runs its plain PyTorch
version (``*_plain``) only for CPU operands; anything else raises.
``launches`` on a wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import abstract as AB
from repro_torch.core import codec as C
from repro_torch.core.codebook import FORMATS
from repro_torch.kernels import build

#: warps in a CTA of the persistent fused kernel (``FUSED_WARPS`` in csrc)
FUSED_WARPS = 8

_P = ctypes.c_void_p
_PROTOTYPES = {
    "sz_decode_fused": [ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_int, _P, _P],
    "sz_decode_fused_grid": [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)],
    "sz_decode_dense": [ctypes.c_int, _P, _P, _P, ctypes.c_longlong,
                        ctypes.c_int, _P, _P],
    "sz_decode_dense_grid": [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)],
    "sz_decode_ctas_per_sm": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int)],
}


def decode_lut(exponents: tuple) -> np.ndarray:
    """16 bytes: code -> exponent (codes beyond the codebook decode to 0)."""
    if len(exponents) > 16:
        raise ValueError("the codec kernels unpack 4-bit codes (k <= 16); got "
                         f"k={len(exponents)}")
    lut = np.zeros(16, dtype=np.uint8)
    lut[:len(exponents)] = exponents
    return lut


def _check_dense(packed, sign_mantissa, chunk):
    rows = sign_mantissa.shape[0]
    build.check_operand(sign_mantissa, "sign_mantissa", torch.uint8, (rows, chunk))
    build.check_operand(packed, "packed", torch.uint8, (rows, chunk // 2))
    return rows


def _lib():
    return build.library("splitzip_decode", _PROTOTYPES)


def _grid(entry: str, fmt: str, rows: int, chunk: int, device) -> int:
    lib, ctas = _lib(), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(build.FMT_ID[fmt], rows, chunk,
                                  ctypes.byref(ctas))
    build.check(lib, err, entry)
    return ctas.value


def fused_grid(fmt: str, rows: int, chunk: int, device) -> int:
    """CTAs (of ``FUSED_WARPS`` warps, a warp a row at a time) that
    ``decode_fused`` launches for ``rows`` rows of ``chunk`` on the CUDA
    ``device``: as many as fit on the card at once, no more than the rows
    need."""
    return _grid("sz_decode_fused_grid", fmt, rows, chunk, device)


def dense_grid(fmt: str, rows: int, chunk: int, device) -> int:
    """:func:`fused_grid` for ``decode_dense``, from its own occupancy."""
    return _grid("sz_decode_dense_grid", fmt, rows, chunk, device)


def ctas_per_sm(kernel: str, fmt: str, chunk: int, device) -> int:
    """CTAs of the ``"fused"`` or ``"dense"`` decode kernel for ``chunk``
    that fit on one SM of the CUDA ``device``, asked of the runtime anew
    (the grids above cache theirs)."""
    if kernel not in ("fused", "dense"):
        raise ValueError(f"kernel={kernel!r}: 'fused' or 'dense'")
    lib, n = _lib(), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.sz_decode_ctas_per_sm(int(kernel == "fused"),
                                        build.FMT_ID[fmt], chunk,
                                        ctypes.byref(n))
    build.check(lib, err, f"{kernel} decode occupancy")
    return n.value


def fused_work(rows: int, chunk: int, applied: int, width: int = 2):
    """(bytes, operations) ``decode_fused`` must move and do: the codes and
    sign-mantissa bytes read, ``applied`` escape slots (3 bytes) and the
    counts read, the bits written; 12 operations an element.  The dry
    run's static figure applies every slot (``rows * cap``)."""
    n = rows * chunk
    return n // 2 + n + 3 * applied + 4 * rows + width * n, 12 * n


def dense_work(rows: int, chunk: int, width: int = 2):
    """(bytes, operations) of ``decode_dense``: the codes and sign-mantissa
    bytes read, the bits written; 10 operations an element."""
    n = rows * chunk
    return n // 2 + n + width * n, 10 * n


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def decode_dense_plain(packed: torch.Tensor, sign_mantissa: torch.Tensor,
                       exponents: tuple, fmt: str = "bf16", chunk: int = 1024):
    """(rows, chunk//2) packed + (rows, chunk) sign-mantissa -> (rows, chunk)
    container bits, escaped exponents left at code 0's value."""
    rows = sign_mantissa.shape[0]
    e = C.decode_codes(C.unpack_nibbles(packed.reshape(-1)), exponents)
    return C.join_fields(e, sign_mantissa.reshape(-1), fmt).reshape(rows, chunk)


def decode_fused_plain(packed: torch.Tensor, sign_mantissa: torch.Tensor,
                       esc_pos: torch.Tensor, esc_val: torch.Tensor,
                       esc_count: torch.Tensor, exponents: tuple,
                       fmt: str = "bf16", chunk: int = 1024):
    """Dense decode, then the exponent field is overwritten at each row's
    escape slots ``j < esc_count`` in slot order; slots with ``pos >= chunk``
    (padding) are skipped."""
    s = FORMATS[fmt]
    mbits, ebits, nbits = s["mbits"], s["ebits"], s["bits"]
    keep = ((1 << nbits) - 1) ^ (((1 << ebits) - 1) << mbits)
    rows, cap = esc_pos.shape
    x = C.widen(decode_dense_plain(packed, sign_mantissa, exponents, fmt, chunk))
    cnt = torch.clamp(esc_count.reshape(-1), min=0, max=cap)
    pos = C.widen(esc_pos).to(torch.int64)
    val = esc_val.to(torch.int32)
    for j in range(int(cnt.max()) if rows else 0):
        r = torch.nonzero((cnt > j) & (pos[:, j] < chunk)).reshape(-1)
        p = pos[r, j]
        x[r, p] = (x[r, p] & keep) | (val[r, j] << mbits)
    return C.narrow(x, C.container_dtype(fmt))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def decode_dense(packed: torch.Tensor, sign_mantissa: torch.Tensor,
                 exponents: tuple, fmt: str = "bf16", chunk: int = 1024):
    """Dense decode to container bits: (rows, chunk//2) packed + (rows, chunk)
    sign-mantissa -> (rows, chunk) u16/u8 (escapes still dummy).  Fake
    operands under the dry run's abstract run get a fake output and the
    kernel's :func:`dense_work` credited; nothing launches."""
    rows = _check_dense(packed, sign_mantissa, chunk)
    lut = decode_lut(exponents)
    abstract = AB.on_card(packed, sign_mantissa)
    if not abstract and not build.on_cuda(packed, sign_mantissa):
        return decode_dense_plain(packed, sign_mantissa, exponents, fmt, chunk)
    out = torch.empty((rows, chunk), dtype=C.container_dtype(fmt),
                      device=packed.device)
    if abstract:
        AB.credit("decode_dense", *dense_work(rows, chunk, out.element_size()))
        return out
    build.check_launchable(chunk, packed, sign_mantissa, out)
    lib = _lib()
    with torch.cuda.device(packed.device):
        err = lib.sz_decode_dense(
            build.FMT_ID[fmt], packed.data_ptr(), sign_mantissa.data_ptr(),
            out.data_ptr(), rows, chunk, lut.ctypes.data,
            build.stream_of(packed))
    build.check(lib, err, "decode_dense")
    decode_dense.launches += 1
    return out


def decode_fused(packed: torch.Tensor, sign_mantissa: torch.Tensor,
                 esc_pos: torch.Tensor, esc_val: torch.Tensor,
                 esc_count: torch.Tensor, exponents: tuple, fmt: str = "bf16",
                 chunk: int = 1024):
    """Single-launch fused decode to FINAL container bits.

    (rows, chunk//2) packed + (rows, chunk) sign-mantissa + (rows, cap)
    esc_pos u16 / esc_val u8 + (rows, 1) esc_count i32 (clipped to cap by
    the caller) -> (rows, chunk) u16/u8 with the sparse correction applied.

    Fake operands under the dry run's abstract run take the abstract form
    (:mod:`repro_torch.core.abstract`), as in ``decode_dense``."""
    rows = _check_dense(packed, sign_mantissa, chunk)
    cap = esc_pos.shape[1] if esc_pos.dim() == 2 else -1
    build.check_operand(esc_pos, "esc_pos", torch.uint16, (rows, cap))
    build.check_operand(esc_val, "esc_val", torch.uint8, (rows, cap))
    build.check_operand(esc_count, "esc_count", torch.int32, (rows, 1))
    lut = decode_lut(exponents)
    operands = (packed, sign_mantissa, esc_pos, esc_val, esc_count)
    abstract = AB.on_card(*operands)
    if not abstract and not build.on_cuda(*operands):
        return decode_fused_plain(packed, sign_mantissa, esc_pos, esc_val,
                                  esc_count, exponents, fmt, chunk)
    if cap < 1:
        raise ValueError("decode_fused needs at least one escape slot per row")
    out = torch.empty((rows, chunk), dtype=C.container_dtype(fmt),
                      device=packed.device)
    if abstract:
        AB.credit("decode_fused", *fused_work(rows, chunk, rows * cap,
                                              out.element_size()))
        return out
    build.check_launchable(chunk, packed, sign_mantissa, out)
    lib = _lib()
    with torch.cuda.device(packed.device):
        err = lib.sz_decode_fused(
            build.FMT_ID[fmt], packed.data_ptr(), sign_mantissa.data_ptr(),
            esc_pos.data_ptr(), esc_val.data_ptr(), esc_count.data_ptr(),
            out.data_ptr(), rows, chunk, cap, lut.ctypes.data,
            build.stream_of(packed))
    build.check(lib, err, "decode_fused")
    decode_fused.launches += 1
    return out


decode_dense.launches = 0
decode_fused.launches = 0
