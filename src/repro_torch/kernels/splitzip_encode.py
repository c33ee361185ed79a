"""SplitZip encode kernels (paper §3.2): wrappers and their plain versions.

``encode_fused`` emits the complete per-chunk streams — field split, code
lookup, nibble packing AND the escape compaction — from one CUDA launch
(``csrc/splitzip_encode.cu``, the port of the Pallas ``encode_fused``: a
persistent grid, a warp per chunk row; :func:`fused_grid` says how many
CTAs it launches).
``encode_dense`` is the dense stage alone, for the two-stage path
(:mod:`repro_torch.kernels.twostage`): capacities above ``MAX_FUSED_CAP`` and
the capacity schedule's ``layout='global'`` step.

Each wrapper launches its kernel for CUDA operands and runs its plain PyTorch
version (``*_plain``, the same arithmetic on tensors) only for CPU operands;
anything else raises.  ``launches`` on a wrapper counts its kernel launches.
Under the dry run's abstract run (:mod:`repro_torch.core.abstract`) fake
operands take the abstract form: fake outputs of the kernel's shapes and
dtypes, the kernel's work (:func:`fused_work`, :func:`dense_work`) credited
to the run, nothing built or launched.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import abstract as AB
from repro_torch.core import codec as C
from repro_torch.kernels import build

#: Largest per-chunk escape capacity the fused kernel takes; above it the
#: ops layer routes to the two-stage path (the same split as the JAX package).
MAX_FUSED_CAP = 128

#: warps in a CTA of the persistent fused kernel (``FUSED_WARPS`` in csrc)
FUSED_WARPS = 8

_P = ctypes.c_void_p
_PROTOTYPES = {
    "sz_encode_fused": [ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_int, _P, _P],
    "sz_encode_fused_grid": [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)],
    "sz_encode_dense": [ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong,
                        ctypes.c_int, _P, _P],
}


def encode_lut(exponents: tuple) -> np.ndarray:
    """256 bytes: exponent -> code, with 0x80 set where the exponent escapes
    (escapes keep the dummy code 0)."""
    lut = np.full(256, 0x80, dtype=np.uint8)
    for code, e in enumerate(exponents):
        lut[int(e)] = code
    return lut


def _check_inputs(bits, exponents, fmt, chunk):
    if len(exponents) > 16:
        raise ValueError("the codec kernels pack 4-bit codes (k <= 16); got "
                         f"k={len(exponents)}")
    if bits.dim() != 2 or bits.shape[1] != chunk:
        raise ValueError(f"expected (rows, chunk={chunk}) bits, got "
                         f"{tuple(bits.shape)}")
    build.check_operand(bits, "bits", C.container_dtype(fmt), bits.shape)


def _outputs(rows, chunk, device):
    sm = torch.empty((rows, chunk), dtype=torch.uint8, device=device)
    packed = torch.empty((rows, chunk // 2), dtype=torch.uint8, device=device)
    return sm, packed


def _lib():
    return build.library("splitzip_encode", _PROTOTYPES)


def fused_grid(fmt: str, rows: int, chunk: int, device) -> int:
    """CTAs (of ``FUSED_WARPS`` warps, a warp a row at a time) that
    ``encode_fused`` launches for ``rows`` rows of ``chunk`` on the CUDA
    ``device``: as many as fit on the card at once, no more than the rows
    need."""
    lib, ctas = _lib(), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.sz_encode_fused_grid(build.FMT_ID[fmt], rows, chunk,
                                     ctypes.byref(ctas))
    build.check(lib, err, "encode_fused grid")
    return ctas.value


def fused_work(rows: int, chunk: int, cap: int, width: int = 2):
    """(bytes, operations) ``encode_fused`` must move and do over ``rows``
    x ``chunk`` elements of ``width`` bytes: the bits read once, the
    sign-mantissa bytes, the nibble codes, every escape slot (3 bytes) and
    the counts written; 16 operations an element."""
    n = rows * chunk
    return width * n + n + n // 2 + 3 * rows * cap + 4 * rows, 16 * n


def dense_work(rows: int, chunk: int, width: int = 2):
    """(bytes, operations) of ``encode_dense``: the bits read once, the
    sign-mantissa bytes, the codes and the escape mask written; 12
    operations an element."""
    n = rows * chunk
    return width * n + n + n // 2 + n, 12 * n


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def encode_dense_plain(bits: torch.Tensor, exponents: tuple, fmt: str = "bf16",
                       chunk: int = 1024):
    """(rows, chunk) bits -> (sign_mantissa u8, packed u8[rows, chunk//2],
    is_escape u8)."""
    rows = bits.shape[0]
    e, a = C.split_fields(bits.reshape(-1), fmt)
    code, member = C.assign_codes(e, exponents)
    return (a.reshape(rows, chunk), C.pack_nibbles(code).reshape(rows, chunk // 2),
            (~member).to(torch.uint8).reshape(rows, chunk))


def encode_fused_plain(bits: torch.Tensor, exponents: tuple, fmt: str = "bf16",
                       chunk: int = 1024, cap: int = 64):
    """(rows, chunk) bits -> (sign_mantissa u8[rows,chunk], packed
    u8[rows,chunk//2], esc_pos u16[rows,cap], esc_val u8[rows,cap],
    esc_count i32[rows,1]); the count is the TRUE per-row count."""
    rows = bits.shape[0]
    e, a = C.split_fields(bits.reshape(-1), fmt)
    code, member = C.assign_codes(e, exponents)
    esc_pos, esc_val, esc_count, _ = C.collect_escapes(e, member, chunk, cap)
    return (a.reshape(rows, chunk), C.pack_nibbles(code).reshape(rows, chunk // 2),
            esc_pos, esc_val, esc_count.reshape(rows, 1))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def encode_dense(bits: torch.Tensor, exponents: tuple, fmt: str = "bf16",
                 chunk: int = 1024):
    """Dense-only encode of a (rows, chunk) bit tensor (two-stage path).

    Returns (sign_mantissa u8[rows,chunk], packed u8[rows,chunk//2],
    is_escape u8[rows,chunk]); the escape compaction happens outside."""
    _check_inputs(bits, exponents, fmt, chunk)
    rows = bits.shape[0]
    if AB.on_card(bits):
        AB.credit("encode_dense", *dense_work(rows, chunk, bits.element_size()))
        sm, packed = _outputs(rows, chunk, bits.device)
        return sm, packed, torch.empty((rows, chunk), dtype=torch.uint8,
                                       device=bits.device)
    if not build.on_cuda(bits):
        return encode_dense_plain(bits, exponents, fmt, chunk)
    sm, packed = _outputs(rows, chunk, bits.device)
    is_esc = torch.empty((rows, chunk), dtype=torch.uint8, device=bits.device)
    build.check_launchable(chunk, bits, sm, packed, is_esc)
    lut = encode_lut(exponents)
    lib = _lib()
    with torch.cuda.device(bits.device):
        err = lib.sz_encode_dense(
            build.FMT_ID[fmt], bits.data_ptr(), sm.data_ptr(), packed.data_ptr(),
            is_esc.data_ptr(), rows, chunk, lut.ctypes.data,
            build.stream_of(bits))
    build.check(lib, err, "encode_dense")
    encode_dense.launches += 1
    return sm, packed, is_esc


def encode_fused(bits: torch.Tensor, exponents: tuple, fmt: str = "bf16",
                 chunk: int = 1024, cap: int = 64):
    """Single-launch fused encode of a (rows, chunk) bit tensor.

    Returns (sign_mantissa u8[rows,chunk], packed u8[rows,chunk//2],
    esc_pos u16[rows,cap], esc_val u8[rows,cap], esc_count i32[rows,1]).
    ``esc_count`` is the TRUE per-row count (may exceed ``cap``; entries
    beyond ``cap`` are dropped), as :func:`repro_torch.core.codec.collect_escapes`."""
    if not 1 <= cap <= MAX_FUSED_CAP:
        raise ValueError(
            f"cap ({cap}) outside [1, MAX_FUSED_CAP={MAX_FUSED_CAP}]; use the "
            "two-stage path (repro_torch.kernels.twostage) for larger ones")
    _check_inputs(bits, exponents, fmt, chunk)
    abstract = AB.on_card(bits)
    if not abstract and not build.on_cuda(bits):
        return encode_fused_plain(bits, exponents, fmt, chunk, cap)
    rows = bits.shape[0]
    dev = bits.device
    sm, packed = _outputs(rows, chunk, dev)
    esc_pos = torch.empty((rows, cap), dtype=torch.uint16, device=dev)
    esc_val = torch.empty((rows, cap), dtype=torch.uint8, device=dev)
    esc_count = torch.empty((rows, 1), dtype=torch.int32, device=dev)
    if abstract:
        AB.credit("encode_fused",
                  *fused_work(rows, chunk, cap, bits.element_size()))
        return sm, packed, esc_pos, esc_val, esc_count
    build.check_launchable(chunk, bits, sm, packed, esc_pos, esc_val)
    lut = encode_lut(exponents)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.sz_encode_fused(
            build.FMT_ID[fmt], bits.data_ptr(), sm.data_ptr(), packed.data_ptr(),
            esc_pos.data_ptr(), esc_val.data_ptr(), esc_count.data_ptr(), rows,
            chunk, cap, lut.ctypes.data, build.stream_of(bits))
    build.check(lib, err, "encode_fused")
    encode_fused.launches += 1
    return sm, packed, esc_pos, esc_val, esc_count


encode_dense.launches = 0
encode_fused.launches = 0
