"""Two-stage codec path: dense kernels + escape passes in PyTorch.

The dense transformation runs in the ``encode_dense``/``decode_dense``
kernels; escape collection and the sparse correction are separate PyTorch
passes over the stream (the paper's literal two-stage description).  This is
the dispatch target for escape capacities above
:data:`repro_torch.kernels.splitzip_encode.MAX_FUSED_CAP` and for the
capacity schedule's ``layout='global'`` step (``CudaBackend(fused=False)``),
and it produces the same streams as the fused path.
"""

from __future__ import annotations

import torch

from repro_torch.core import abstract as AB
from repro_torch.core import codec as C
from repro_torch.core.codebook import FORMATS, Codebook
from repro_torch.kernels import splitzip_decode, splitzip_encode


def chunk_rows(x: torch.Tensor, codebook: Codebook, chunk: int) -> torch.Tensor:
    """Flatten ``x`` to container bits, pad to a chunk multiple with the
    codebook's padding pattern, view as (rows, chunk); the kernels take
    16-byte aligned rows, so a misaligned view is copied."""
    bits = C._pad_to_chunk(C.flat_bits(x, codebook.fmt), chunk,
                           C.pad_bits_for(codebook))
    if not AB.is_fake(bits) and bits.data_ptr() % 16:
        bits = C.unsigned_view(C.signed_view(bits).clone())
    return bits.reshape(-1, chunk)


def encode(
    x: torch.Tensor,
    codebook: Codebook,
    chunk: int = C.DEFAULT_CHUNK,
    cap: int = C.DEFAULT_CAP,
    layout: str = "chunked",
) -> C.CompressedTensor:
    """Two-stage encode: dense kernel + PyTorch escape collection."""
    fmt = codebook.fmt
    bits2 = chunk_rows(x, codebook, chunk)
    a, packed, is_esc = splitzip_encode.encode_dense(
        bits2, tuple(codebook.exponents), fmt=fmt, chunk=chunk)
    # stage 2: re-extract the exponent field, rank the escapes, scatter
    e, _ = C.split_fields(bits2.reshape(-1), fmt)
    member = is_esc.reshape(-1) == 0
    if layout == "global":
        if cap == C.DEFAULT_CAP:
            cap = C.default_global_cap(e.shape[0])
        esc_pos, esc_val, esc_count, ok = C.collect_escapes_global(e, member, cap)
    else:
        esc_pos, esc_val, esc_count, ok = C.collect_escapes(e, member, chunk, cap)
    return C.CompressedTensor(
        sign_mantissa=a.reshape(-1), packed=packed.reshape(-1),
        esc_pos=esc_pos, esc_val=esc_val, esc_count=esc_count, ok=ok,
        shape=tuple(x.shape), dtype=C.dtype_name(x.dtype), fmt=fmt,
        exponents=tuple(int(v) for v in codebook.exponents), chunk=chunk,
        cap=cap, layout=layout)


def decode_to_bits(ct: C.CompressedTensor) -> torch.Tensor:
    """Two-stage decode to flat bits: dense kernel + PyTorch correction."""
    chunk = ct.chunk
    rows = ct.n_padded // chunk
    bits2 = splitzip_decode.decode_dense(
        ct.packed.reshape(rows, chunk // 2), ct.sign_mantissa.reshape(rows, chunk),
        tuple(ct.exponents), fmt=ct.fmt, chunk=chunk)
    # stage 2: re-extract the exponent field, scatter the escapes, rejoin
    spec = FORMATS[ct.fmt]
    e = ((C.widen(bits2.reshape(-1)) >> spec["mbits"])
         & ((1 << spec["ebits"]) - 1)).to(torch.uint8)
    if ct.layout == "global":
        e = C.scatter_escapes_global(e, ct.esc_pos, ct.esc_val)
    else:
        e = C.scatter_escapes(e, ct.esc_pos, ct.esc_val, chunk)
    return C.join_fields(e, ct.sign_mantissa, ct.fmt)[:ct.n_elements]


def decode(ct: C.CompressedTensor) -> torch.Tensor:
    bits = decode_to_bits(ct).reshape(ct.shape)
    return C.from_bits(bits, C.dtype_from_name(ct.dtype))
