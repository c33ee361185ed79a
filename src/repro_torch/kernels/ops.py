"""Codec entry points over the CUDA kernels (the ``cuda`` backend's codec).

``encode``/``decode`` are drop-in replacements for
:mod:`repro_torch.core.codec`'s reference versions, with the dispatch of the
JAX package's ``kernels/ops.py``:

* ``layout='chunked'`` with ``cap <= MAX_FUSED_CAP``: one ``encode_fused``
  launch emits the complete streams; one ``decode_fused`` launch consumes the
  escape buffers (counts clipped to ``cap``) and emits final bits;
* ``cap > MAX_FUSED_CAP`` or ``fused=False``: the two-stage path
  (:mod:`repro_torch.kernels.twostage`);
* ``layout='global'``: encode runs the fused kernel at
  ``kcap = min(chunk, MAX_FUSED_CAP)`` and compacts its per-chunk buffers
  into the global one (:func:`repro_torch.core.codec.compact_chunked_to_global`);
  decode runs ``decode_dense`` and patches the exponent field at the escape
  positions only (:func:`_patch_escape_bits`).

The serving path reaches these through the ``cuda`` entry of the
:mod:`repro_torch.core.backend` registry.
"""

from __future__ import annotations

import torch

from repro_torch.core import abstract as AB
from repro_torch.core import codec as C
from repro_torch.core.codebook import FORMATS, Codebook
from repro_torch.kernels import splitzip_decode, splitzip_encode, twostage
from repro_torch.kernels.splitzip_encode import MAX_FUSED_CAP


def encode(
    x: torch.Tensor,
    codebook: Codebook,
    chunk: int = C.DEFAULT_CHUNK,
    cap: int = C.DEFAULT_CAP,
    layout: str = "chunked",
    fused: bool = True,
) -> C.CompressedTensor:
    """SplitZip encode with the single-launch fused kernel."""
    if not fused or (layout != "global" and cap > MAX_FUSED_CAP):
        return twostage.encode(x, codebook, chunk=chunk, cap=cap, layout=layout)
    fmt = codebook.fmt
    bits2 = twostage.chunk_rows(x, codebook, chunk)
    n_pad = bits2.numel()
    kcap = cap if layout != "global" else min(chunk, MAX_FUSED_CAP)
    a, packed, esc_pos_c, esc_val_c, cnt = splitzip_encode.encode_fused(
        bits2, tuple(codebook.exponents), fmt=fmt, chunk=chunk, cap=kcap)
    esc_count = cnt.reshape(-1)
    if layout == "global":
        if cap == C.DEFAULT_CAP:
            cap = C.default_global_cap(n_pad)
        # bounded second level over C x kcap entries, not the stream
        esc_pos, esc_val, esc_count, ok = C.compact_chunked_to_global(
            esc_pos_c, esc_val_c, esc_count, chunk, cap, n_pad)
    else:
        esc_pos, esc_val = esc_pos_c, esc_val_c
        ok = torch.all(esc_count <= cap)
    return C.CompressedTensor(
        sign_mantissa=a.reshape(-1), packed=packed.reshape(-1),
        esc_pos=esc_pos, esc_val=esc_val, esc_count=esc_count, ok=ok,
        shape=tuple(x.shape), dtype=C.dtype_name(x.dtype), fmt=fmt,
        exponents=tuple(int(v) for v in codebook.exponents), chunk=chunk,
        cap=cap, layout=layout)


def _patch_escape_bits(bits: torch.Tensor, ct: C.CompressedTensor) -> torch.Tensor:
    """Sparse bit-level correction for layouts the kernel does not consume
    per row (global buffer, oversized caps): patch the exponent field of the
    kernel's output bits at the escape positions only."""
    spec = FORMATS[ct.fmt]
    mbits, ebits, width = spec["mbits"], spec["ebits"], spec["bits"]
    n_pad = bits.shape[0]
    pos = C.widen(ct.esc_pos).to(torch.int64)
    if ct.layout == "global":
        flat = pos.reshape(-1)                              # padding == n_pad
    else:
        c = ct.esc_pos.shape[0]
        base = (torch.arange(c, dtype=torch.int64, device=pos.device)
                * ct.chunk)[:, None]
        flat = torch.where(pos < ct.chunk, base + pos, n_pad).reshape(-1)
    idx, val = AB.used_slots(flat < n_pad, flat,
                             ct.esc_val.reshape(-1).to(torch.int32))
    keep = ((1 << width) - 1) ^ (((1 << ebits) - 1) << mbits)
    sv = C.signed_view(bits).clone()
    cur = C.widen(C.unsigned_view(sv[idx]))
    sv[idx] = C.signed_view(C.narrow((cur & keep) | (val << mbits), bits.dtype))
    return C.unsigned_view(sv)


def decode_bits(ct: C.CompressedTensor, fused: bool = True) -> torch.Tensor:
    """Fused decode to the FLAT container bit stream (length n_elements)."""
    if not fused:
        return twostage.decode_to_bits(ct)
    chunk = ct.chunk
    rows = ct.n_padded // chunk
    packed2 = ct.packed.reshape(rows, chunk // 2)
    a2 = ct.sign_mantissa.reshape(rows, chunk)
    if ct.layout == "chunked" and ct.cap <= MAX_FUSED_CAP:
        # fully fused: the kernel applies the sparse correction and emits
        # final bits; the clipped per-row counts bound its slot loop
        cnt = torch.clamp(ct.esc_count, max=ct.cap).to(torch.int32)
        bits2 = splitzip_decode.decode_fused(
            packed2, a2, ct.esc_pos, ct.esc_val, cnt.reshape(rows, 1),
            tuple(ct.exponents), fmt=ct.fmt, chunk=chunk)
        return bits2.reshape(-1)[:ct.n_elements]
    bits2 = splitzip_decode.decode_dense(packed2, a2, tuple(ct.exponents),
                                         fmt=ct.fmt, chunk=chunk)
    return _patch_escape_bits(bits2.reshape(-1), ct)[:ct.n_elements]


def decode(ct: C.CompressedTensor, fused: bool = True) -> torch.Tensor:
    """SplitZip decode with the single-launch fused kernel."""
    bits = decode_bits(ct, fused=fused)
    return C.from_bits(bits.reshape(ct.shape), C.dtype_from_name(ct.dtype))
