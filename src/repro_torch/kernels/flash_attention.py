"""Prefill flash attention: the wrapper of ``csrc/flash_attention.cu`` and its
plain version (the port of ``repro.kernels.flash_attention``).

``flash_attention`` is causal or non-causal multi-head attention with grouped
KV heads (query head ``h`` reads KV head ``h // (H // Hkv)``) and a value
width that may differ from the query/key width (MLA prefill).  It is what
prefill attention runs on the card in every attention layer of the port's
models (``models/layers.prefill_attention``).

Arithmetic, the TPU kernel's: q, k and v in f32, masked scores ``-1e30``, an
online softmax over KV blocks with f32 ``m``, ``l`` and ``acc``, ``p`` kept
in f32 for ``p . v``, and ``acc / max(l, 1e-30)`` cast once to ``q.dtype``.
The JAX models' ``chunked_attention`` (and the port's, which prefill keeps
on the CPU) rounds ``p`` to bf16 before ``p . v``; the JAX package holds the
two within 3e-2 (``tests/test_flash_attention.py``).

The wrapper launches the kernel for CUDA operands and runs
:func:`flash_attention_ref` only for CPU operands; anything else raises, as
does an argument the kernel does not take.  ``flash_attention.launches``
counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
#: the TPU kernel's default KV block, the plain version's: its result does
#: not depend on the block size beyond f32 rounding
DEFAULT_BLK_K = 512
#: widest ``d`` and ``dv`` the kernel takes (its tiles live in shared memory)
MAX_HEAD_DIM = 256
#: the kernel's ``dtype`` argument
DTYPE_ID = {torch.bfloat16: 0, torch.float32: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PROTOTYPES = {
    "sz_flash_attention": [_I, _P, _P, _P, _P] + [_L] * 9 + [_I] * 8
                          + [ctypes.c_float, _P],
}


def _lib():
    return build.library("flash_attention", _PROTOTYPES)


def _shapes(q, k, v):
    """(B, Sq, Skv, H, Hkv, d, dv) of consistent operands; raises otherwise."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, head_dim)")
    b, sq, h, d = q.shape
    bk, skv, hkv, dk = k.shape
    if (bk, skv, hkv) != tuple(v.shape[:3]) or bk != b or dk != d:
        raise ValueError(f"inconsistent shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    return b, sq, skv, h, hkv, d, v.shape[-1]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None,
                        blk_k: int = DEFAULT_BLK_K) -> torch.Tensor:
    """What the TPU ``_kernel`` computes, in PyTorch: KV blocks of ``blk_k``
    in order, every query row at once.  A row whose block lies wholly above
    the causal diagonal gets ``p = 0`` and ``corr = 1`` there, exactly what
    skipping the block gives (its running max is finite from block 0 on)."""
    b, sq, skv, h, hkv, d, dv = _shapes(q, k, v)
    g = h // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).float()  # (B,Hkv,G,Sq,D)
    q_pos = torch.arange(sq, device=dev)
    m = torch.full((b, hkv, g, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32, device=dev)
    for start in range(0, skv, blk_k):
        stop = min(start + blk_k, skv)
        kb = k[:, start:stop].permute(0, 2, 1, 3).float()[:, :, None]  # (B,Hkv,1,K,D)
        vb = v[:, start:stop].permute(0, 2, 1, 3).float()[:, :, None]  # (B,Hkv,1,K,Dv)
        s = torch.matmul(qg, kb.transpose(-1, -2)) * scale            # (B,Hkv,G,Sq,K)
        if causal:
            k_pos = torch.arange(start, stop, device=dev)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """q (B, Sq, H, d), k (B, Skv, Hkv, d), v (B, Skv, Hkv, dv), bf16 or f32
    -> (B, Sq, H, dv) in ``q.dtype``.

    CUDA operands launch ``sz_flash_attention``; they may be strided over
    (B, S, H) (an expanded head axis is read through its zero stride) and
    are made contiguous over the head dimension only if they are not."""
    b, sq, skv, h, hkv, d, dv = _shapes(q, k, v)
    scale = float(scale if scale is not None else 1.0 / np.sqrt(d))
    if not build.on_cuda(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.dtype not in DTYPE_ID:
        raise TypeError(f"flash_attention takes bf16 or f32, got {q.dtype}")
    if not (0 < d <= MAX_HEAD_DIM and 0 < dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims d={d}, dv={dv}: the kernel takes 1 to "
                         f"{MAX_HEAD_DIM}")
    if skv < 1 or b * h > 65535:
        raise ValueError(f"Skv={skv}, B*H={b * h}: the kernel needs Skv >= 1 "
                         "and B*H <= 65535")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.sz_flash_attention(
            DTYPE_ID[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            b, sq, skv, h, hkv, d, dv, int(bool(causal)), scale,
            build.stream_of(q))
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# the work it must do (the TPU module's analytic counts)
# ---------------------------------------------------------------------------

def hbm_bytes(b, sq, skv, h, hkv, d, dv, bytes_per_el=2) -> int:
    """Analytic HBM traffic of the fused kernel: q + k + v + o only."""
    return bytes_per_el * (b * sq * h * d + b * skv * hkv * (d + dv)
                           + b * sq * h * dv)


def flops(b, sq, skv, h, d, dv, causal=True) -> float:
    """2 matmuls; causal ≈ half the S² area."""
    area = sq * skv * (0.5 if causal else 1.0)
    return 2.0 * b * h * area * (d + dv)
