"""Prefill flash attention: the wrapper of ``csrc/flash_attention.cu`` and its
plain version (the port of ``repro.kernels.flash_attention``).

``flash_attention`` is causal or non-causal multi-head attention with grouped
KV heads (query head ``h`` reads KV head ``h // (H // Hkv)``), a value
width that may differ from the query/key width (MLA prefill) and an optional
sliding window: with ``window`` a query at ``q_pos`` sees only keys with
``q_pos - k_pos < window``, the mask of the JAX models' ``chunked_attention``
(recurrentgemma's local attention).  It is what
prefill attention runs on the card in every attention layer of the port's
models (``models/layers.prefill_attention``).

Arithmetic, the TPU kernel's: q, k and v in f32, masked scores ``-1e30``, an
online softmax over KV blocks with f32 ``m``, ``l`` and ``acc``, ``p`` kept
in f32 for ``p . v``, and ``acc / max(l, 1e-30)`` cast once to ``q.dtype``.
The JAX models' ``chunked_attention`` (and the port's, which prefill keeps
on the CPU) rounds ``p`` to bf16 before ``p . v``; the JAX package holds the
two within 3e-2 (``tests/test_flash_attention.py``).

The wrapper launches a kernel for CUDA operands and runs
:func:`flash_attention_ref` only for CPU operands; anything else raises, as
does an argument the kernels do not take.  Which of the two kernels runs
depends only on the dtype and the head widths (:func:`tensor_core_path`):
bf16 operands whose ``d`` and ``dv`` are multiples of 16 go to the
tensor-core kernel (``sz_flash_attention_tc``: wgmma, TMA-fed tiles),
everything else (f32, or a bf16 width that is not a multiple of 16) to the
CUDA-core kernel (``sz_flash_attention``).  ``flash_attention.launches``
counts every launch, ``flash_attention.launches_tc`` the tensor-core ones
and ``flash_attention.launches_causal`` the causal ones.  Under the dry
run's abstract run (:mod:`repro_torch.core.abstract`) fake operands get a
fake output of the kernel's shape and dtype and the kernel's work
(:func:`hbm_bytes`, :func:`flops`) credited to the run; nothing launches.

The causal mask places query row ``i`` at position ``i``: it is aligned to
the start of the keys, not to their end, so with Sq < Skv a row sees keys
``0..i``.  A block of queries that starts later (the tensor-parallel
``seq`` case: positions ``[start, stop)`` over keys ``[0, stop)``) is
attended through ``models.layers.prefill_attention(q_offset=start)``,
which puts ``start`` zero rows before the block and drops their outputs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core import abstract as AB
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
    "sz_flash_attention": [_I, _P, _P, _P, _P] + [_L] * 9 + [_I] * 9
                          + [ctypes.c_float, _P],
    "sz_flash_attention_tc": [_P, _P, _P, _P] + [_L] * 9 + [_I] * 9
                             + [ctypes.c_float, _P],
}
#: the tensor-core kernel's k-step (wgmma K for bf16): d and dv must be
#: multiples of it
TC_WIDTH_STEP = 16


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


def _check_window(window, sq: int, skv: int) -> int:
    """``window`` as the kernels' argument (0: none).  Raises unless it is
    None or a positive int, or if some query would see no key at all
    (``Sq >= Skv + window``): such a row has no softmax."""
    if window is None:
        return 0
    if isinstance(window, bool) or not isinstance(window, int) or window < 1:
        raise ValueError(f"window={window!r}: expected None or an int >= 1")
    if sq >= skv + window:
        raise ValueError(f"window={window}: queries past Skv + window - 1 = "
                         f"{skv + window - 1} see no key")
    return window


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None,
                        blk_k: int = DEFAULT_BLK_K) -> torch.Tensor:
    """What the TPU ``_kernel`` computes, in PyTorch, with the window mask
    of ``chunked_attention``: KV blocks of ``blk_k`` in order, every query
    row at once.  A row whose block lies wholly above the causal diagonal
    gets ``p = 0`` and ``corr = 1`` there, exactly what skipping the block
    gives (its running max is finite from block 0 on).  A row whose blocks
    lie wholly below its window scores ``p = exp(0) = 1`` there (its running
    max is still ``-1e30``); the first key it sees rescales ``l`` and
    ``acc`` by ``exp(-1e30 - m) = 0`` exactly, which is what skipping those
    blocks, as the kernels do, gives."""
    b, sq, skv, h, hkv, d, dv = _shapes(q, k, v)
    _check_window(window, sq, skv)
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
        k_pos = torch.arange(start, stop, device=dev)
        seen = torch.ones((sq, stop - start), dtype=torch.bool, device=dev)
        if causal:
            seen &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            seen &= (q_pos[:, None] - k_pos[None, :]) < window
        if causal or window is not None:
            s = torch.where(seen, s, torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def tensor_core_path(dtype: torch.dtype, d: int, dv: int) -> bool:
    """True when ``flash_attention`` takes the tensor-core kernel: bf16
    operands whose ``d`` and ``dv`` are multiples of 16.  f32 operands keep
    the CUDA-core kernel (exact to f32 rounding), as do bf16 widths the
    wgmma k-step does not divide."""
    return (dtype == torch.bfloat16 and d % TC_WIDTH_STEP == 0
            and dv % TC_WIDTH_STEP == 0)


def _tma_operand(t: torch.Tensor):
    """``t`` and its element strides over (B, S, heads) as a tensor map
    takes them: a copy only if the base or a stride of an axis longer than
    1 is not a 16-byte multiple (or is 0, an expanded axis); the stride of
    an axis of length 1 is never stepped and is passed as 8."""
    def fits(x):
        return all(st > 0 and st % 8 == 0 for st, n in
                   zip(x.stride()[:3], x.shape[:3]) if n > 1)
    if t.data_ptr() % 16 or not fits(t):
        t = t.contiguous()
    return t, [st if n > 1 else 8 for st, n in zip(t.stride()[:3], t.shape[:3])]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, d), k (B, Skv, Hkv, d), v (B, Skv, Hkv, dv), bf16 or f32
    -> (B, Sq, H, dv) in ``q.dtype``.  ``window`` (None: full) keeps the
    keys with ``q_pos - k_pos < window``; each kernel then loads only the
    key tiles its query block sees.

    CUDA operands launch one of two kernels, chosen by dtype and widths
    alone (:func:`tensor_core_path`):

    * bf16 with ``d`` and ``dv`` multiples of 16: ``sz_flash_attention_tc``
      (wgmma on the tensor cores, tiles fed by TMA).  Operands are read
      through their strides over (B, S, H); one whose base or strides are
      not 16-byte multiples, or that has an expanded (zero-stride) axis, is
      copied contiguous first.
    * otherwise (f32, or bf16 widths that are not multiples of 16):
      ``sz_flash_attention`` on the f32 CUDA cores, which reads any strides
      over (B, S, H), an expanded head axis through its zero stride.

    Either way an operand is made contiguous over the head dimension only
    if it is not.

    Neither kernel has a backward: under grad, with an operand that
    requires it, the wrapper raises (on either device) instead of
    returning an output no gradient flows through.  Training computes
    attention with ``models.layers.chunked_attention``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: call it under torch.no_grad() "
            "or on tensors that do not require grad (training attends "
            "through models.layers.chunked_attention)")
    b, sq, skv, h, hkv, d, dv = _shapes(q, k, v)
    win = _check_window(window, sq, skv)
    scale = float(scale if scale is not None else 1.0 / np.sqrt(d))
    abstract = AB.on_card(q, k, v)
    if not abstract and not build.on_cuda(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.dtype not in DTYPE_ID:
        raise TypeError(f"flash_attention takes bf16 or f32, got {q.dtype}")
    if not (0 < d <= MAX_HEAD_DIM and 0 < dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims d={d}, dv={dv}: the kernel takes 1 to "
                         f"{MAX_HEAD_DIM}")
    if skv < 1 or b * h > 65535:
        raise ValueError(f"Skv={skv}, B*H={b * h}: the kernel needs Skv >= 1 "
                         "and B*H <= 65535")
    if abstract:
        AB.credit("flash_attention",
                  hbm_bytes(b, sq, skv, h, hkv, d, dv, q.element_size()),
                  flops(b, sq, skv, h, d, dv, causal=causal, window=window))
        return torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    lib = _lib()
    tc = tensor_core_path(q.dtype, d, dv)
    with torch.cuda.device(q.device):
        if tc:
            (q, qs), (k, ks), (v, vs) = (_tma_operand(t) for t in (q, k, v))
            err = lib.sz_flash_attention_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *qs, *ks, *vs, b, sq, skv, h, hkv, d, dv, int(bool(causal)),
                win, scale, build.stream_of(q))
        else:
            err = lib.sz_flash_attention(
                DTYPE_ID[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], b, sq, skv, h, hkv, d, dv, int(bool(causal)),
                win, scale, build.stream_of(q))
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_tc += int(tc)
    flash_attention.launches_causal += int(bool(causal))
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_causal = 0


# ---------------------------------------------------------------------------
# the work it must do (the TPU module's analytic counts)
# ---------------------------------------------------------------------------

def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs inside a sliding ``window``: query ``i`` sees keys
    ``max(0, i - window + 1)`` to ``min(i, Skv - 1)`` (causal) or to
    ``Skv - 1``."""
    i = np.arange(sq, dtype=np.int64)
    lo = np.maximum(0, i - window + 1)
    hi = np.minimum(i + 1, skv) if causal else np.full(sq, skv, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def hbm_bytes(b, sq, skv, h, hkv, d, dv, bytes_per_el=2) -> int:
    """Analytic HBM traffic of the fused kernel: q + k + v + o only.  At
    Sq = Skv a window does not shrink it: every key is inside its own
    query's window."""
    return bytes_per_el * (b * sq * h * d + b * skv * hkv * (d + dv)
                           + b * sq * h * dv)


def flops(b, sq, skv, h, d, dv, causal=True, window=None) -> float:
    """2 matmuls; causal ≈ half the S² area; with a window, exactly the
    pairs inside it (:func:`visible_pairs`)."""
    if window is not None:
        return 2.0 * b * h * visible_pairs(sq, skv, causal, window) * (d + dv)
    area = sq * skv * (0.5 if causal else 1.0)
    return 2.0 * b * h * area * (d + dv)
