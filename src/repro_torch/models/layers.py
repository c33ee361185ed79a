"""Transformer layers on PyTorch: RMSNorm, RoPE, chunked (flash-style)
attention, prefill attention (the flash-attention kernel on the card),
decode attention, GQA blocks, SwiGLU MLP.

The port of ``repro.models.layers`` (dense path).  Layouts are the JAX
package's — activations ``(B, S, D)``, heads ``(B, S, H, hd)``, projection
weights ``(D, H, hd)`` / ``(H, hd, D)`` — and so are the dtypes: bf16
activations and weights, f32 softmax statistics and accumulators.  A
"bf16 x bf16 -> f32" product (JAX's ``preferred_element_type=f32``) is
computed as an f32 matmul of the bf16 values, which is exact per product.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as FA

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotated by position; positions broadcast to (..., S)."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(d, theta), dtype=torch.float32,
                            device=x.device)
    angles = positions[..., None].float() * freqs                   # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                           # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def chunked_attention(
    q: torch.Tensor,                 # (B, Sq, H, D)
    k: torch.Tensor,                 # (B, Skv, Hkv, D)
    v: torch.Tensor,                 # (B, Skv, Hkv, Dv)
    *,
    causal: bool,
    q_offset: int = 0,               # absolute position of q[0]
    window: Optional[int] = None,    # sliding-window width (None = full)
    kv_block: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Memory-efficient attention: an online-softmax loop over KV blocks
    (f32 m/l/acc), never materialising Sq x Skv scores."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    kv_block = min(kv_block, skv)
    dev = q.device
    # (B, Hkv, G, Sq, D) f32 view of q: one matmul per block and head group
    qg = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).float()
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32, device=dev)
    for start in range(0, skv, kv_block):
        stop = min(start + kv_block, skv)
        k_blk = k[:, start:stop].permute(0, 2, 1, 3).float()[:, :, None]  # (B,Hkv,1,K,D)
        v_blk = v[:, start:stop].permute(0, 2, 1, 3)[:, :, None]          # (B,Hkv,1,K,Dv)
        k_pos = torch.arange(start, stop, device=dev)
        s = torch.matmul(qg, k_blk.transpose(-1, -2)) * scale             # (B,Hkv,G,Sq,K)
        mask = torch.ones((sq, stop - start), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(mask, s, torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p.to(v.dtype).float(), v_blk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)                       # (B,Hkv,G,Sq,Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      kv_block: int = 1024) -> torch.Tensor:
    """Prefill attention of every attention layer.

    On the card: the hand-written flash-attention kernel
    (``kernels.flash_attention``), which keeps ``p`` in f32 for ``p . v``;
    it has no sliding window, so ``window`` raises there.  On the CPU:
    :func:`chunked_attention`, the function the JAX prefill computes on
    every backend (``p`` rounded to bf16)."""
    if q.device.type == "cuda":
        if window is not None:
            raise NotImplementedError("prefill attention on the card has no "
                                      "sliding window")
        return FA.flash_attention(q, k, v, causal=causal)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             kv_block=kv_block)


def decode_attention(
    q: torch.Tensor,                 # (B, 1, H, D)
    k_cache: torch.Tensor,           # (B, S, Hkv, D)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,         # (B,) valid prefix length
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention over the full cache (one pass; no blocking)."""
    b, sq, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    qg = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).float()      # (B,Hkv,G,Sq,D)
    kf = k_cache.permute(0, 2, 1, 3).float()[:, :, None]                # (B,Hkv,1,S,D)
    sc = torch.matmul(qg, kf.transpose(-1, -2)) * scale                 # (B,Hkv,G,Sq,S)
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < cache_len[:, None]                           # (B, S)
    if window is not None:
        valid &= pos[None, :] >= (cache_len[:, None] - window)
    sc = torch.where(valid[:, None, None, None, :], sc,
                     torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(sc, dim=-1)
    vf = v_cache.permute(0, 2, 1, 3).float()[:, :, None]                # (B,Hkv,1,S,Dv)
    out = torch.matmul(p.to(v_cache.dtype).float(), vf)                 # (B,Hkv,G,Sq,Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------

def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bsd,dhk->bshk'."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def attention_qkv(p, x, positions, theta):
    q = apply_rope(_proj_in(x, p["wq"]), positions, theta)
    k = apply_rope(_proj_in(x, p["wk"]), positions, theta)
    v = _proj_in(x, p["wv"])
    return q, k, v


def attention_out(p, o):
    """'bshk,hkd->bsd'."""
    h, k, d = p["wo"].shape
    return torch.matmul(o.reshape(*o.shape[:-2], h * k), p["wo"].reshape(h * k, d))


def full_attention_block(p, x, positions, theta, *, causal=True, window=None,
                         kv_block=1024):
    q, k, v = attention_qkv(p, x, positions, theta)
    o = prefill_attention(q, k, v, causal=causal, window=window, kv_block=kv_block)
    return attention_out(p, o), (k, v)


def decode_attention_block(p, x, cache_k, cache_v, cache_len, theta, *,
                           window=None):
    """x: (B, 1, D); writes the new k/v at ``cache_len`` IN PLACE into
    ``cache_k``/``cache_v`` (B, S, Hkv, hd) and attends over prefix + self.

    As JAX's ``dynamic_update_slice``, a write position past the end is
    clamped to the last slot."""
    positions = cache_len[:, None]          # new token position == current length
    q, k, v = attention_qkv(p, x, positions, theta)
    b, s = cache_k.shape[:2]
    rows = torch.arange(b, device=x.device)
    idx = torch.clamp(cache_len, max=s - 1).to(torch.int64)
    cache_k[rows, idx] = k[:, 0]
    cache_v[rows, idx] = v[:, 0]
    o = decode_attention(q, cache_k, cache_v, cache_len + 1, window=window)
    return attention_out(p, o), (cache_k, cache_v)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp(p, x):
    g = torch.matmul(x, p["w_gate"])
    u = torch.matmul(x, p["w_up"])
    return torch.matmul(F.silu(g) * u, p["w_down"])
