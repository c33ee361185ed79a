"""Transformer layers on PyTorch: RMSNorm, RoPE, chunked (flash-style)
attention, prefill attention (the flash-attention kernel on the card),
decode attention, GQA blocks, SwiGLU MLP.

The port of ``repro.models.layers`` (dense path).  Layouts are the JAX
package's — activations ``(B, S, D)``, heads ``(B, S, H, hd)``, projection
weights ``(D, H, hd)`` / ``(H, hd, D)`` — and so are the dtypes: bf16
activations and weights, f32 softmax statistics and accumulators.  A
"bf16 x bf16 -> f32" product (JAX's ``preferred_element_type=f32``) is
computed as an f32 matmul of the bf16 values, which is exact per product.

Under tensor parallelism (``tp``, a
:class:`~repro_torch.distributed.tensor_parallel.TensorParallel`) the
weights are a rank's shards: :func:`attention_tp` runs the attention
block in each of the context's attention cases, :func:`attention_out` and
:func:`mlp` take row-split ``wo`` / ``w_down`` and sum their f32 products
over ``model``.  Serving under ``tp``: :func:`attention_tp` also returns
the K and V its case leaves on the rank, which the prefill reshards into
the cache's sequence split, and :func:`decode_attention_tp` attends one
token over a rank's block of such a cache.  Without ``tp`` nothing
changes.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import abstract as AB
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import flash_attention as FA

NEG_INF = -1e30

# the knobs of the dry run's attention variants (``attn_overrides``)
_ATTN_OVERRIDES: dict = {}


@contextlib.contextmanager
def attn_overrides(score_dtype=None, kv_block=None):
    """The JAX ``attn_overrides``: inside it :func:`chunked_attention`
    computes its scores in ``score_dtype`` (bf16: the scores and ``p``
    rounded to bf16, ``m``, ``l`` and ``acc`` kept in f32) and walks keys
    in blocks of ``kv_block``, whatever its caller passes.  The knobs act
    on the plain chunked path, where the JAX ones act on the XLA path; the
    flash kernel keeps ``p`` in f32 and its own tiles, so prefill attention
    on the card refuses them (:func:`prefill_attention`)."""
    global _ATTN_OVERRIDES
    prev = _ATTN_OVERRIDES
    _ATTN_OVERRIDES = {k: v for k, v in dict(score_dtype=score_dtype,
                                             kv_block=kv_block).items()
                       if v is not None}
    try:
        yield
    finally:
        _ATTN_OVERRIDES = prev


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's path: a CUDA tensor, or a fake one
    under the dry run's abstract run of the card."""
    return t.device.type == "cuda" or AB.on_card(t)


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
    score_dtype = _ATTN_OVERRIDES.get("score_dtype", torch.float32)
    kv_block = min(_ATTN_OVERRIDES.get("kv_block", kv_block), skv)
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
        s = torch.matmul(qg, k_blk.transpose(-1, -2))                     # (B,Hkv,G,Sq,K)
        s = s.to(score_dtype) * scale
        mask = torch.ones((sq, stop - start), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=score_dtype,
                                              device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1).float())
        p = torch.exp(s - m_new.to(score_dtype)[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, dtype=torch.float32)
        pv = torch.matmul(p.to(v.dtype).float(), v_blk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)                       # (B,Hkv,G,Sq,Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset: int = 0,
                      window: Optional[int] = None,
                      kv_block: int = 1024) -> torch.Tensor:
    """Prefill attention of every attention layer.

    On the card: the hand-written flash-attention kernel
    (``kernels.flash_attention``), which keeps ``p`` in f32 for ``p . v``
    and takes the sliding ``window`` (recurrentgemma's local attention)
    itself.  On the CPU: :func:`chunked_attention`, the function the JAX
    prefill computes on every backend (``p`` rounded to bf16).

    ``q_offset`` is the absolute position of ``q[:, 0]`` (the tensor-
    parallel ``seq`` case's query block over the keys up to its end).  The
    kernel places query row ``i`` at position ``i`` (its causal mask is
    aligned to the start of the keys), so on the card the block is
    preceded by ``q_offset`` zero rows, whose outputs are dropped: the
    rows kept see exactly their keys, and the zero rows cost their share
    of the kernel's work.  Under :func:`attn_overrides` the card refuses:
    the kernel has neither knob."""
    if on_card(q):
        if _ATTN_OVERRIDES:
            raise NotImplementedError(
                f"attention overrides {sorted(_ATTN_OVERRIDES)} act on the "
                "plain chunked path; the flash kernel keeps p in f32 and its "
                "own KV tiles (trace the attn_* variants on the CPU path)")
        if q_offset:
            q = torch.cat([q.new_zeros((q.shape[0], q_offset) + q.shape[2:]),
                           q], dim=1)
        o = FA.flash_attention(q, k, v, causal=causal, window=window)
        return o[:, q_offset:]
    return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                             window=window, kv_block=kv_block)


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
    return (q,) + attention_kv(p, x, positions, theta)


def attention_kv(p, x, positions, theta):
    """The keys (roped) and values of ``x`` at ``positions``."""
    return (apply_rope(_proj_in(x, p["wk"]), positions, theta),
            _proj_in(x, p["wv"]))


def attention_out(p, o, tp=None):
    """'bshk,hkd->bsd'.  Under ``tp``, ``o`` holds this rank's heads and
    ``p["wo"]`` their rows: the parts are summed over ``model``."""
    h, k, d = p["wo"].shape
    o, wo = o.reshape(*o.shape[:-2], h * k), p["wo"].reshape(h * k, d)
    if tp is not None:
        return TP.row_product(o, wo, tp)
    return torch.matmul(o, wo)


def attention_tp(p, x, positions, theta, tp, *, causal=True, window=None,
                 kv_block=1024, attention=chunked_attention):
    """One GQA attention block's output (B, S, D), whole on every model
    rank, and ``(case, k, v)``, from this rank's shards of ``p`` under
    ``tp``, attending through ``attention`` (training's
    :func:`chunked_attention` by default, serving prefill's
    :func:`prefill_attention`; a sliding ``window`` in every case, the
    ``seq`` block's keeping its absolute positions):

    * ``heads``: the rank's query heads and their KV heads;
    * ``kv``: the rank's query heads; K/V from the replicated ``wk`` /
      ``wv``, whole, then the KV head each query head reads
      (``h // (H / Hkv)``);
    * ``seq``: the replicated weights; the rank's block of query positions
      over the keys up to the block's end (all keys when not causal), the
      blocks gathered over ``model`` before the whole ``wo``;
    * ``none``: the whole block on every rank.

    ``k`` and ``v`` are what the case left on the rank (the rank's KV
    heads; every head; every head up to the query block's end; every
    head), which a prefill reshards into its cache."""
    s = x.shape[1]
    case = tp.attention(s)
    if case == "none":
        q, k, v = attention_qkv(p, x, positions, theta)
        o = attention(q, k, v, causal=causal, window=window,
                      kv_block=kv_block)
        out = attention_out(p, o)
    elif case == "seq":
        xf = TP.region(x, tp)
        blk = tp.block(s)
        end = blk.stop if causal else s
        q = apply_rope(_proj_in(xf[:, blk], p["wq"]), positions[:, blk], theta)
        k = apply_rope(_proj_in(xf[:, :end], p["wk"]), positions[:, :end], theta)
        v = _proj_in(xf[:, :end], p["wv"])
        o = attention(q, k, v, causal=causal, q_offset=blk.start,
                      window=window, kv_block=kv_block)
        out = attention_out(p, TP.gather(o, tp, 1))
    else:
        q, k, v = attention_qkv(p, TP.region(x, tp), positions, theta)
        ka, va = k, v
        if case == "kv":
            hl = q.shape[2]
            idx = (tp.rank * hl + torch.arange(hl, device=x.device)) \
                // (tp.heads // tp.kv_heads)
            ka, va = k[:, :, idx], v[:, :, idx]
        o = attention(q, ka, va, causal=causal, window=window,
                      kv_block=kv_block)
        out = attention_out(p, o, tp)
    return out, (case, k, v)


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


def decode_attention_tp(p, x, cache_k, cache_v, cache_len, theta, tp, *,
                        max_seq: int, window=None):
    """One token's GQA attention block under ``tp`` over a cache whose
    positions split over ``model`` (the policy's cache layout): x (B, 1,
    D) whole on every model rank; ``cache_k`` / ``cache_v`` this rank's
    block (B, |span|, Hkv, hd) of a ``max_seq``-slot cache, every KV head
    (``tensor_parallel.cache_span``; all ``max_seq`` slots where
    ``max_seq`` does not split).  The JAX ``decode_attention_block`` on
    the whole:

    * q (B, 1, H, hd) and the new token's k and v are made whole on every
      rank: the rank's heads gathered over ``model`` (case ``heads``: q,
      k and v in one all-gather; ``kv``: q, with k and v from the
      replicated weights; ``none``: all from the replicated weights);
    * the rank whose span holds slot ``cache_len`` of a row writes it there
      IN PLACE (past the end: the last slot, ``dynamic_update_slice``'s
      clamp, the last rank's);
    * each rank attends its keys at ``pos < cache_len + 1`` (and inside the
      ``window``) with f32 running max, sum and accumulator (``p`` rounded
      to bf16 before ``p . v``, as :func:`chunked_attention` does), and the
      partials are merged in rank order (``tensor_parallel.merge_partials``);
      a cache replicated over ``model`` is attended whole
      (:func:`decode_attention`);
    * the rank's heads go through its rows of ``wo`` (``row_product``); in
      case ``none`` the whole ``wo``.

    Returns (B, 1, D) and the cache blocks."""
    case = tp.attention(1)
    positions = cache_len[:, None]
    q, k, v = attention_qkv(p, x, positions, theta)
    if case == "heads":
        hq, hk = q.shape[2], k.shape[2]
        parts = TP.gather(torch.cat([q, k, v], dim=2), tp, 2)
        per = hq + 2 * hk
        ranks = [parts[:, :, r * per:(r + 1) * per] for r in range(tp.size)]
        q = torch.cat([t[:, :, :hq] for t in ranks], dim=2)
        k = torch.cat([t[:, :, hq:hq + hk] for t in ranks], dim=2)
        v = torch.cat([t[:, :, hq + hk:] for t in ranks], dim=2)
    elif case == "kv":
        q = TP.gather(q, tp, 2)
    span = TP.cache_span(tp, max_seq)
    b = x.shape[0]
    idx = torch.clamp(cache_len, max=max_seq - 1).to(torch.int64)
    TP.write_slot(cache_k, idx, span, k[:, 0])
    TP.write_slot(cache_v, idx, span, v[:, 0])
    if span.stop - span.start == max_seq:
        o = decode_attention(q, cache_k, cache_v, cache_len + 1, window=window)
    else:
        h, d = q.shape[2], q.shape[3]
        hkv, dv = cache_k.shape[2], cache_v.shape[-1]
        qg = q.reshape(b, 1, hkv, h // hkv, d).permute(0, 2, 3, 1, 4).float()
        kf = cache_k.permute(0, 2, 1, 3).float()[:, :, None]
        sc = torch.matmul(qg, kf.transpose(-1, -2)) / np.sqrt(d)   # (B,Hkv,G,1,S)
        pos = span.start + torch.arange(span.stop - span.start, device=x.device)
        n = cache_len[:, None] + 1
        valid = pos[None, :] < n
        if window is not None:
            valid &= pos[None, :] >= n - window
        sc = torch.where(valid[:, None, None, None, :], sc,
                         torch.tensor(NEG_INF, device=x.device))
        m = sc.amax(dim=-1)
        pr = torch.exp(sc - m[..., None])
        acc = torch.matmul(pr.to(cache_v.dtype).float(),
                           cache_v.permute(0, 2, 1, 3).float()[:, :, None])
        o = TP.merge_partials(m, pr.sum(dim=-1), acc, tp)
        o = o.permute(0, 3, 1, 2, 4).reshape(b, 1, h, dv).to(q.dtype)
    if case == "none":
        return attention_out(p, o), (cache_k, cache_v)
    hl = p["wo"].shape[0]
    mine_h = o[:, :, tp.rank * hl:(tp.rank + 1) * hl]
    return attention_out(p, mine_h, tp), (cache_k, cache_v)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp(p, x, tp=None):
    """SwiGLU.  Under ``tp`` the weights are this rank's columns of
    ``w_gate`` / ``w_up`` and rows of ``w_down`` (d_ff split over
    ``model``): the parts are summed over ``model``."""
    if tp is not None:
        x = TP.region(x, tp)
    g = torch.matmul(x, p["w_gate"])
    u = torch.matmul(x, p["w_up"])
    if tp is not None:
        return TP.row_product(F.silu(g) * u, p["w_down"], tp)
    return torch.matmul(F.silu(g) * u, p["w_down"])
