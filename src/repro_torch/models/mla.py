"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style), the port of
``repro.models.mla``.

The KV cache is the *compressed latent*: per token only
(kv_lora_rank + qk_rope_head_dim) values, which is what crosses the PD
boundary and what SplitZip compresses.

Prefill uses the expanded form (latent -> per-head K/V, prefill attention
with a value width that differs from the query/key width).  Decode uses the
**absorbed form**: the k_nope projection is folded into the query and the v
projection into the output, so a step costs O(S · kv_lora_rank) instead of
re-expanding the whole cache.  Layouts and bf16 rounding points follow the
JAX package: every einsum there is a bf16 x bf16 -> bf16 product here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.models.layers import NEG_INF, apply_rope, prefill_attention, rms_norm


def init_mla(normal, ones, n_layers: int, d_model: int, num_heads: int,
             cfg: MLAConfig) -> dict:
    """Layer-stacked MLA parameters with ``repro.models.mla.init_mla``'s
    shapes and scales; ``normal(shape, scale)`` and ``ones(shape)`` make
    the tensors."""
    nl = n_layers
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    s = d_model ** -0.5
    return {
        "wq_a": normal((nl, d_model, cfg.q_lora_rank), s),
        "q_norm": ones((nl, cfg.q_lora_rank)),
        "wq_b": normal((nl, cfg.q_lora_rank, num_heads, qk_dim),
                       cfg.q_lora_rank ** -0.5),
        "wkv_a": normal((nl, d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim), s),
        "kv_norm": ones((nl, cfg.kv_lora_rank)),
        "wkv_b": normal((nl, cfg.kv_lora_rank, num_heads,
                         cfg.qk_nope_head_dim + cfg.v_head_dim),
                        cfg.kv_lora_rank ** -0.5),
        "wo": normal((nl, num_heads, cfg.v_head_dim, d_model),
                     (num_heads * cfg.v_head_dim) ** -0.5),
    }


def _heads_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bsr,rhk->bshk'."""
    r, h, k = w.shape
    return torch.matmul(x, w.reshape(r, h * k)).reshape(*x.shape[:-1], h, k)


def _heads_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bshv,hvd->bsd'."""
    h, v, d = w.shape
    return torch.matmul(o.reshape(*o.shape[:-2], h * v), w.reshape(h * v, d))


def queries(p, x, positions, cfg: MLAConfig, theta: float):
    """(q_nope, q_rope), each (B, S, H, ·); rope applied to q_rope."""
    q_lat = rms_norm(torch.matmul(x, p["wq_a"]), p["q_norm"])
    q = _heads_in(q_lat, p["wq_b"])
    q_nope = q[..., : cfg.qk_nope_head_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], positions, theta)
    return q_nope, q_rope


def latent_kv(p, x, positions, cfg: MLAConfig, theta: float):
    """(c_kv (B, S, kv_lora_rank), k_rope (B, S, rope)): the cache entries."""
    kv = torch.matmul(x, p["wkv_a"])
    c_kv = rms_norm(kv[..., : cfg.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(kv[..., cfg.kv_lora_rank:][:, :, None, :], positions,
                        theta)[:, :, 0, :]
    return c_kv, k_rope


def absorbed_query(p, q_nope, cfg: MLAConfig):
    """'bqhn,rhn->bqhr': the query in latent space, and the value
    up-projection ``w_v`` (r, H, v) applied after attention."""
    w_knope = p["wkv_b"][..., : cfg.qk_nope_head_dim]            # (r, H, n)
    w_v = p["wkv_b"][..., cfg.qk_nope_head_dim:]                 # (r, H, v)
    return torch.einsum("bqhn,rhn->bqhr", q_nope, w_knope), w_v


def latent_out(p, ctx_lat, w_v):
    """Latent context (B, q, H, r) -> layer output (B, q, D)."""
    o = torch.einsum("bqhr,rhv->bqhv", ctx_lat, w_v)
    return _heads_out(o, p["wo"])


def mla_scale(cfg: MLAConfig) -> float:
    return 1.0 / np.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def mla_prefill(p, x, positions, cfg: MLAConfig, theta: float,
                kv_block: int = 1024) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention; returns (out, (c_kv, k_rope)) latent cache."""
    b, s, _ = x.shape
    h = p["wq_b"].shape[1]
    q_nope, q_rope = queries(p, x, positions, cfg, theta)
    c_kv, k_rope = latent_kv(p, x, positions, cfg, theta)
    kv = _heads_in(c_kv, p["wkv_b"])
    k_nope = kv[..., : cfg.qk_nope_head_dim]
    v = kv[..., cfg.qk_nope_head_dim:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h,
                                                        cfg.qk_rope_head_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = prefill_attention(q, k, v, causal=True, kv_block=kv_block)
    return _heads_out(o, p["wo"]), (c_kv, k_rope)


def mla_decode(p, x, cache_ckv, cache_krope, cache_len, cfg: MLAConfig,
               theta: float) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Absorbed-form decode over the raw latent cache.

    x: (B, 1, D); cache_ckv: (B, S, r); cache_krope: (B, S, p).  The new
    latent entries are written INTO the caches at ``cache_len`` (clamped to
    the last slot, as JAX's ``dynamic_update_slice``)."""
    b = x.shape[0]
    positions = cache_len[:, None]
    q_nope, q_rope = queries(p, x, positions, cfg, theta)        # (B,1,H,·)
    c_new, kr_new = latent_kv(p, x, positions, cfg, theta)       # (B,1,r/p)
    s_len = cache_ckv.shape[1]
    rows = torch.arange(b, device=x.device)
    idx = torch.clamp(cache_len, max=s_len - 1).to(torch.int64)
    cache_ckv[rows, idx] = c_new[:, 0]
    cache_krope[rows, idx] = kr_new[:, 0]

    q_lat, w_v = absorbed_query(p, q_nope, cfg)
    sc = (torch.einsum("bqhr,bsr->bqhs", q_lat, cache_ckv)
          + torch.einsum("bqhp,bsp->bqhs", q_rope, cache_krope)).float()
    sc = sc * mla_scale(cfg)
    valid = torch.arange(s_len, device=x.device)[None, :] < (cache_len + 1)[:, None]
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.tensor(NEG_INF, device=x.device))
    prob = torch.softmax(sc, dim=-1)
    ctx_lat = torch.einsum("bqhs,bsr->bqhr", prob.to(cache_ckv.dtype), cache_ckv)
    return latent_out(p, ctx_lat, w_v), (cache_ckv, cache_krope)
