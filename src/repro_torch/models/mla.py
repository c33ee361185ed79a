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

Under tensor parallelism (``mla_prefill(tp=)``, training and serving's
prefill) the latents are whole on every rank and the heads split as the
policy's ``mla_b`` / ``heads_first`` specs say (:func:`_mla_prefill_tp`);
serving's decode under ``tp`` (:func:`mla_decode_tp`) runs the absorbed
form over a rank's span of the latent cache, whose positions split over
``model`` as the policy's cache specs say.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models.layers import (NEG_INF, apply_rope, attention_out,
                                       chunked_attention, prefill_attention,
                                       rms_norm)


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


def _down(x, w, width: int, tp=None):
    """``x @ w`` (B, S, ``width``), whole.  Under ``tp`` with ``width``
    split over ``model`` (``ff_col``), ``w`` holds this rank's columns and
    the product's parts are gathered: the output is normed over its whole
    width, so the port gathers the product, never the parameter."""
    if tp is None or not tp.splits(width):
        return torch.matmul(x, w)
    return TP.gather(torch.matmul(TP.region(x, tp), w), tp, -1)


def q_latent(p, x, cfg: MLAConfig, tp=None):
    """The normed query latent (B, S, q_lora_rank)."""
    return rms_norm(_down(x, p["wq_a"], cfg.q_lora_rank, tp), p["q_norm"])


def _q_heads(p, q_lat, positions, cfg: MLAConfig, theta: float):
    q = _heads_in(q_lat, p["wq_b"])
    q_nope = q[..., : cfg.qk_nope_head_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], positions, theta)
    return q_nope, q_rope


def queries(p, x, positions, cfg: MLAConfig, theta: float):
    """(q_nope, q_rope), each (B, S, H, ·); rope applied to q_rope."""
    return _q_heads(p, q_latent(p, x, cfg), positions, cfg, theta)


def latent_kv(p, x, positions, cfg: MLAConfig, theta: float, tp=None):
    """(c_kv (B, S, kv_lora_rank), k_rope (B, S, rope)): the cache entries.
    Under ``tp`` a column-split ``wkv_a``'s product is gathered."""
    kv = _down(x, p["wkv_a"], cfg.kv_lora_rank + cfg.qk_rope_head_dim, tp)
    return _kv_latents(p, kv, positions, cfg, theta)


def _kv_latents(p, kv, positions, cfg: MLAConfig, theta: float):
    """The cache entries of the whole ``wkv_a`` product ``kv``."""
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


def _expand(p, c_kv, k_rope, cfg: MLAConfig):
    """Per-head keys (nope and the shared rope part) and values of the
    latent, for the heads ``p["wkv_b"]`` holds."""
    b, s, _ = c_kv.shape
    h = p["wkv_b"].shape[1]
    kv = _heads_in(c_kv, p["wkv_b"])
    k_nope = kv[..., : cfg.qk_nope_head_dim]
    v = kv[..., cfg.qk_nope_head_dim:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h,
                                                        cfg.qk_rope_head_dim)],
                  dim=-1)
    return k, v


def mla_prefill(p, x, positions, cfg: MLAConfig, theta: float,
                kv_block: int = 1024, attention=prefill_attention, tp=None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention through ``attention`` (prefill's, or
    ``chunked_attention`` in training); returns (out, (c_kv, k_rope))
    latent cache.  Under ``tp`` the attention runs on this rank's shards
    (:func:`_mla_prefill_tp`), through the same ``attention``."""
    if tp is not None:
        return _mla_prefill_tp(p, x, positions, cfg, theta, kv_block, tp,
                               attention)
    q_nope, q_rope = queries(p, x, positions, cfg, theta)
    c_kv, k_rope = latent_kv(p, x, positions, cfg, theta)
    k, v = _expand(p, c_kv, k_rope, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = attention(q, k, v, causal=True, kv_block=kv_block)
    return _heads_out(o, p["wo"]), (c_kv, k_rope)


def _mla_prefill_tp(p, x, positions, cfg: MLAConfig, theta: float,
                    kv_block: int, tp, attention=chunked_attention):
    """MLA under tensor parallelism: the latents whole on every rank
    (``wq_a`` / ``wkv_a`` column-split products gathered), then the
    attention case (``tp.attention``; MLA's KV heads are its heads):
    ``heads``, the rank's heads of ``wq_b`` / ``wkv_b`` and rows of
    ``wo``, the parts summed; ``seq``, the replicated weights on the
    rank's block of query positions over the keys up to its end
    (``q_offset``), the blocks gathered before ``wo``; ``none``,
    replicated.  ``attention`` is training's ``chunked_attention`` or
    serving's ``prefill_attention`` (the flash kernel on the card)."""
    s = x.shape[1]
    case = tp.attention(s)
    q_lat = q_latent(p, x, cfg, tp)
    c_kv, k_rope = latent_kv(p, x, positions, cfg, theta, tp)
    if case != "none":
        q_lat, c_kv, k_rope = (TP.region(t, tp) for t in (q_lat, c_kv, k_rope))
    rows = tp.block(s) if case == "seq" else slice(0, s)
    q_nope, q_rope = _q_heads(p, q_lat[:, rows], positions[:, rows], cfg, theta)
    k, v = _expand(p, c_kv[:, :rows.stop], k_rope[:, :rows.stop], cfg)
    o = attention(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=True,
                  q_offset=rows.start, kv_block=kv_block)
    if case == "seq":
        o = TP.gather(o, tp, 1)
    out = attention_out(p, o, tp if case == "heads" else None)
    return out, (c_kv, k_rope)


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
    ctx_lat = latent_attention(q_lat, q_rope, cache_ckv, cache_krope,
                               cache_len + 1, mla_scale(cfg))
    return latent_out(p, ctx_lat, w_v), (cache_ckv, cache_krope)


def _latent_scores(q_lat, q_rope, ckv, krope, start: int, n_valid, scale):
    """The f32 scores (B, 1, H, S_r) of absorbed queries over latent cache
    positions ``start ..``, those at or past ``n_valid`` (B,) masked."""
    sc = (torch.einsum("bqhr,bsr->bqhs", q_lat, ckv)
          + torch.einsum("bqhp,bsp->bqhs", q_rope, krope)).float() * scale
    pos = start + torch.arange(ckv.shape[1], device=ckv.device)
    valid = pos[None, :] < n_valid[:, None]
    return torch.where(valid[:, None, None, :], sc,
                       torch.tensor(NEG_INF, device=ckv.device))


def latent_attention(q_lat, q_rope, ckv, krope, n_valid, scale):
    """The absorbed attention over a whole latent cache, the positions
    below ``n_valid`` (B,) valid: the f32 softmax, ``p`` rounded to
    ``ckv``'s dtype, ``p . ckv`` in it (B, 1, H, r)."""
    prob = torch.softmax(_latent_scores(q_lat, q_rope, ckv, krope, 0,
                                        n_valid, scale), dim=-1)
    return torch.einsum("bqhs,bsr->bqhr", prob.to(ckv.dtype), ckv)


def _down_pair(p, x, cfg: MLAConfig, tp):
    """The ``wq_a`` and ``wkv_a`` products of ``x``, whole.  Where both
    split over ``model`` the rank's columns of the two go out in one
    all-gather (the bits of two: each column is the same product), which
    halves a decode step's collectives for them."""
    qr, kvw = cfg.q_lora_rank, cfg.kv_lora_rank + cfg.qk_rope_head_dim
    if not (tp.splits(qr) and tp.splits(kvw)):
        return _down(x, p["wq_a"], qr, tp), _down(x, p["wkv_a"], kvw, tp)
    xr = TP.region(x, tp)
    both = torch.cat([torch.matmul(xr, p["wq_a"]), torch.matmul(xr, p["wkv_a"])],
                     dim=-1)
    lead = x.shape[:-1]
    parts = TP.gather(both, tp, -1).reshape(*lead, tp.size, -1)
    nq = qr // tp.size
    return (parts[..., :nq].reshape(*lead, qr),
            parts[..., nq:].reshape(*lead, kvw))


def latent_partials(q_lat, q_rope, ckv, krope, start: int, n_valid, scale):
    """The absorbed attention of queries (B, 1, H, r) / (B, 1, H, p) over
    one span of latent cache positions ``start ..`` (``ckv`` (B, S_r, r),
    ``krope`` (B, S_r, p)), the positions below ``n_valid`` (B,) valid:
    the f32 running max (B, 1, H), sum (B, 1, H) and unnormalised latent
    accumulator (B, 1, H, r), ``p`` rounded to ``ckv``'s dtype before
    ``p . ckv`` (f32 inputs: not rounded)."""
    sc = _latent_scores(q_lat, q_rope, ckv, krope, start, n_valid, scale)
    m = sc.amax(dim=-1)
    pr = torch.exp(sc - m[..., None])
    acc = torch.einsum("bqhs,bsr->bqhr", pr.to(ckv.dtype).float(), ckv.float())
    return m, pr.sum(dim=-1), acc


def mla_decode_tp(p, x, cache_ckv, cache_krope, cache_len, cfg: MLAConfig,
                  theta: float, tp, *, max_seq: int):
    """One token's absorbed MLA decode under ``tp`` over a latent cache
    whose positions split over ``model`` (the policy's cache layout): x
    (B, 1, D) whole on every model rank; ``cache_ckv`` (B, |span|, r) /
    ``cache_krope`` (B, |span|, p) this rank's block of a ``max_seq``-slot
    cache (``tensor_parallel.cache_span``; all ``max_seq`` slots where it
    does not split).  :func:`mla_decode` on the whole:

    * the ``wq_a`` / ``wkv_a`` products whole on every rank (the split
      columns in one all-gather, :func:`_down_pair`), so the new latents
      ``c_new`` / ``kr_new`` are whole on every rank;
    * the rank whose span holds slot ``cache_len`` of a row writes it there
      IN PLACE (past the end: the last slot, as ``dynamic_update_slice``
      clamps, the last rank's);
    * each rank forms the absorbed query ``q_lat`` (B, 1, H_r, r) and
      ``q_rope`` of its own heads (``wq_b`` / ``wkv_b`` split by heads);
      where the cache splits, one all-gather over ``model`` makes them
      whole, each rank scores every head over its span at ``pos <
      cache_len + 1`` (:func:`latent_partials`), and the partials merge in
      rank order (``tensor_parallel.merge_partials``); a cache replicated
      over ``model`` is attended whole, the rank's heads only, as
      :func:`mla_decode` does;
    * the rank keeps its heads' latent context, applies its ``w_v`` and
      its rows of ``wo`` (``row_product``: the parts summed over
      ``model``).  Where the heads do not split the weights are
      replicated, every rank computes every head and the output is whole.

    Rounding points that differ from JAX's ``mla_decode``: JAX normalises
    the f32 softmax over all keys, rounds ``p`` to bf16 and rounds ``p .
    ckv`` to bf16; a split cache rounds each rank's unnormalised ``exp(s -
    m_rank)`` to bf16, accumulates ``p . ckv`` in f32, merges in f32 and
    rounds the latent context once.  The ``wo`` product is the f32 sum of
    the ranks' parts rounded once, where JAX rounds one bf16 product.
    Returns (B, 1, D) and the cache blocks."""
    b = x.shape[0]
    positions = cache_len[:, None]
    q_down, kv = _down_pair(p, x, cfg, tp)
    q_nope, q_rope = _q_heads(p, rms_norm(q_down, p["q_norm"]), positions,
                              cfg, theta)
    c_new, kr_new = _kv_latents(p, kv, positions, cfg, theta)
    span = TP.cache_span(tp, max_seq)
    idx = torch.clamp(cache_len, max=max_seq - 1).to(torch.int64)
    TP.write_slot(cache_ckv, idx, span, c_new[:, 0])
    TP.write_slot(cache_krope, idx, span, kr_new[:, 0])
    q_lat, w_v = absorbed_query(p, q_nope, cfg)
    split = tp.splits(tp.heads)
    scale = mla_scale(cfg)
    if span.stop - span.start == max_seq:
        ctx = latent_attention(q_lat, q_rope, cache_ckv, cache_krope,
                               cache_len + 1, scale)
    else:
        hl, r = q_lat.shape[2], q_lat.shape[3]
        qa, qra = q_lat, q_rope
        if split:
            both = TP.gather(torch.cat([q_lat, q_rope], dim=-1), tp, 2)
            qa, qra = both[..., :r], both[..., r:]
        m, l, acc = latent_partials(qa, qra, cache_ckv, cache_krope,
                                    span.start, cache_len + 1, scale)
        ctx = TP.merge_partials(m, l, acc, tp).to(x.dtype)
        if split:
            ctx = ctx[:, :, tp.rank * hl:(tp.rank + 1) * hl]
    o = torch.einsum("bqhr,rhv->bqhv", ctx, w_v)
    if split:
        return attention_out(p, o, tp), (cache_ckv, cache_krope)
    return _heads_out(o, p["wo"]), (cache_ckv, cache_krope)
