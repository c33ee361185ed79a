"""Dense GQA and MLA models on PyTorch: the port of ``repro.models.model``
(dense and mla families).

Parameters are a plain nested dict stacked over layers, with the JAX
package's shapes and init scales, so ``models/weights.params_from_jax`` maps
one package's parameters onto the other's.  The layer stack is a Python loop
(the JAX package scans it).

Public API: init_params / forward / prefill / decode_step /
resident_decode_step / make_inputs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import kvpool as KVP
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models.kvcache import DecodeState, require_dense


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Seeded random parameters with ``repro.models.model.init_params``'s
    shapes and scales (normal * scale in f32, stored bf16), stacked over
    layers.  The numbers come from ``generator`` (on its own device) and
    land on ``device`` (default: the generator's)."""
    require_dense(cfg)
    device = device if device is not None else generator.device
    nl, d, h, hkv, hd, dff = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim, cfg.d_ff)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * scale
        return x.to(device=device, dtype=torch.bfloat16)

    def ones(shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=device)

    s = d ** -0.5
    p: Dict = {"embed": normal((cfg.vocab_size, d), 0.02), "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, cfg.vocab_size), 0.02)
    if cfg.mla is not None:
        attn = MLA.init_mla(normal, ones, nl, d, h, cfg.mla)
    else:
        attn = {
            "wq": normal((nl, d, h, hd), s),
            "wk": normal((nl, d, hkv, hd), s),
            "wv": normal((nl, d, hkv, hd), s),
            "wo": normal((nl, h, hd, d), s),
        }
    p["layers"] = {
        "norm1": ones((nl, d)),
        "norm2": ones((nl, d)),
        "attn": attn,
        "ffn": {
            "w_gate": normal((nl, d, dff), s),
            "w_up": normal((nl, d, dff), s),
            "w_down": normal((nl, dff, d), dff ** -0.5),
        },
    }
    return p


def layer_params(stacked: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the layer-stacked parameter dict."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def lm_logits(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].t())
    return torch.matmul(x, params["lm_head"])


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def forward(params, batch: Dict, cfg: ArchConfig, *, kv_block: int = 1024,
            collect_cache: bool = False, logits_positions: str = "all"):
    """Full-sequence forward.  Returns (logits, cache_or_None, aux_loss).

    ``logits_positions='last'`` projects only the final position through the
    LM head (prefill needs just the first sampled token)."""
    require_dense(cfg)
    x = params["embed"][batch["tokens"]]
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        if cfg.mla is not None:
            attn_out, (k, v) = MLA.mla_prefill(lp["attn"], h, positions, cfg.mla,
                                               cfg.rope_theta, kv_block=kv_block)
        else:
            q, k, v = L.attention_qkv(lp["attn"], h, positions, cfg.rope_theta)
            o = L.chunked_attention(q, k, v, causal=True, kv_block=kv_block)
            attn_out = L.attention_out(lp["attn"], o)
        x = x + attn_out
        h2 = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + L.mlp(lp["ffn"], h2)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    if logits_positions == "last":
        x = x[:, -1:]
    cache = None
    if collect_cache:
        names = ("ckv", "krope") if cfg.mla is not None else ("k", "v")
        cache = {names[0]: torch.stack(ks), names[1]: torch.stack(vs)}
    return lm_logits(params, x, cfg), cache, torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(params, batch: Dict, cfg: ArchConfig, *, max_seq: Optional[int] = None,
            kv_block: int = 1024) -> Tuple[torch.Tensor, DecodeState]:
    """Run the full prompt; return (last-position logits, decode state).

    The cache is padded with zeros to ``max_seq`` slots so decode can
    continue in place.  Ragged batches: ``batch["lengths"]`` (B,) marks each
    row's true prompt length (rows right-padded to a common S); last-token
    logits are gathered at ``lengths - 1`` and ``cache_len`` starts at
    ``lengths``."""
    lengths = batch.get("lengths")
    logits, cache, _ = forward(
        params, batch, cfg, kv_block=kv_block, collect_cache=True,
        logits_positions="all" if lengths is not None else "last")
    b, s = batch["tokens"].shape
    max_seq = max_seq or s
    if max_seq > s:   # (L, B, S, ...): pad S
        cache = {k: F.pad(v, (0, 0) * (v.dim() - 3) + (0, max_seq - s))
                 for k, v in cache.items()}
    dev = logits.device
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        last = logits[torch.arange(b, device=dev), (lengths - 1).to(torch.int64)]
        return last, DecodeState(cache=cache, cache_len=lengths)
    return logits[:, -1], DecodeState(
        cache=cache, cache_len=torch.full((b,), s, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def decode_step(params, tokens: torch.Tensor, state: DecodeState,
                cfg: ArchConfig) -> Tuple[torch.Tensor, DecodeState]:
    """One autoregressive step.  tokens: (B, 1) int -> logits (B, V).

    The new k/v (MLA: ckv/krope) are written INTO ``state.cache`` (in place,
    saving a copy of the cache per step); the returned state shares that
    cache and advances ``cache_len``."""
    require_dense(cfg)
    x = params["embed"][tokens]
    cache_len = state.cache_len
    mla = cfg.mla is not None
    c0, c1 = (state.cache["ckv"], state.cache["krope"]) if mla else \
        (state.cache["k"], state.cache["v"])
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        if mla:
            out, _ = MLA.mla_decode(lp["attn"], h, c0[i], c1[i], cache_len,
                                    cfg.mla, cfg.rope_theta)
        else:
            out, _ = L.decode_attention_block(lp["attn"], h, c0[i], c1[i],
                                              cache_len, cfg.rope_theta)
        y = x + out
        h2 = L.rms_norm(y, lp["norm2"], cfg.norm_eps)
        x = y + L.mlp(lp["ffn"], h2)
    logits = lm_logits(params, x, cfg)[:, -1]
    return logits, DecodeState(cache=state.cache, cache_len=cache_len + 1)


def resident_decode_step(params, tokens: torch.Tensor,
                         state: KVP.ResidentState, cfg: ArchConfig
                         ) -> Tuple[torch.Tensor, KVP.ResidentState]:
    """One autoregressive step over a compressed-resident cache.

    The prefix lives as SplitZip pages, read by one paged-attention kernel
    launch per layer; the step appends the new token to the raw tail pages
    IN PLACE and advances ``cache_len``.  The pools themselves are read-only
    here: tail flushes are host-side between steps
    (``KVPool.flush_full_tails``).  Dense GQA and MLA families."""
    require_dense(cfg)
    g = state.geom
    x = params["embed"][tokens]
    cache_len = state.cache_len
    mla = cfg.mla is not None
    l0, l1 = (state.leaves["ckv"], state.leaves["krope"]) if mla else \
        (state.leaves["k"], state.leaves["v"])
    s0, s1 = l0.streams(), l1.streams()
    fmt = g.leaf("ckv" if mla else "k").fmt
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        if mla:
            out, _ = KVP.paged_mla_decode(
                lp["attn"], h, s0, s1, l0.page_table[i], l1.page_table[i],
                l0.tail[i], l1.tail[i], cache_len, cfg.mla, cfg.rope_theta,
                geom=g, fmt=fmt)
        else:
            out, _ = KVP.paged_decode_attention_block(
                lp["attn"], h, s0, s1, l0.page_table[i], l1.page_table[i],
                l0.tail[i], l1.tail[i], cache_len, cfg.rope_theta, geom=g,
                fmt=fmt)
        y = x + out
        h2 = L.rms_norm(y, lp["norm2"], cfg.norm_eps)
        x = y + L.mlp(lp["ffn"], h2)
    logits = lm_logits(params, x, cfg)[:, -1]
    return logits, KVP.ResidentState(leaves=state.leaves,
                                     cache_len=cache_len + 1, geom=g)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_inputs(cfg: ArchConfig, shape: ShapeConfig, generator: torch.Generator,
                batch: Optional[int] = None, seq: Optional[int] = None,
                device=None) -> Dict:
    """Random token batch ``{"tokens", "labels"}`` (B, S) from ``generator``."""
    b = batch or shape.global_batch
    s = seq or shape.seq_len
    device = device if device is not None else generator.device

    def ids():
        return torch.randint(0, cfg.vocab_size, (b, s), generator=generator,
                             device=generator.device).to(device)

    return {"tokens": ids(), "labels": ids()}
