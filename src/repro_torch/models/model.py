"""The model families on PyTorch: the port of ``repro.models.model``.

  dense/moe : pre-norm transformer (GQA attention, SwiGLU or MoE FFN)
  mla       : the same with MLA attention (latent KV cache)
  ssm       : Mamba-2 (SSD) blocks
  hybrid    : (rglru, rglru, local_attn) triples + leftover recurrent blocks
  vlm       : the dense backbone behind precomputed patch embeddings
              (``frontend_proj``), prepended to the text tokens
  audio     : encoder-only: non-causal attention over projected frames, no
              cache and no decode step

Parameters are a plain nested dict stacked over layers (triples, extra
blocks), with the JAX package's keys, shapes and init scales, so
``models/weights.params_from_jax`` maps one package's parameters onto the
other's.  The layer stacks are Python loops (the JAX package scans them).

Training (:func:`loss_fn`) computes attention with
``layers.chunked_attention`` under autograd, the function the JAX training
path computes: the flash-attention kernel serves prefill and has no
backward (its wrapper raises under grad).  ``remat=True`` recomputes each
layer (each hybrid triple and extra block) in the backward pass
(``torch.utils.checkpoint``), as the JAX forward checkpoints its scan steps.

``forward(tp=)`` and ``loss_fn(tp=)`` run every family on one rank's
shards under tensor parallelism (``tp``, a
:class:`~repro_torch.distributed.tensor_parallel.TensorParallel`): the
vocab-split embedding and head, the split attention and SwiGLU products,
Mamba-2's split ``in_proj`` / ``out_proj``, the RG-LRU's block of
channels, and the vocab-parallel cross-entropy; the logits ``forward``
returns are then this rank's vocab columns.  Serving under ``tp``
(:func:`prefill`, :func:`decode_step`) runs the dense GQA, MLA, MoE,
Mamba-2 and RG-LRU hybrid families: the prefill attends through the flash
kernel on the rank's heads or query block and leaves each rank its block
of the cache in the policy's layout (the sequence split over ``model``,
``tensor_parallel.prefill_cache_block``); a decode step attends over those
blocks and merges the partials (``layers.decode_attention_tp``, MLA's
absorbed ``mla.mla_decode_tp``); a MoE's FFN runs under ``ep`` (its
routing group and expert split).  The recurrent families' states split
heads, channels or the window's KV heads, never the sequence: a prefill
keeps its block of each final state (Mamba-2's are whole on every rank,
``ssm.state_block``; the RG-LRU's are the block of U a rank runs; the
window as :func:`_triple_fwd` says), and a decode step runs on those
blocks (``ssm.mamba2_decode_tp``, ``rglru.recurrent_block_step_tp``,
:func:`_windowed_decode_tp`).  The front ends serve there too: a vision
prompt's patches go through the column-split ``frontend_proj`` and take
the first positions of the sequence-split cache, after which it decodes
as the dense family does; the encoder-only audio family's prefill returns
the rank's columns of every frame's logits and an empty cache.  Under
``fsdp`` (a ``distributed.fsdp.BlockGather``) serving's parameters are a
rank's FSDP blocks: each layer's (a hybrid triple's, an extra block's)
are gathered over ``data`` just before its products and dropped after,
the embedding's and the head's leaves at their reads (a tied table at
both).

Public API: init_params / embed_inputs / forward / loss_fn / prefill /
decode_step / resident_decode_step / make_inputs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import kvpool as KVP
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.kvcache import (DecodeState, n_triples_extra,
                                        require_decoder, require_dense)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None, place=None) -> Dict:
    """Seeded random parameters with ``repro.models.model.init_params``'s
    shapes and scales (normal * scale in f32, stored bf16), stacked over
    layers.  The numbers come from ``generator`` (on its own device) and
    land on ``device`` (default: the generator's); on ``"meta"`` nothing is
    drawn, so any width plans from shapes alone.  MoE stacks are drawn a
    layer at a time (``models.moe.init_moe``), the router kept in f32; the
    SSM's and the RG-LRU's decay parameters are f32 as in JAX.  A frontend
    family adds ``frontend_proj`` (frontend_dim, d_model).

    ``place(keys, x, layers=None)``, where given, takes each leaf (its
    dict keys, the whole tensor) as soon as it is drawn and returns what
    to keep of it (a rank's block under a sharding policy): the MoE stacks
    go to it a layer at a time (``layers``: the stack's depth, of which
    ``x`` is one layer), so no whole stack is held.  The draws and their
    order do not change."""
    device = device if device is not None else generator.device
    keep = place if place is not None else (lambda keys, x: x)

    def put(keys, tree):
        if isinstance(tree, dict):
            return {k: put(keys + (k,), v) for k, v in tree.items()}
        return keep(keys, tree)
    nl, d, h, hkv, hd, dff = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim, cfg.d_ff)

    def draw(shape, scale):
        if torch.device(device).type == "meta":
            return torch.empty(shape, dtype=torch.float32, device="meta")
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * scale
        return x.to(device=device)

    def normal(shape, scale):
        return draw(shape, scale).to(torch.bfloat16)

    def ones(shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=device)

    p: Dict = {"embed": put(("embed",), normal((cfg.vocab_size, d), 0.02)),
               "final_norm": put(("final_norm",), ones(d))}
    if not cfg.tie_embeddings:
        p["lm_head"] = put(("lm_head",), normal((d, cfg.vocab_size), 0.02))
    if cfg.frontend is not None:
        p["frontend_proj"] = put(("frontend_proj",), normal(
            (cfg.frontend_dim, d), cfg.frontend_dim ** -0.5))
    if cfg.ssm is not None:
        p["layers"] = put(("layers",), {
            "norm1": ones((nl, d)),
            "mixer": SSM.init_mamba2(normal, nl, d, cfg.ssm, device)})
        return p
    if cfg.hybrid is not None:
        p.update(put((), _init_hybrid(normal, ones, cfg, device)))
        return p
    if cfg.mla is not None:
        attn = MLA.init_mla(normal, ones, nl, d, h, cfg.mla)
    else:
        attn = _attention_params(normal, (nl,), d, h, hkv, hd)
    layers = {"norm1": ones((nl, d)), "norm2": ones((nl, d)), "attn": attn}
    p["layers"] = put(("layers",), layers)
    if cfg.moe is not None:
        p["layers"]["ffn"] = MOE.init_moe(draw, nl, d, cfg.moe, device,
                                          place)
    else:
        p["layers"]["ffn"] = put(("layers", "ffn"),
                                 _mlp_params(normal, (nl,), d, dff))
    return p


def _attention_params(normal, lead: tuple, d, h, hkv, hd) -> Dict:
    """GQA projections stacked over ``lead`` (``layers.init_attention``)."""
    s = d ** -0.5
    return {"wq": normal(lead + (d, h, hd), s),
            "wk": normal(lead + (d, hkv, hd), s),
            "wv": normal(lead + (d, hkv, hd), s),
            "wo": normal(lead + (h, hd, d), s)}


def _mlp_params(normal, lead: tuple, d, dff) -> Dict:
    """SwiGLU weights stacked over ``lead`` (``layers.init_mlp``)."""
    return {"w_gate": normal(lead + (d, dff), d ** -0.5),
            "w_up": normal(lead + (d, dff), d ** -0.5),
            "w_down": normal(lead + (dff, d), dff ** -0.5)}


def _init_hybrid(normal, ones, cfg: ArchConfig, device) -> Dict:
    """The ``triples`` tree (the two recurrent blocks of each triple stacked
    (nt, 2, ...), its attention block (nt, ...)) and, for leftover layers,
    the ``extra`` tree (ne, ...), as the JAX package vmaps them."""
    nt, ne = n_triples_extra(cfg)
    d, dff = cfg.d_model, cfg.d_ff
    u, cw = cfg.hybrid.lru_width or d, cfg.hybrid.conv_width

    def recurrent(lead):
        return {"block": RG.init_rglru_block(normal, lead, d, u, cw, device),
                "norm": ones(lead + (d,)), "mlp": _mlp_params(normal, lead, d, dff),
                "norm_mlp": ones(lead + (d,))}

    attn = {"block": _attention_params(normal, (nt,), d, cfg.num_heads,
                                       cfg.num_kv_heads, cfg.head_dim),
            "norm": ones((nt, d)), "mlp": _mlp_params(normal, (nt,), d, dff),
            "norm_mlp": ones((nt, d))}
    out = {"triples": {"rec": recurrent((nt, 2)), "attn": attn}}
    if ne:
        out["extra"] = recurrent((ne,))
    return out


def layer_params(stacked: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the layer-stacked parameter dict."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def ffn(lp: Dict, h: torch.Tensor, cfg: ArchConfig, tp=None, ep=None
        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN: the MoE FFN and its aux loss (under ``ep``, routed
    over the routing group and split by experts; None when ``ep`` gathers
    no balance statistics, in serving), or SwiGLU and None (under ``tp``,
    split over ``model`` where d_ff divides it).  A MoE under ``tp``
    needs ``ep``: its parameters are a rank's expert block."""
    if cfg.moe is not None:
        if tp is not None and ep is None:
            raise ValueError(f"{cfg.name}: the MoE FFN under tp needs ep= "
                             "(distributed.expert_parallel.ExpertParallel): "
                             "a rank holds its expert block, not all "
                             f"{cfg.moe.num_experts} experts")
        return MOE.moe_ffn(lp["ffn"], h, cfg.moe, ep)
    return L.mlp(lp["ffn"], h, _split(tp, cfg.d_ff)), None


def _split(tp, n: int):
    """``tp`` where a dimension of ``n`` splits over ``model``, else None."""
    return tp if tp is not None and tp.splits(n) else None


def _layer(fsdp, lp: Dict, prefix: str) -> Dict:
    """A layer's slice of the stacks under ``prefix`` with its FSDP blocks
    gathered over ``data`` (``fsdp``, a ``distributed.fsdp.BlockGather``;
    None: as held)."""
    return lp if fsdp is None else fsdp.layer(lp, prefix)


def _top(fsdp, params: Dict, *names: str) -> Dict:
    """``params`` with the top-level leaves ``names`` gathered over
    ``data`` in one collective (``fsdp``; None: as held)."""
    return params if fsdp is None else fsdp.top(params, names)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _frontend(params, inputs: torch.Tensor, cfg: ArchConfig, tp=None):
    """Frames or patches through ``frontend_proj`` (under ``tp``, its
    columns split over ``model`` where d_model divides it: the rank's
    columns of the product, gathered whole for the residual stream)."""
    tp = _split(tp, cfg.d_model)
    y = torch.matmul(inputs.to(torch.bfloat16), params["frontend_proj"])
    return y if tp is None else TP.gather(y, tp, -1)


def embed_inputs(params, batch: Dict, cfg: ArchConfig, tp=None,
                 fsdp=None) -> torch.Tensor:
    """(B, S, d_model) bf16 input of the first layer: projected audio frames,
    patch projections prepended to the token embeddings, or the token
    embeddings alone.  Under ``tp`` a vocab-split table is looked up rank
    by rank and summed (``vocab_embedding``; the same bits).  Under
    ``fsdp`` the leaves it reads (``embed``, ``frontend_proj``) are
    gathered over ``data`` first, in one collective."""
    if cfg.frontend == "audio_frames":
        return _frontend(_top(fsdp, params, "frontend_proj"), batch["frames"],
                         cfg, tp)
    params = _top(fsdp, params, "embed", *(
        ("frontend_proj",) if cfg.frontend == "vision_patches" else ()))
    # F.embedding, not indexing: on the card its backward sums a token's
    # rows in f32 and rounds once, where indexing's backward adds them in
    # bf16 and loses much of a frequent token's gradient (Zipf tokens at
    # a full training batch); on the CPU the two are the same bits
    vtp = _split(tp, cfg.vocab_size)
    if vtp is None:
        tok = F.embedding(batch["tokens"], params["embed"])
    else:
        tok = TP.vocab_embedding(batch["tokens"], params["embed"], vtp)
    if cfg.frontend == "vision_patches":
        tok = torch.cat([_frontend(params, batch["patches"], cfg, tp), tok],
                        dim=1)
    return tok


def input_positions(batch: Dict, cfg: ArchConfig) -> int:
    """The number of positions the first layer sees: frames, or the text
    tokens after a vision config's patches."""
    if cfg.frontend == "audio_frames":
        return batch["frames"].shape[1]
    s = batch["tokens"].shape[1]
    return s + batch["patches"].shape[1] if cfg.frontend == "vision_patches" else s


def lm_logits(params, x: torch.Tensor, cfg: ArchConfig, tp=None,
              fsdp=None) -> torch.Tensor:
    """The head's logits; under ``tp`` with the vocab split over ``model``,
    this rank's columns.  Under ``fsdp`` the final norm and the head (a
    tied config's table, gathered again at this read, not held from the
    embedding's) are gathered over ``data`` first, in one collective."""
    params = _top(fsdp, params, "final_norm",
                  "embed" if cfg.tie_embeddings else "lm_head")
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if _split(tp, cfg.vocab_size) is not None:
        x = TP.region(x, tp)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].t())
    return torch.matmul(x, params["lm_head"])


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def forward(params, batch: Dict, cfg: ArchConfig, *, kv_block: int = 1024,
            remat: bool = False, collect_cache: bool = False,
            logits_positions: str = "all", attention=L.prefill_attention,
            tp=None, ep=None, cache_seq: Optional[int] = None, fsdp=None):
    """Full-sequence forward.  Returns (logits, cache_or_None, aux_loss).

    ``logits_positions='last'`` projects only the final position through the
    LM head (prefill needs just the first sampled token).  ``attention`` is
    the attention function of every attention layer (MLA's included):
    ``layers.prefill_attention`` for serving, ``layers.chunked_attention``
    for training.  ``remat`` checkpoints each layer, hybrid triple and extra
    block.  ``tp``: one rank's shards under tensor parallelism (module
    docstring); with ``collect_cache`` (the dense GQA, MLA and MoE
    families) the cache is the rank's blocks of a ``cache_seq``-slot cache
    in the policy's layout (:func:`prefill`); ``ep``: the MoE FFN's expert
    parallelism and routing group; ``fsdp``: each layer's FSDP blocks
    gathered over ``data`` just before its products
    (``distributed.fsdp.BlockGather``), and the embedding's and head's
    leaves at their reads."""
    if tp is not None and collect_cache and cache_seq is None:
        raise ValueError("a cache under tp is cut for cache_seq slots: pass "
                         "it (models.model.prefill does)")
    x = embed_inputs(params, batch, cfg, tp, fsdp)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    aux = torch.zeros((), device=x.device)
    run = _remat if remat else _call
    if cfg.hybrid is not None:
        x, cache = _hybrid_forward(params, x, positions, cfg, kv_block,
                                   collect_cache, attention, run, tp, fsdp)
    elif cfg.ssm is not None:
        x, cache = _ssm_forward(params, x, cfg, collect_cache, run, tp, fsdp)
    else:
        x, cache, aux = _dense_forward(params, x, positions, cfg, kv_block,
                                       collect_cache, attention, run, tp,
                                       ep, cache_seq, fsdp)
    if logits_positions == "last":
        x = x[:, -1:]
    return lm_logits(params, x, cfg, tp, fsdp), cache, aux


def loss_fn(params, batch: Dict, cfg: ArchConfig, *, kv_block: int = 1024,
            remat: bool = True, aux_weight: float = 0.01, tp=None,
            ep=None):
    """Next-token cross-entropy plus ``aux_weight`` times the MoE balance
    loss: ``(total, (ce, aux))``, the arithmetic of
    ``repro.models.model.loss_fn`` (log-softmax in f32, the label
    log-probabilities gathered, their negative mean).  A vision config
    scores its text positions only.  Attention is
    ``layers.chunked_attention``.  Under ``tp`` with the vocab split over
    ``model`` the log-softmax is the vocab-parallel one
    (``tensor_parallel.vocab_log_prob``); under ``ep`` the balance loss is
    the routing group's."""
    logits, _, aux = forward(params, batch, cfg, kv_block=kv_block,
                             remat=remat, attention=L.chunked_attention, tp=tp,
                             ep=ep)
    labels = batch["labels"]
    if cfg.frontend == "vision_patches":
        logits = logits[:, -labels.shape[1]:]
    vtp = _split(tp, cfg.vocab_size)
    if vtp is not None:
        ll = TP.vocab_log_prob(logits, labels, vtp)
    else:
        lp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(lp, -1, labels[..., None].long())[..., 0]
    loss = -torch.mean(ll)
    return loss + aux_weight * aux, (loss, aux)


def _call(fn, *args):
    return fn(*args)


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass."""
    return checkpoint(fn, *args, use_reentrant=False)


def _unstack(stacked: Dict, n: int) -> list:
    """The ``n`` per-layer slices of a layer-stacked parameter dict, cut by
    one ``unbind`` a leaf (its backward is one ``stack``, where ``n``
    separate selects would each write a whole-stack gradient)."""
    cols = {k: _unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
            for k, v in stacked.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _recurrent_fwd(sub, x, cfg: ArchConfig, tp=None):
    """One residual recurrent block + its MLP; returns (x, {"h", "conv"};
    under ``tp`` where the LRU width splits, the rank's block of them)."""
    h = L.rms_norm(x, sub["norm"], cfg.norm_eps)
    out, st = RG.recurrent_block_forward(
        sub["block"], h, tp=_split(tp, cfg.hybrid.lru_width or cfg.d_model))
    x = x + out
    h2 = L.rms_norm(x, sub["norm_mlp"], cfg.norm_eps)
    return x + L.mlp(sub["mlp"], h2, _split(tp, cfg.d_ff)), st


def _triple_fwd(triple, x, positions, cfg: ArchConfig, kv_block: int,
                attention, tp=None, collect: bool = True):
    """One (rglru, rglru, local_attn) triple: (x, the window's keys and
    values (its last ``min(window, S)`` positions), recurrent states).

    Under ``tp`` the attention is ``layers.attention_tp`` (through
    ``attention``: serving prefill's flash kernel), and the window is what
    the policy's ``attn_k`` / ``attn_v`` rule gives a rank, None unless
    ``collect``: case ``heads`` its KV heads, ``kv`` and ``none`` every
    head (the same bits on every rank, from the replicated ``wk`` / ``wv``
    on the whole residual stream); case ``seq`` leaves the window's last
    positions on the last rank only, so every rank recomputes the window's
    K/V from the replicated ``wk`` / ``wv`` (no bytes move, and every
    replica holds the same bits)."""
    rec = []
    for j in range(2):
        x, st = _recurrent_fwd(layer_params(triple["rec"], j), x, cfg, tp)
        rec.append(st)
    ap = triple["attn"]
    h = L.rms_norm(x, ap["norm"], cfg.norm_eps)
    w = min(cfg.hybrid.window, x.shape[1])
    if tp is not None:
        attn_out, (case, k, v) = L.attention_tp(
            ap["block"], h, positions, cfg.rope_theta, tp,
            window=cfg.hybrid.window, kv_block=kv_block, attention=attention)
        if not collect:
            k = v = None
        elif case == "seq":
            k, v = L.attention_kv(ap["block"], h[:, -w:], positions[:, -w:],
                                  cfg.rope_theta)
    else:
        q, k, v = L.attention_qkv(ap["block"], h, positions, cfg.rope_theta)
        o = attention(q, k, v, causal=True, window=cfg.hybrid.window,
                      kv_block=kv_block)
        attn_out = L.attention_out(ap["block"], o)
    if k is not None:
        k, v = k[:, -w:], v[:, -w:]
    x = x + attn_out
    h2 = L.rms_norm(x, ap["norm_mlp"], cfg.norm_eps)
    return x + L.mlp(ap["mlp"], h2, _split(tp, cfg.d_ff)), k, v, rec


def _hybrid_forward(params, x, positions, cfg: ArchConfig, kv_block: int,
                    collect_cache: bool, attention, run, tp=None, fsdp=None):
    """The (rglru, rglru, local_attn) triples, then the extra blocks.  The
    cache keeps each triple's last ``min(window, S)`` keys and values;
    under ``tp`` each leaf is the rank's block (``_triple_fwd``; the
    recurrent states the block of U channels a rank runs, where U
    splits)."""
    nt, ne = n_triples_extra(cfg)
    caches = []
    for triple in _unstack(params["triples"], nt):
        x, k, v, rec = run(_triple_fwd, _layer(fsdp, triple, "triples"), x,
                           positions, cfg, kv_block, attention, tp,
                           collect_cache)
        if collect_cache:
            caches.append({"attn_k": k, "attn_v": v,
                           "rec_h": torch.stack([r["h"] for r in rec]),
                           "rec_conv": torch.stack([r["conv"] for r in rec])})
    extra = []
    for block in _unstack(params["extra"], ne) if ne else ():
        x, st = run(_recurrent_fwd, _layer(fsdp, block, "extra"), x, cfg, tp)
        extra.append(st)
    if not collect_cache:
        return x, None
    cache = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    b, u = x.shape[0], cfg.hybrid.lru_width or cfg.d_model
    if _split(tp, u) is not None:
        u //= tp.size
    if extra:
        cache["extra_h"] = torch.stack([e["h"] for e in extra])
        cache["extra_conv"] = torch.stack([e["conv"] for e in extra])
    else:
        cache["extra_h"] = torch.zeros((0, b, u), dtype=torch.float32,
                                       device=x.device)
        cache["extra_conv"] = torch.zeros(
            (0, b, cfg.hybrid.conv_width - 1, u), dtype=x.dtype, device=x.device)
    return x, cache


def _ssm_layer(lp, x, cfg: ArchConfig, tp=None):
    h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
    out, st = SSM.mamba2_forward(lp["mixer"], h, cfg.ssm, cfg.d_model, tp=tp)
    return x + out, st


def _ssm_forward(params, x, cfg: ArchConfig, collect_cache: bool, run,
                 tp=None, fsdp=None):
    """The Mamba-2 layers; the cache is their final (ssm, conv) states
    (under ``tp`` whole on every rank, of which each keeps its block:
    ``ssm.state_block``)."""
    ssms, convs = [], []
    for lp in _unstack(params["layers"], cfg.num_layers):
        x, st = run(_ssm_layer, _layer(fsdp, lp, "layers"), x, cfg, tp)
        if collect_cache:
            if tp is not None:
                st = SSM.state_block(st, cfg.ssm, cfg.d_model, tp)
            ssms.append(st.ssm)
            convs.append(st.conv)
    if not collect_cache:
        return x, None
    return x, {"ssm": torch.stack(ssms), "conv": torch.stack(convs)}


def _dense_layer(lp, x, positions, cfg: ArchConfig, kv_block: int, attention,
                 tp=None, ep=None, cache_seq=None):
    """One transformer layer: (x, the cache entries k/v or ckv/krope, the
    MoE aux loss or None; under ``tp`` the rank's blocks of a
    ``cache_seq``-slot cache, or no cache entries without ``cache_seq``)."""
    h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
    k = v = None
    if cfg.mla is not None:
        attn_out, (k, v) = MLA.mla_prefill(lp["attn"], h, positions, cfg.mla,
                                           cfg.rope_theta, kv_block=kv_block,
                                           attention=attention, tp=tp)
        if tp is not None and cache_seq is not None:
            s = x.shape[1]
            k, v = (TP.prefill_cache_block(t, tp.attention(s), tp, s,
                                           cache_seq) for t in (k, v))
    elif tp is not None and cache_seq is not None:
        attn_out, (case, k, v) = L.attention_tp(
            lp["attn"], h, positions, cfg.rope_theta, tp,
            causal=not cfg.encoder_only, kv_block=kv_block,
            attention=attention)
        s = x.shape[1]
        k, v = (TP.prefill_cache_block(t, case, tp, s, cache_seq)
                for t in (k, v))
    elif tp is not None:
        attn_out, _ = L.attention_tp(lp["attn"], h, positions, cfg.rope_theta, tp,
                                  causal=not cfg.encoder_only,
                                  kv_block=kv_block, attention=attention)
    else:
        q, k, v = L.attention_qkv(lp["attn"], h, positions, cfg.rope_theta)
        o = attention(q, k, v, causal=not cfg.encoder_only, kv_block=kv_block)
        attn_out = L.attention_out(lp["attn"], o)
    x = x + attn_out
    h2 = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
    ffn_out, layer_aux = ffn(lp, h2, cfg, tp, ep)
    return x + ffn_out, k, v, layer_aux


def _dense_forward(params, x, positions, cfg: ArchConfig, kv_block: int,
                   collect_cache: bool, attention, run, tp=None, ep=None,
                   cache_seq=None, fsdp=None):
    ks, vs = [], []
    aux = torch.zeros((), device=x.device)
    for lp in _unstack(params["layers"], cfg.num_layers):
        x, k, v, layer_aux = run(_dense_layer, _layer(fsdp, lp, "layers"), x,
                                 positions, cfg, kv_block, attention, tp, ep,
                                 cache_seq if collect_cache else None)
        if layer_aux is not None:
            aux = aux + layer_aux
        if collect_cache:
            ks.append(k)
            vs.append(v)
    cache = None
    if collect_cache:
        names = ("ckv", "krope") if cfg.mla is not None else ("k", "v")
        cache = {names[0]: torch.stack(ks), names[1]: torch.stack(vs)}
    return x, cache, aux


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def require_tp_serving(cfg: ArchConfig) -> None:
    """The one gate of sharded serving (prefill and decode under ``tp``).
    It refuses nothing now: every family serves sharded, the dense GQA,
    MLA, MoE, Mamba-2 and RG-LRU hybrid families and both front ends (a
    vision prompt's patches before its tokens; the encoder-only audio
    family's prefill alone, whose cache is empty)."""


def _prompt_shape(batch: Dict, cfg: ArchConfig) -> Tuple[int, int]:
    """(rows, cache positions) of a prompt (:func:`input_positions`)."""
    rows = batch["frames" if cfg.frontend == "audio_frames" else "tokens"]
    return rows.shape[0], input_positions(batch, cfg)


def prefill(params, batch: Dict, cfg: ArchConfig, *, max_seq: Optional[int] = None,
            kv_block: int = 1024, tp=None, ep=None, fsdp=None
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Run the full prompt; return (last-position logits, decode state).

    The cache of the positional families (dense, MoE, MLA, vlm) is padded
    with zeros to ``max_seq`` slots so decode can continue in place; the
    recurrent families' state (ssm, hybrid) does not grow and is never
    padded.  A vision prompt's S counts its ``frontend_len`` patches before
    the tokens.  An encoder-only config returns the logits of every frame
    (B, S, V) and an empty cache of length S.  Ragged batches:
    ``batch["lengths"]`` (B,) marks each row's true prompt length (rows
    right-padded to a common S); last-token logits are gathered at
    ``lengths - 1`` and ``cache_len`` starts at ``lengths``.  The recurrent
    and the frontend families reject ragged input.

    Under ``tp`` (:func:`require_tp_serving`) the parameters are a rank's
    shards and ``batch`` the rank's rows: the logits are the rank's vocab
    columns (where the vocab splits) and the cache is the rank's blocks,
    every KV head or the whole latent over its span of ``max_seq``
    (``tensor_parallel.cache_span``; a vision prompt's span counts its
    patches first), zeros past the prompt, or a recurrent family's state
    blocks (module docstring); a MoE's FFN runs under ``ep`` (its routing
    group's batch, its expert block).  An encoder-only config collects no
    cache there either: it returns the rank's columns of every frame's
    logits (B, S, V_rank) and an empty cache of length S.  Under ``fsdp``
    the parameters are a rank's FSDP blocks, each layer's gathered over
    ``data`` just before its products (:func:`forward`)."""
    lengths = batch.get("lengths")
    if tp is not None:
        require_tp_serving(cfg)
        if lengths is not None:
            raise ValueError("ragged prefill (batch['lengths']) under tp is "
                             "not ported")
        b, s = _prompt_shape(batch, cfg)
        if cfg.encoder_only:
            logits, _, _ = forward(params, batch, cfg, kv_block=kv_block,
                                   logits_positions="all", tp=tp, ep=ep,
                                   fsdp=fsdp)
            return logits, DecodeState(
                cache={}, cache_len=torch.full((b,), s, dtype=torch.int32,
                                               device=logits.device))
        logits, cache, _ = forward(params, batch, cfg, kv_block=kv_block,
                                   collect_cache=True, logits_positions="last",
                                   tp=tp, ep=ep, cache_seq=max_seq or s,
                                   fsdp=fsdp)
        return logits[:, -1], DecodeState(
            cache=cache, cache_len=torch.full((b,), s, dtype=torch.int32,
                                              device=logits.device))
    recurrent = cfg.ssm is not None or cfg.hybrid is not None
    if lengths is not None:
        if recurrent:
            raise ValueError(
                f"{cfg.name}: ragged prefill (batch['lengths']) needs a "
                "cache-positional family (dense/mla); recurrent state absorbs "
                "right-padding")
        if cfg.frontend is not None or cfg.encoder_only:
            raise ValueError("ragged prefill is token-decoder only")
    logits, cache, _ = forward(
        params, batch, cfg, kv_block=kv_block, collect_cache=True,
        logits_positions="all" if (cfg.encoder_only or lengths is not None)
        else "last", fsdp=fsdp)
    b, s = _prompt_shape(batch, cfg)
    dev = logits.device
    if cfg.encoder_only:
        return logits, DecodeState(
            cache={}, cache_len=torch.full((b,), s, dtype=torch.int32,
                                           device=dev))
    max_seq = max_seq or s
    if max_seq > s and not recurrent:   # (L, B, S, ...): pad S
        cache = {k: F.pad(v, (0, 0) * (v.dim() - 3) + (0, max_seq - s))
                 for k, v in cache.items()}
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        last = logits[torch.arange(b, device=dev), (lengths - 1).to(torch.int64)]
        return last, DecodeState(cache=cache, cache_len=lengths)
    return logits[:, -1], DecodeState(
        cache=cache, cache_len=torch.full((b,), s, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _windowed_decode(ap, x, k_cache, v_cache, cache_len, cfg: ArchConfig):
    """Sliding-window decode with a right-aligned shift-insert cache: the new
    key and value enter at the right end and the oldest slot drops out; the
    last ``min(cache_len + 1, w)`` slots are attended."""
    q, k, v = L.attention_qkv(ap, x, cache_len[:, None], cfg.rope_theta)
    k_cache = torch.cat([k_cache[:, 1:], k], dim=1)
    v_cache = torch.cat([v_cache[:, 1:], v], dim=1)
    o = _window_attention(q, k_cache, v_cache, cache_len)
    return L.attention_out(ap, o), k_cache, v_cache


def _window_attention(q, k_cache, v_cache, cache_len):
    """q (B, 1, H, d) over the last ``min(cache_len + 1, w)`` slots of a
    right-aligned window (B, w, Hkv, d): f32 scores and softmax, ``p``
    rounded to the cache's dtype before ``p . v``."""
    w = k_cache.shape[1]
    n_valid = torch.clamp(cache_len + 1, max=w)                       # (B,)
    mask = torch.arange(w, device=q.device)[None, :] >= (w - n_valid)[:, None]
    b, _, h, dq = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, dq).float()                      # (B,Hkv,G,d)
    sc = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) / np.sqrt(dq)
    sc = torch.where(mask[:, None, None, :], sc,
                     torch.tensor(L.NEG_INF, device=q.device))
    p_ = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p_.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, 1, h, dq).to(q.dtype)


def _windowed_decode_tp(ap, x, k_cache, v_cache, cache_len, cfg: ArchConfig,
                        tp):
    """:func:`_windowed_decode` on this rank's shards and window block (the
    policy's ``attn_k`` / ``attn_v`` rule: the KV heads over ``model``
    where they split, else the whole window on every rank), by the decode
    attention case (``tp.attention(1)``):

    * ``heads``: the rank's query heads and KV heads; the new K/V
      shift-insert into its block of the window;
    * ``kv``: the rank's query heads; the new K/V from the replicated
      ``wk`` / ``wv``, whole (the same bits on every rank), shift-inserted
      into the whole window, of which each query head reads its KV head;
    * ``none``: the whole step on every rank (every weight replicated).

    In the first two ``wo`` is a row product over the rank's heads (f32
    products summed over ``model`` in rank order, rounded once: a
    reduce-scatter and an all-gather into ``tp.fwd``); nothing else
    moves."""
    case = tp.attention(1)
    if case == "none":
        return _windowed_decode(ap, x, k_cache, v_cache, cache_len, cfg)
    q, k, v = L.attention_qkv(ap, x, cache_len[:, None], cfg.rope_theta)
    k_cache = torch.cat([k_cache[:, 1:], k], dim=1)
    v_cache = torch.cat([v_cache[:, 1:], v], dim=1)
    kc, vc = k_cache, v_cache
    if case == "kv":
        hl = q.shape[2]
        idx = (tp.rank * hl + torch.arange(hl, device=x.device)) \
            // (tp.heads // tp.kv_heads)
        kc, vc = k_cache[:, :, idx], v_cache[:, :, idx]
    o = _window_attention(q, kc, vc, cache_len)
    return L.attention_out(ap, o, tp), k_cache, v_cache


def _recurrent_step(sub, x, h_state, conv_state, cfg: ArchConfig, tp=None):
    """One residual recurrent block + its MLP, a single token (under
    ``tp``, the rank's block of U channels where U splits, and the MLP
    split over d_ff where it divides)."""
    hh = L.rms_norm(x, sub["norm"], cfg.norm_eps)
    state = {"h": h_state, "conv": conv_state}
    if _split(tp, cfg.hybrid.lru_width or cfg.d_model) is not None:
        out, st = RG.recurrent_block_step_tp(sub["block"], hh, state, tp)
    else:
        out, st = RG.recurrent_block_step(sub["block"], hh, state)
    x = x + out
    hh2 = L.rms_norm(x, sub["norm_mlp"], cfg.norm_eps)
    return x + L.mlp(sub["mlp"], hh2, _split(tp, cfg.d_ff)), st


def _hybrid_decode(params, x, cache: dict, cache_len, cfg: ArchConfig,
                   tp=None, fsdp=None):
    """One token through the triples and extra blocks; a new cache dict
    (under ``tp``, of the rank's blocks: :func:`_recurrent_step`,
    :func:`_windowed_decode_tp`)."""
    ks, vs, hs, convs = [], [], [], []
    for i in range(cache["attn_k"].shape[0]):
        triple = _layer(fsdp, layer_params(params["triples"], i), "triples")
        rh, rc = [], []
        for j in range(2):
            x, st = _recurrent_step(layer_params(triple["rec"], j), x,
                                    cache["rec_h"][i, j], cache["rec_conv"][i, j],
                                    cfg, tp)
            rh.append(st["h"])
            rc.append(st["conv"])
        ap = triple["attn"]
        hh = L.rms_norm(x, ap["norm"], cfg.norm_eps)
        if tp is None:
            out, ck, cv = _windowed_decode(ap["block"], hh, cache["attn_k"][i],
                                           cache["attn_v"][i], cache_len, cfg)
        else:
            out, ck, cv = _windowed_decode_tp(ap["block"], hh,
                                              cache["attn_k"][i],
                                              cache["attn_v"][i], cache_len,
                                              cfg, tp)
        x = x + out
        hh2 = L.rms_norm(x, ap["norm_mlp"], cfg.norm_eps)
        x = x + L.mlp(ap["mlp"], hh2, _split(tp, cfg.d_ff))
        ks.append(ck)
        vs.append(cv)
        hs.append(torch.stack(rh))
        convs.append(torch.stack(rc))
    new = dict(cache, attn_k=torch.stack(ks), attn_v=torch.stack(vs),
               rec_h=torch.stack(hs), rec_conv=torch.stack(convs))
    eh, ec = [], []
    for i in range(cache["extra_h"].shape[0]):
        x, st = _recurrent_step(
            _layer(fsdp, layer_params(params["extra"], i), "extra"), x,
            cache["extra_h"][i], cache["extra_conv"][i], cfg, tp)
        eh.append(st["h"])
        ec.append(st["conv"])
    if eh:
        new["extra_h"] = torch.stack(eh)
        new["extra_conv"] = torch.stack(ec)
    return x, new


def _ssm_decode(params, x, cache: dict, cfg: ArchConfig, tp=None, fsdp=None):
    """One token through the Mamba-2 layers; a new cache dict (under
    ``tp``, of the rank's state blocks: ``ssm.mamba2_decode_tp``)."""
    ssms, convs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(fsdp, layer_params(params["layers"], i), "layers")
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        st = SSM.SSMState(cache["ssm"][i], cache["conv"][i])
        if tp is None:
            out, st = SSM.mamba2_decode(lp["mixer"], h, st, cfg.ssm, cfg.d_model)
        else:
            out, st = SSM.mamba2_decode_tp(lp["mixer"], h, st, cfg.ssm,
                                           cfg.d_model, tp)
        x = x + out
        ssms.append(st.ssm)
        convs.append(st.conv)
    return x, {"ssm": torch.stack(ssms), "conv": torch.stack(convs)}


def decode_step(params, tokens: torch.Tensor, state: DecodeState,
                cfg: ArchConfig, tp=None, max_seq: Optional[int] = None,
                ep=None, fsdp=None) -> Tuple[torch.Tensor, DecodeState]:
    """One autoregressive step.  tokens: (B, 1) int -> logits (B, V).

    Dense, MoE and MLA: the new k/v (ckv/krope) are written INTO
    ``state.cache`` (in place, saving a copy of the cache per step); the
    returned state shares that cache.  SSM and hybrid: the returned state
    holds a new cache (the recurrent states and the shifted window), as the
    JAX step returns one.  Either way ``cache_len`` advances.

    Under ``tp`` (:func:`require_tp_serving`): a rank's shards, rows and
    cache blocks of a ``max_seq``-slot cache (:func:`prefill`'s layout;
    ``max_seq`` is required where the cache is positional: the blocks
    alone do not say whether the slots split; the recurrent families'
    blocks split heads, channels or the window's KV heads, and take no
    ``max_seq``); the logits are the rank's vocab columns; a MoE's FFN
    runs under ``ep``.  Under ``fsdp`` each layer's FSDP blocks are
    gathered over ``data`` just before its products, and the embedding's
    and head's leaves at their reads."""
    require_decoder(cfg)
    cache_len = state.cache_len
    if cfg.hybrid is not None or cfg.ssm is not None:
        x = _embed_tokens(params, tokens, cfg, tp, fsdp)
        if cfg.hybrid is not None:
            x, cache = _hybrid_decode(params, x, state.cache, cache_len, cfg,
                                      tp, fsdp)
        else:
            x, cache = _ssm_decode(params, x, state.cache, cfg, tp, fsdp)
        logits = lm_logits(params, x, cfg, tp, fsdp)[:, -1]
        return logits, DecodeState(cache=cache, cache_len=cache_len + 1)
    if tp is not None:
        return _decode_step_tp(params, tokens, state, cfg, tp, max_seq, ep,
                               fsdp)
    x = _top(fsdp, params, "embed")["embed"][tokens]
    mla = cfg.mla is not None
    c0, c1 = (state.cache["ckv"], state.cache["krope"]) if mla else \
        (state.cache["k"], state.cache["v"])
    for i in range(cfg.num_layers):
        lp = _layer(fsdp, layer_params(params["layers"], i), "layers")
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        if mla:
            out, _ = MLA.mla_decode(lp["attn"], h, c0[i], c1[i], cache_len,
                                    cfg.mla, cfg.rope_theta)
        else:
            out, _ = L.decode_attention_block(lp["attn"], h, c0[i], c1[i],
                                              cache_len, cfg.rope_theta)
        y = x + out
        h2 = L.rms_norm(y, lp["norm2"], cfg.norm_eps)
        x = y + ffn(lp, h2, cfg)[0]
    logits = lm_logits(params, x, cfg, fsdp=fsdp)[:, -1]
    return logits, DecodeState(cache=state.cache, cache_len=cache_len + 1)


def _decode_step_tp(params, tokens, state: DecodeState, cfg: ArchConfig, tp,
                    max_seq: Optional[int], ep=None, fsdp=None):
    require_tp_serving(cfg)
    mla = cfg.mla is not None
    k_all, v_all = (state.cache["ckv"], state.cache["krope"]) if mla else \
        (state.cache["k"], state.cache["v"])
    if max_seq is None:
        raise ValueError("decode_step under tp needs max_seq: a rank's cache "
                         "blocks do not say whether the slots split")
    span = TP.cache_span(tp, max_seq)
    if k_all.shape[2] != span.stop - span.start:
        raise ValueError(f"cache blocks of {k_all.shape[2]} slots are not a "
                         f"rank's span of {max_seq} over {tp.size} ranks")
    x = _embed_tokens(params, tokens, cfg, tp, fsdp)
    cache_len = state.cache_len
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        lp = _layer(fsdp, lp, "layers")
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        if mla:
            out, _ = MLA.mla_decode_tp(lp["attn"], h, k_all[i], v_all[i],
                                       cache_len, cfg.mla, cfg.rope_theta, tp,
                                       max_seq=max_seq)
        else:
            out, _ = L.decode_attention_tp(lp["attn"], h, k_all[i], v_all[i],
                                           cache_len, cfg.rope_theta, tp,
                                           max_seq=max_seq)
        y = x + out
        h2 = L.rms_norm(y, lp["norm2"], cfg.norm_eps)
        x = y + ffn(lp, h2, cfg, tp, ep)[0]
    logits = lm_logits(params, x, cfg, tp, fsdp)[:, -1]
    return logits, DecodeState(cache=state.cache, cache_len=cache_len + 1)


def _embed_tokens(params, tokens, cfg: ArchConfig, tp=None,
                  fsdp=None) -> torch.Tensor:
    """A decode step's token rows: under ``tp`` with the vocab split over
    ``model`` the vocab-parallel lookup, else the table's rows (the same
    bits); under ``fsdp`` of the table gathered over ``data``."""
    params = _top(fsdp, params, "embed")
    vtp = _split(tp, cfg.vocab_size)
    if vtp is not None:
        return TP.vocab_embedding(tokens, params["embed"], vtp)
    return F.embedding(tokens, params["embed"])


def resident_decode_step(params, tokens: torch.Tensor,
                         state: KVP.ResidentState, cfg: ArchConfig
                         ) -> Tuple[torch.Tensor, KVP.ResidentState]:
    """One autoregressive step over a compressed-resident cache.

    The prefix lives as SplitZip pages, read by one paged-attention kernel
    launch per layer; the step appends the new token to the raw tail pages
    IN PLACE and advances ``cache_len``.  The pools themselves are read-only
    here: tail flushes are host-side between steps
    (``KVPool.flush_full_tails``).  GQA (dense or MoE FFN) and MLA
    families; the recurrent ones decode raw-resident (their engine demotes
    at admission, as the JAX engine does)."""
    require_decoder(cfg)
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
        x = y + ffn(lp, h2, cfg)[0]
    logits = lm_logits(params, x, cfg)[:, -1]
    return logits, KVP.ResidentState(leaves=state.leaves,
                                     cache_len=cache_len + 1, geom=g)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_inputs(cfg: ArchConfig, shape: ShapeConfig, generator: torch.Generator,
                batch: Optional[int] = None, seq: Optional[int] = None,
                device=None) -> Dict:
    """Random input batch from ``generator``, with the JAX package's keys and
    shapes: ``{"tokens", "labels"}`` (B, S); an audio config ``{"frames"``
    (B, S, frontend_dim) bf16, ``"labels"}``; a vision config ``{"patches"``
    (B, frontend_len, frontend_dim) bf16, ``"tokens", "labels"}`` of
    ``S - frontend_len`` text positions."""
    b = batch or shape.global_batch
    s = seq or shape.seq_len
    device = device if device is not None else generator.device

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=generator,
                             device=generator.device).to(device)

    def normal(*dims):
        return torch.randn(dims, generator=generator, device=generator.device,
                           dtype=torch.float32).to(device, torch.bfloat16)

    if cfg.frontend == "audio_frames":
        return {"frames": normal(b, s, cfg.frontend_dim), "labels": ids(s)}
    if cfg.frontend == "vision_patches":
        s_text = s - cfg.frontend_len
        if s_text < 0:
            raise ValueError(f"{cfg.name}: seq {s} is shorter than its "
                             f"{cfg.frontend_len} frontend positions")
        return {"patches": normal(b, cfg.frontend_len, cfg.frontend_dim),
                "tokens": ids(s_text), "labels": ids(s_text)}
    return {"tokens": ids(s), "labels": ids(s)}


# ---------------------------------------------------------------------------
# abstract stand-ins (the dry run)
# ---------------------------------------------------------------------------

def abstract_params(cfg: ArchConfig) -> Dict:
    """The parameters' shapes and dtypes as ``meta`` tensors, nothing
    drawn (the JAX ``abstract_params``, ``jax.eval_shape`` of the init)."""
    return init_params(cfg, torch.Generator(), "meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    """``meta`` stand-ins for every model input of ``shape`` (the JAX
    ``input_specs``): a decode shape's one token a row; else
    :func:`make_inputs`'s keys, shapes and dtypes (int32 ids)."""
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "decode":
        return {"tokens": spec((b, 1), i32)}
    if cfg.frontend == "audio_frames":
        return {"frames": spec((b, s, cfg.frontend_dim), bf16),
                "labels": spec((b, s), i32)}
    if cfg.frontend == "vision_patches":
        s_text = s - cfg.frontend_len
        return {"patches": spec((b, cfg.frontend_len, cfg.frontend_dim), bf16),
                "tokens": spec((b, s_text), i32),
                "labels": spec((b, s_text), i32)}
    return {"tokens": spec((b, s), i32), "labels": spec((b, s), i32)}


def abstract_state(cfg: ArchConfig, batch: int, max_seq: int) -> DecodeState:
    """A decode state of ``batch`` rows over a ``max_seq``-slot cache as
    ``meta`` tensors (the JAX ``abstract_state``)."""
    from repro_torch.models.kvcache import init_cache
    return DecodeState(cache=init_cache(cfg, batch, max_seq, device="meta"),
                       cache_len=torch.empty((batch,), dtype=torch.int32,
                                             device="meta"))
