"""Inference cache structures of every model family, the port of
``repro.models.kvcache``.

The cache is *the* object SplitZip exists for: it is produced by prefill
workers, crosses the PD boundary compressed, and is consumed by decode
workers.  Each family stores its state stacked over layers, so the whole
cache is one dict the transfer plan maps the codec over:

  dense, moe : k, v       (L, B, S, Hkv, hd)                 bf16; a vlm's
               S counts its patch positions before its text tokens
  mla        : ckv, krope (L, B, S, r) / (L, B, S, p)        bf16
  ssm        : ssm, conv  (L, B, H, P, N) f32 / (L, B, W-1, C) bf16
  hybrid     : attn_k, attn_v (nt, B, w, Hkv, hd) bf16, the window's
               right-aligned last w positions; rec_h (nt, 2, B, U) f32 and
               rec_conv (nt, 2, B, W-1, U) bf16 of each triple's two
               recurrent blocks; extra_h / extra_conv (ne, B, ...) of the
               leftover recurrent blocks
  audio      : none (encoder-only; what ships is the encoder output)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as TR


@dataclasses.dataclass
class DecodeState:
    """Raw decode-worker state.

    ``cache_len`` is PER ROW: a ragged batch right-pads each row to the
    padded sequence length, and every consumer (decode attention's validity
    mask, transfer accounting) reads the per-row length, never the padded S."""
    cache: dict
    cache_len: torch.Tensor  # (B,) int32 — valid prefix length per row

    def valid_mask(self, max_seq: Optional[int] = None) -> torch.Tensor:
        """(B, S) bool — True where the cache holds a real token."""
        if max_seq is None:
            max_seq = max(v.shape[2] for v in self.cache.values()
                          if v.dim() >= 3)
        pos = torch.arange(max_seq, device=self.cache_len.device)
        return pos[None, :] < self.cache_len[:, None]


def require_decoder(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` has a decode step: every family but the
    encoder-only one (a ``vision_patches`` frontend decodes text tokens
    after its patches).  The JAX package raises the same ``ValueError``."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")


def require_dense(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a token decoder with dense attention: the GQA
    or the MLA family (a vision frontend included), with a SwiGLU or an MoE
    FFN; not the SSM, the hybrid or the encoder-only family."""
    if cfg.ssm is not None or cfg.hybrid is not None or cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA and MLA families (SwiGLU or MoE "
            "FFN) decode from compressed pages")


def n_triples_extra(cfg: ArchConfig):
    """(full (rglru, rglru, local_attn) patterns, leftover recurrent blocks)."""
    pat = len(cfg.hybrid.pattern)
    return cfg.num_layers // pat, cfg.num_layers % pat


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None, policy=None) -> dict:
    """Zero-filled cache of the family's layout (module docstring); the
    recurrent families' state does not grow with ``max_seq``, and the
    hybrid's window holds ``min(window, max_seq)`` positions.  ``device=
    "meta"`` allocates nothing (the scheduler's bucket plans).  An
    encoder-only config has no cache: ``{}``.

    ``policy`` (a ``distributed.sharding.ShardingPolicy``): only this
    rank's block of each leaf (``local_shape`` of the whole shape under
    ``spec_for_cache``; a dimension that does not divide its axes is
    replicated, as the policy's rules keep it).  ``batch`` and
    ``max_seq`` are the whole cache's."""
    if cfg.encoder_only:
        return {}
    l, b, s = cfg.num_layers, batch, max_seq

    def zeros(name, shape, dt=dtype):
        if policy is not None:
            from repro_torch.distributed import sharding as SH
            shape = SH.local_shape(shape, policy.spec_for_cache(name, shape),
                                   policy.sizes)
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.ssm is not None:
        m = cfg.ssm
        d_inner = m.expand * cfg.d_model
        conv_ch = d_inner + 2 * m.n_groups * m.d_state
        return {"ssm": zeros("ssm", (l, b, d_inner // m.head_dim, m.head_dim,
                                     m.d_state), torch.float32),
                "conv": zeros("conv", (l, b, m.conv_width - 1, conv_ch))}
    if cfg.hybrid is not None:
        nt, ne = n_triples_extra(cfg)
        w = min(cfg.hybrid.window, max_seq)
        u = cfg.hybrid.lru_width or cfg.d_model
        cw = cfg.hybrid.conv_width
        kv = (nt, b, w, cfg.num_kv_heads, cfg.head_dim)
        return {"attn_k": zeros("attn_k", kv), "attn_v": zeros("attn_v", kv),
                "rec_h": zeros("rec_h", (nt, 2, b, u), torch.float32),
                "rec_conv": zeros("rec_conv", (nt, 2, b, cw - 1, u)),
                "extra_h": zeros("extra_h", (ne, b, u), torch.float32),
                "extra_conv": zeros("extra_conv", (ne, b, cw - 1, u))}
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": zeros("ckv", (l, b, s, m.kv_lora_rank)),
                "krope": zeros("krope", (l, b, s, m.qk_rope_head_dim))}
    shape = (l, b, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": zeros("k", shape), "v": zeros("v", shape)}


def cache_bytes(cache: dict) -> int:
    return sum(x.numel() * x.element_size() for x in TR.leaves(cache))


def transferable_leaves(cache: dict):
    """``(path, leaf)`` pairs the transfer compresses (bf16) and those it
    ships raw (the f32 recurrent states, unless ``compress_fp32``), in the
    JAX package's flatten order."""
    comp, raw = [], []
    for path, leaf in TR.flatten_with_path(cache)[0]:
        (comp if leaf.dtype == torch.bfloat16 else raw).append((path, leaf))
    return comp, raw
