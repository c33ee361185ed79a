"""Inference cache structures (dense GQA and MLA families), the port of
``repro.models.kvcache``.

The cache is *the* object SplitZip exists for: it is produced by prefill
workers, crosses the PD boundary compressed, and is consumed by decode
workers.  Each family stores its state stacked over layers, so the whole
cache is one dict the transfer plan maps the codec over:

  dense : k, v        (L, B, S, Hkv, hd)             bf16
  mla   : ckv, krope  (L, B, S, r) / (L, B, S, p)    bf16
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


def require_dense(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a token decoder of the dense GQA or the MLA
    family (no MoE, SSM, hybrid, encoder-only or frontend configs)."""
    if (cfg.ssm is not None or cfg.hybrid is not None
            or cfg.moe is not None or cfg.encoder_only or cfg.frontend):
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA and MLA families are ported")


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zero-filled cache: ``{"k", "v"}`` (L, B, S, Hkv, hd) for dense GQA,
    ``{"ckv", "krope"}`` (L, B, S, r) / (L, B, S, p) for MLA."""
    require_dense(cfg)
    l, b, s = cfg.num_layers, batch, max_seq
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": torch.zeros((l, b, s, m.kv_lora_rank), dtype=dtype,
                                   device=device),
                "krope": torch.zeros((l, b, s, m.qk_rope_head_dim),
                                     dtype=dtype, device=device)}
    shape = (l, b, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_bytes(cache: dict) -> int:
    return sum(x.numel() * x.element_size() for x in TR.leaves(cache))
