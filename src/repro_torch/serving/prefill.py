"""Prefill worker: runs the prompt and produces the cache the PD boundary
ships (the port of ``repro.serving.prefill``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.kvcache import DecodeState


@dataclasses.dataclass(frozen=True)
class PrefillOutput:
    """What the prefill worker emits per batch."""
    first_token: torch.Tensor     # (B,) greedy first generated token
    last_logits: torch.Tensor     # (B, V)
    state: DecodeState            # the cache to transfer


@torch.no_grad()
def prefill_step(params, batch: Dict, cfg: ArchConfig, *,
                 max_seq: Optional[int] = None, kv_block: int = 1024
                 ) -> PrefillOutput:
    last_logits, state = M.prefill(params, batch, cfg, max_seq=max_seq,
                                   kv_block=kv_block)
    if cfg.encoder_only:
        # encode-and-ship: the "first token" is the first frame's argmax
        # unit; prefill returned every frame's logits (B, S, V)
        first = torch.argmax(last_logits[:, 0], dim=-1).to(torch.int32)
        return PrefillOutput(first_token=first, last_logits=last_logits[:, -1],
                             state=state)
    first = torch.argmax(last_logits, dim=-1).to(torch.int32)
    return PrefillOutput(first_token=first, last_logits=last_logits, state=state)
