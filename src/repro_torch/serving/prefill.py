"""Prefill worker: runs the prompt and produces the cache the PD boundary
ships (the port of ``repro.serving.prefill``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as TP
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
                 max_seq: Optional[int] = None, kv_block: int = 1024,
                 tp=None, ep=None, fsdp=None) -> PrefillOutput:
    """Run the prompt; the greedy first token, the last logits and the
    cache.  An encoder-only config encodes and ships: the "first token" is
    the first frame's argmax unit, ``last_logits`` the last frame's, the
    cache empty.  Under ``tp`` (every family, ``models.model.prefill``; a
    MoE's FFN under ``ep``): a rank's shards and rows, ``last_logits`` the
    rank's vocab columns (the whole rows are never needed: the first token
    or unit comes from the vocab-parallel argmax,
    ``tensor_parallel.vocab_argmax``, which moves two numbers a row) and
    the cache the rank's blocks.  Under ``fsdp`` (a
    ``distributed.fsdp.BlockGather``) the parameters are the rank's FSDP
    blocks, each layer's gathered over ``data`` just before its
    products."""
    last_logits, state = M.prefill(params, batch, cfg, max_seq=max_seq,
                                   kv_block=kv_block, tp=tp, ep=ep, fsdp=fsdp)
    if cfg.encoder_only:
        # prefill returned every frame's logits (B, S, V)
        return PrefillOutput(first_token=greedy(last_logits[:, 0], cfg, tp),
                             last_logits=last_logits[:, -1], state=state)
    return PrefillOutput(first_token=greedy(last_logits, cfg, tp),
                         last_logits=last_logits, state=state)


def greedy(logits: torch.Tensor, cfg: ArchConfig, tp=None) -> torch.Tensor:
    """The greedy token (int32) of logits (..., V): ``torch.argmax``, or
    under ``tp`` with the vocab split over ``model`` the vocab-parallel
    argmax of the rank's columns (the same token: ties to the first
    index)."""
    if tp is not None and tp.splits(cfg.vocab_size):
        return TP.vocab_argmax(logits, tp).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)
