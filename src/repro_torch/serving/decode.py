"""Decode worker: consumes a (transferred) cache and generates tokens (the
port of ``repro.serving.decode``; the JAX ``lax.scan`` is a Python loop)."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.kvcache import DecodeState


@torch.no_grad()
def decode_loop(params, first_token: torch.Tensor, state: DecodeState,
                cfg: ArchConfig, num_steps: int) -> Tuple[torch.Tensor, DecodeState]:
    """Greedy generation of ``num_steps`` tokens -> ((B, num_steps), state).

    The loop decodes into ONE copy of ``state.cache`` (``decode_step``
    writes in place), so the caller's state is left as it was."""
    st = DecodeState(cache={k: v.clone() for k, v in state.cache.items()},
                     cache_len=state.cache_len)
    tok = first_token
    toks = []
    for _ in range(num_steps):
        logits, st = M.decode_step(params, tok[:, None], st, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
    if not toks:
        return torch.zeros((first_token.shape[0], 0), dtype=torch.int32,
                           device=first_token.device), st
    return torch.stack(toks, dim=1), st
