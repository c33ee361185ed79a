"""Decode worker: consumes a (transferred) cache and generates tokens (the
port of ``repro.serving.decode``; the JAX ``lax.scan`` is a Python loop).

``serve_step`` is one step; ``decode_loop`` decodes a raw cache (both
also under tensor parallelism, ``tp=``, over a rank's cache blocks, a
MoE's expert parallelism, ``ep=``, and FSDP blocks gathered a layer at a
time, ``fsdp=``);
``resident_decode_loop`` decodes a compressed-resident one
(:class:`~repro_torch.models.kvpool.ResidentState`) and demotes to
``decode_loop`` if a tail flush cannot stay resident."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.kvcache import DecodeState
from repro_torch.models.kvpool import KVPool, ResidencyError, ResidentState
from repro_torch.serving.prefill import greedy


@torch.no_grad()
def serve_step(params, tokens: torch.Tensor, state: DecodeState,
               cfg: ArchConfig, tp=None, max_seq: Optional[int] = None,
               ep=None, fsdp=None) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step: (B, 1) tokens -> ((B, V) logits, new state), the
    unit the JAX dry-run lowers for its decode cells.  The cache is written
    in place (``models.model.decode_step``).  Under ``tp`` (dense GQA, MLA,
    MoE with its ``ep``): a rank's shards, rows and cache blocks of a
    ``max_seq``-slot cache, and the logits are the rank's vocab columns,
    not gathered: the next token needs only the vocab-parallel argmax
    (``prefill.greedy``), and a gather would move B x V values a step to
    every rank.  Under ``fsdp`` (a ``distributed.fsdp.BlockGather``) the
    parameters are the rank's FSDP blocks, each layer's gathered over
    ``data`` just before its products."""
    return M.decode_step(params, tokens, state, cfg, tp=tp, max_seq=max_seq,
                         ep=ep, fsdp=fsdp)


@torch.no_grad()
def decode_loop(params, first_token: torch.Tensor, state: DecodeState,
                cfg: ArchConfig, num_steps: int, tp=None,
                max_seq: Optional[int] = None, on_logits=None, ep=None,
                fsdp=None) -> Tuple[torch.Tensor, DecodeState]:
    """Greedy generation of ``num_steps`` tokens -> ((B, num_steps), state).

    The loop decodes into ONE copy of ``state.cache`` (``decode_step``
    writes in place), so the caller's state is left as it was.  Under
    ``tp`` (and ``ep``, ``fsdp``) as :func:`serve_step`, each token from the
    vocab-parallel argmax.  ``on_logits(i, logits)``, where given, sees step ``i``'s
    logits (the rank's columns under ``tp``).  ``num_steps`` 0 returns
    ``state`` itself: no step writes, so no copy is made."""
    if num_steps == 0:
        return _stack([], first_token), state
    st = DecodeState(cache={k: v.clone() for k, v in state.cache.items()},
                     cache_len=state.cache_len)
    tok = first_token
    toks = []
    for i in range(num_steps):
        logits, st = M.decode_step(params, tok[:, None], st, cfg, tp=tp,
                                   max_seq=max_seq, ep=ep, fsdp=fsdp)
        if on_logits is not None:
            on_logits(i, logits)
        tok = greedy(logits, cfg, tp)
        toks.append(tok)
    return _stack(toks, first_token), st


def _stack(toks, first_token: torch.Tensor) -> torch.Tensor:
    if not toks:
        return torch.zeros((first_token.shape[0], 0), dtype=torch.int32,
                           device=first_token.device)
    return torch.stack(toks, dim=1)


@torch.no_grad()
def resident_decode_loop(params, first_token: torch.Tensor,
                         state: ResidentState, pool: KVPool, cfg: ArchConfig,
                         num_steps: int):
    """Greedy generation over a compressed-resident cache.

    Each step runs ``resident_decode_step`` (one paged-attention launch per
    layer; the pools are read-only there), then the host recompresses rows
    whose raw tail page filled into fresh pages (``pool.flush_full_tails``).
    Escape overflow or pool exhaustion during a flush demotes the WHOLE
    batch: the pool rehydrates bit-exactly to a raw ``DecodeState`` and the
    remaining steps run :func:`decode_loop`.  ``state`` is updated in place.
    Returns ``(tokens (B, N), final_state, demoted)``."""
    tok = first_token
    toks = []
    st = state
    for i in range(num_steps):
        logits, st = M.resident_decode_step(params, tok[:, None], st, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
        try:
            st = pool.flush_full_tails(st)
        except ResidencyError:
            dst = DecodeState(cache=pool.rehydrate(st), cache_len=st.cache_len)
            remaining = num_steps - (i + 1)
            if remaining:
                rest, dst = decode_loop(params, tok, dst, cfg, remaining)
                toks.extend(rest.unbind(dim=1))
            return _stack(toks, first_token), dst, True
    return _stack(toks, first_token), st, False
