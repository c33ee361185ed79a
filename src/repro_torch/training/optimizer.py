"""AdamW on PyTorch tensors (the port of ``repro.training.optimizer``).

The state mirrors the parameter tree (m and v a leaf), with f32 moments
whatever the parameter dtype: bf16 parameters with f32 optimizer state, as
in the JAX package.  The arithmetic is the JAX package's, step for step:
the schedule, ``b1 ** step`` and ``b2 ** step`` are f32 tensors (never
Python doubles), the global norm sums the leaves' f32 squares one leaf at a
time in the JAX (sorted-key) leaf order, and the update runs in f32 and is
cast back to the parameter dtype.  A scalar divided by a tensor is divided
as two f32 tensors: PyTorch's ``scalar / tensor`` multiplies by a
reciprocal, which can round differently.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import tree as TR


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Any                   # tree like params, f32
    v: Any                   # tree like params, f32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _zeros_like(params):
    flat, treedef = TR.flatten_with_path(params)
    return TR.unflatten(treedef, [torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device)
                                  for _, p in flat])


def init(params) -> AdamWState:
    """Step 0 and zero f32 moments, on the parameters' devices."""
    leaves = TR.leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=_zeros_like(params), v=_zeros_like(params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac``; f32."""
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1),
                       max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(torch.float32)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 squares, added leaf by leaf."""
    total = 0
    for g in TR.leaves(tree):
        total = total + torch.sum(g.to(torch.float32) ** 2)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """``(grads scaled to at most max_norm, their global norm)``; ``norm``
    is the whole tree's norm when ``grads`` are one rank's shards."""
    norm = global_norm(grads) if norm is None else norm
    scale = _clip_scale(max_norm, norm)
    flat, treedef = TR.flatten_with_path(grads)
    return TR.unflatten(treedef, [_clipped(g, scale) for _, g in flat]), norm


def _clip_scale(max_norm: float, norm: torch.Tensor) -> torch.Tensor:
    limit = torch.tensor(max_norm, dtype=torch.float32, device=norm.device)
    return torch.clamp(limit / torch.clamp(norm, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(torch.float32) * scale).to(g.dtype)


def _decay_mask(path) -> bool:
    """No weight decay on norms, biases and the recurrent decay parameters:
    the last path component (the dict key) names them."""
    leaf = str(path[-1])
    return not any(s in leaf for s in ("norm", "bias", "lam", "dt_bias",
                                       "A_log", "D"))


def update(cfg: AdamWConfig, grads, state: AdamWState, params, *,
           gnorm: Optional[torch.Tensor] = None, inplace: bool = False
           ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step: ``(new params, new state, {"grad_norm", "lr"})``.
    A caller that holds shards of ``grads``, ``state`` and ``params``
    passes the whole tree's gradient norm as ``gnorm``
    (``training/train_step.py:sharded_global_norm``); the update is
    elementwise, so the shards update as the whole tree would.  Each
    gradient is clipped as its leaf is updated (``clip_by_global_norm``'s
    bits, one leaf's copy at a time).  ``inplace``: the new moments and
    parameters are written into ``state``'s and ``params``' tensors, which
    are returned (the same bits; the old values are gone, as a JAX step
    donates its state), so no second state is held."""
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = _clip_scale(cfg.grad_clip, gnorm)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    flat_p, treedef = TR.flatten_with_path(params)
    flat_g = TR.leaves(grads)
    new_m, new_v, out = [], [], []
    for (path, p), g, m, v in zip(flat_p, flat_g, TR.leaves(state.m),
                                  TR.leaves(state.v)):
        g32 = _clipped(g, scale).to(torch.float32)
        if inplace:
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
        else:
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
        del g32     # one leaf's f32 temporaries at a time
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if _decay_mask(path):
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        new = (p.to(torch.float32) - lr * upd).to(p.dtype)
        del upd
        out.append(p.copy_(new) if inplace else new)
        new_m.append(m)
        new_v.append(v)
    new_state = AdamWState(step=step, m=TR.unflatten(treedef, new_m),
                           v=TR.unflatten(treedef, new_v))
    return (TR.unflatten(treedef, out), new_state,
            {"grad_norm": gnorm, "lr": lr})
