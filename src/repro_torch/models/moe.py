"""Mixture-of-Experts FFN with sort-based capacity dispatch (Qwen3-MoE style),
the port of ``repro.models.moe``.

Routing and dispatch are the JAX package's, step for step: f32 router
logits and softmax, top-k with ties to the lower expert index (as
``jax.lax.top_k``), gates renormalized over the top-k, a stable argsort of
the flat expert choices, per-expert ranks, and capacity
``max(8, ceil8(T k capacity_factor / E))``; a choice ranked past its
expert's capacity is dropped (it contributes 0).  The experts run as two
batched products over ``(E, capacity, ·)`` buffers, as the JAX package
leaves them to XLA.

The combine is deterministic: each token's ``k`` gated contributions are
summed in bf16 in the order the JAX scatter-add applies them (their sorted
positions), one rounding per add.  ``index_add_`` in bf16 on CUDA would add
them with atomics in an order that changes from run to run, and tokens
served with and without compression would then differ.

Every decode step computes all ``E x capacity`` slots (capacity 8 at decode
batch sizes), so it reads every expert's weights, as the JAX function does.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig


def init_moe(draw: Callable, n_layers: int, d_model: int, cfg: MoEConfig,
             device) -> Dict:
    """Layer-stacked MoE parameters with ``repro.models.moe.init_moe``'s
    shapes, dtypes and scales: ``router`` f32 (L, d, E), ``w_gate_up`` bf16
    (L, E, d, 2f), ``w_down`` bf16 (L, E, f, d).

    ``draw(shape, scale)`` gives f32 normals times ``scale``; the stacks are
    filled one layer at a time, so no f32 copy of a whole stack (77 GB for
    qwen3-moe-30b-a3b's ``w_gate_up``) ever exists."""
    e, f, d = cfg.num_experts, cfg.d_ff_expert, d_model
    s_in = d ** -0.5
    p = {"router": torch.empty((n_layers, d, e), dtype=torch.float32, device=device),
         "w_gate_up": torch.empty((n_layers, e, d, 2 * f), dtype=torch.bfloat16,
                                  device=device),
         "w_down": torch.empty((n_layers, e, f, d), dtype=torch.bfloat16,
                               device=device)}
    for i in range(n_layers):
        p["router"][i] = draw((d, e), s_in)
        p["w_gate_up"][i] = draw((e, d, 2 * f), s_in)
        p["w_down"][i] = draw((e, f, d), f ** -0.5)
    return p


def capacity(num_tokens: int, cfg: MoEConfig) -> int:
    c = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 for layout friendliness


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    equal values in ascending index order (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, xf: torch.Tensor, cfg: MoEConfig, cap: int
          ) -> Dict[str, torch.Tensor]:
    """The dispatch of ``repro.models.moe.moe_ffn`` for tokens ``xf`` (T, d).

    Returns ``probs`` (T, E) f32, ``gate`` (T, k) f32 renormalized,
    ``expert_idx`` (T, k), and over the T*k choices in sorted order:
    ``order`` (flat choice index), ``slot`` (``expert * cap + rank``, or
    ``E * cap`` when dropped) and ``token_of``."""
    t, k, e = xf.shape[0], cfg.top_k, cfg.num_experts
    logits = torch.matmul(xf.float(), router)
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = top_k(probs, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=xf.device) - starts[e_sorted]
    slot = torch.where(rank < cap, e_sorted * cap + rank,
                       torch.full_like(rank, e * cap))
    return dict(probs=probs, gate=gate, expert_idx=expert_idx, order=order,
                slot=slot, token_of=order // k)


def moe_ffn(p, x: torch.Tensor, cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar f32)."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.num_experts
    cap = capacity(t, cfg)
    xf = x.reshape(t, d)
    r = route(p["router"], xf, cfg, cap)

    # load-balance aux loss: E * sum_e f_e . p_e (Switch Transformer form)
    me = r["probs"].mean(dim=0)
    fe = F.one_hot(r["expert_idx"][:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(fe * me)

    # dispatch: row E*cap takes every dropped choice and is cut off
    slot = r["slot"]
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xf[r["token_of"]]
    h = buf[: e * cap].reshape(e, cap, d)

    # experts: two batched products over the expert axis
    gu = torch.bmm(h, p["w_gate_up"])
    g, u = gu.chunk(2, dim=-1)
    out = torch.bmm(F.silu(g) * u, p["w_down"]).reshape(e * cap, d)

    # combine: dropped -> 0; each token's k contributions in sorted order
    out = torch.cat([out, out.new_zeros((1, d))])
    gate_sorted = r["gate"].reshape(-1)[r["order"]].to(x.dtype)
    contrib = out[slot] * gate_sorted[:, None]                 # (T*k, d)
    sorted_pos = torch.empty_like(r["order"])
    sorted_pos[r["order"]] = torch.arange(t * k, device=x.device)
    mine = torch.sort(sorted_pos.reshape(t, k), dim=1).values  # (T, k)
    parts = contrib[mine]                                      # (T, k, d)
    yf = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        yf = yf + parts[:, j]
    return yf.reshape(b, s, d), aux


def moe_ffn_dense_ref(p, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """O(T E) reference (every expert for every token, then masked), as
    ``repro.models.moe.moe_ffn_dense_ref``.  Only for tiny configs."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    probs = torch.softmax(torch.matmul(xf.float(), p["router"]), dim=-1)
    gate, expert_idx = top_k(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    gu = torch.einsum("td,edf->etf", xf, p["w_gate_up"])
    g, u = gu.chunk(2, dim=-1)
    y_all = torch.einsum("etf,efd->etd", F.silu(g) * u, p["w_down"])   # (E,T,D)
    weights = torch.zeros((t, cfg.num_experts), dtype=torch.float32,
                          device=x.device)
    for j in range(cfg.top_k):
        weights = weights + F.one_hot(expert_idx[:, j], cfg.num_experts) \
            * gate[:, j:j + 1]
    yf = torch.einsum("etd,te->td", y_all, weights.to(x.dtype))
    return yf.reshape(b, s, d)
