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

In training under a sharding policy (``moe_ffn(ep=)``,
``distributed/expert_parallel.py``) the FFN computes the function GSPMD
makes of the JAX one, which runs over the global batch.  ``x`` is a rank's
block of its routing group's batch (the ranks that share one loss: data,
and pods without the compressed ring): the capacity comes from the
group's token count, a choice's rank within its expert adds the expert's
counts on the group ranks before this one (the stable sort puts their
tokens first), and the balance loss takes its means over the group's
gathered probabilities and top-1 experts, bitwise one process's.  Where
``model`` splits the experts a rank fills and multiplies its own expert
block only, ``(E/M, cap, d)`` against its ``w_gate_up`` / ``w_down``
shards, and the expert outputs are all-gathered over ``model`` into
``(E cap, d)`` before the combine, which stays as above: the model
replicas stay bitwise equal, and equal to the unsharded order.  Without
``ep`` nothing changes.

Sharded serving (``serving/sharded.py``) runs the same FFN under an ``ep``
whose routing group is the policy's data axes (under ``pd_disaggregated``
the data ranks of one pod, which route their pod's batch), so a prefill's
capacity is the whole batch's and a decode step at B rows routes as one
process does on B tokens (capacity 8).  Nothing is differentiated there,
so its ``ep`` gathers no balance statistics (``ExpertParallel(balance=
False)``): the FFN returns no aux loss and moves only the counts prefix
and, where ``model`` splits the experts, the expert outputs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import tensor_parallel as TP


def init_moe(draw: Callable, n_layers: int, d_model: int, cfg: MoEConfig,
             device, place: Optional[Callable] = None) -> Dict:
    """Layer-stacked MoE parameters with ``repro.models.moe.init_moe``'s
    shapes, dtypes and scales: ``router`` f32 (L, d, E), ``w_gate_up`` bf16
    (L, E, d, 2f), ``w_down`` bf16 (L, E, f, d).

    ``draw(shape, scale)`` gives f32 normals times ``scale``; the stacks are
    filled one layer at a time, so no f32 copy of a whole stack (77 GB for
    qwen3-moe-30b-a3b's ``w_gate_up``) ever exists.  ``place(keys, x,
    n_layers)``, where given (``model.init_params``), keeps a part of
    each layer's draw of the stack at ``("layers", "ffn", name)`` (a
    rank's block), and the stacks are that part's shape."""
    e, f, d = cfg.num_experts, cfg.d_ff_expert, d_model
    s_in = d ** -0.5
    leaves = {"router": ((d, e), s_in, torch.float32),
              "w_gate_up": ((e, d, 2 * f), s_in, torch.bfloat16),
              "w_down": ((e, f, d), f ** -0.5, torch.bfloat16)}
    p = {}
    for i in range(n_layers):
        for name, (shape, scale, dtype) in leaves.items():
            x = draw(shape, scale)
            if place is not None:
                x = place(("layers", "ffn", name), x, n_layers)
            if i == 0:
                p[name] = torch.empty((n_layers,) + tuple(x.shape),
                                      dtype=dtype, device=device)
            p[name][i] = x
    return p


def capacity(num_tokens: int, cfg: MoEConfig) -> int:
    c = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 for layout friendliness


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    equal values in ascending index order (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, xf: torch.Tensor, cfg: MoEConfig, cap: int,
          ep=None) -> Dict[str, torch.Tensor]:
    """The dispatch of ``repro.models.moe.moe_ffn`` for tokens ``xf`` (T, d):
    :func:`route_logits` of the f32 router logits."""
    return route_logits(torch.matmul(xf.float(), router), cfg, cap, ep)


def route_logits(logits: torch.Tensor, cfg: MoEConfig, cap: int, ep=None
                 ) -> Dict[str, torch.Tensor]:
    """The dispatch from router ``logits`` (T, E) f32.

    Returns ``probs`` (T, E) f32, ``gate`` (T, k) f32 renormalized,
    ``expert_idx`` (T, k), and over the T*k choices in sorted order:
    ``order`` (flat choice index), ``slot`` (``expert * cap + rank``, or
    ``E * cap`` when dropped) and ``token_of``.  Under ``ep`` the tokens
    are this rank's block of the routing group's batch, and a choice's
    rank within its expert counts the group ranks before this one
    (``ExpertParallel.offsets``)."""
    t, k, e = logits.shape[0], cfg.top_k, cfg.num_experts
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = top_k(probs, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    # a choice count per expert (what ``bincount`` gives, at a shape that
    # does not depend on the data: no host read)
    counts = torch.zeros(e, dtype=torch.int64, device=logits.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    if ep is not None:
        starts = starts - ep.offsets(counts)
    rank = torch.arange(t * k, device=logits.device) - starts[e_sorted]
    slot = torch.where(rank < cap, e_sorted * cap + rank,
                       torch.full_like(rank, e * cap))
    return dict(probs=probs, gate=gate, expert_idx=expert_idx, order=order,
                slot=slot, token_of=order // k)


def moe_ffn(p, x: torch.Tensor, cfg: MoEConfig, ep=None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar f32).  Under ``ep``
    (an :class:`~repro_torch.distributed.expert_parallel.ExpertParallel`)
    ``x`` is this rank's block of the routing group's batch and ``p`` its
    shards: the capacity, ranks and balance loss are the group's, and the
    rank computes its expert block (module docstring); an ``ep`` without
    ``balance`` (serving) returns None for the aux loss."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.num_experts
    cap = capacity(t * (ep.size if ep is not None else 1), cfg)
    xf = x.reshape(t, d)
    r = route(p["router"], xf, cfg, cap, ep)

    # load-balance aux loss: E * sum_e f_e . p_e (Switch Transformer form)
    aux = None
    if ep is None or ep.balance:
        probs, top1 = r["probs"], r["expert_idx"][:, 0]
        if ep is not None:
            probs, top1 = ep.whole(probs), ep.whole(top1)
        me = probs.mean(dim=0)
        fe = F.one_hot(top1, e).float().mean(dim=0)
        aux = e * torch.sum(fe * me)

    # dispatch: row n*cap takes every choice dropped or another rank's
    # expert's and is cut off
    slot, n = r["slot"], e
    xd = xf
    if ep is not None and ep.model is not None:
        lo, n = ep.experts.start * cap, ep.experts.stop - ep.experts.start
        own = (slot >= lo) & (slot < lo + n * cap)
        slot = torch.where(own, slot - lo, torch.full_like(slot, n * cap))
        xd = TP.region(xf, ep.model, ep.dispatch)
    buf = torch.zeros((n * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xd[r["token_of"]]
    h = buf[: n * cap].reshape(n, cap, d)

    # experts: two batched products over the expert axis
    gu = torch.bmm(h, p["w_gate_up"])
    g, u = gu.chunk(2, dim=-1)
    out = torch.bmm(F.silu(g) * u, p["w_down"]).reshape(n * cap, d)
    if ep is not None and ep.model is not None:
        out = TP.gather(out, ep.model, 0, ep.out_gather)

    # combine: dropped -> 0; each token's k contributions in sorted order
    out = torch.cat([out, out.new_zeros((1, d))])
    gate_sorted = r["gate"].reshape(-1)[r["order"]].to(x.dtype)
    contrib = out[r["slot"]] * gate_sorted[:, None]            # (T*k, d)
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
