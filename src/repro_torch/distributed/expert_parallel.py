"""Expert parallelism and global-batch routing for the MoE FFN under a
sharding policy: the context the model code takes as ``ep=``.

The JAX package has no counterpart module.  There GSPMD partitions the
jitted train step: the ``expert`` rule splits ``w_gate_up`` (E, D, 2F)
over ``model`` by experts and ``ff_row`` does the same to the MoE
``w_down`` (E, F, D), and ``moe_ffn`` runs over the global batch, so its
capacity, each choice's rank within its expert and the balance loss are
global-batch quantities.  Sharding does not change the function, and the
port computes the same one explicitly:

* the **routing group** is the set of ranks that share one loss: the
  ``data`` ranks, and the ``pod`` ranks too where pods carry no
  compressed ring; under ``grad_compress`` the ``data`` ranks of one pod
  (the JAX step vmaps the loss over a pod split).  Its group ranks are in
  the batch's block order (``spec_for_activation("tokens")`` splits the
  batch row-major over the dp axes, pod major), and every rank holds an
  equal block, so the group's token count is its size times a rank's;
* **the counts prefix** (:meth:`ExpertParallel.offsets`): the (E,) expert
  counts all-gathered over the group; a rank's offset for expert e is the
  sum of the counts of the ranks before it.  The stable argsort over the
  flat choices puts the tokens of lower ranks first, so a choice's rank
  within its expert is its rank on this rank plus that offset;
* **the group statistics** (:meth:`ExpertParallel.whole`): the balance
  loss's means are taken over the group's whole (T, E) router
  probabilities and (T,) top-1 experts, all-gathered in group-rank order,
  by the same expressions as the unsharded FFN, so ``me``, ``fe`` and the
  loss are bitwise those of one process on the whole batch, on every rank.
  The probabilities' gather is an autograd function whose backward sums
  the whole gradient over the group in f32 in rank order and keeps the
  rank's rows: every rank's loss holds the balance loss once, and the
  train step divides the summed gradients by the data-parallel size, so
  a gradient passed through would leave the router's balance gradient
  1/n of JAX's.  (Summing the per-rank partial sums instead would add
  the same numbers in another order, and ``me`` would lose its bits.)

Model ranks hold the same tokens.  Where ``model`` splits the experts
(``E % model == 0``, the policy's rule), a rank fills and multiplies only
its own expert block's ``(E/M, cap, d)`` rows against its ``w_gate_up`` /
``w_down`` shards; the outputs are all-gathered over ``model`` into
``(E cap, d)`` (``tensor_parallel.gather``: backward, the rank's slice of
the whole gradient) and the combine runs as in one process.  The
gradient reaching the tokens through the dispatch is partial on each
model rank (its own experts only), so the dispatched tokens enter through
``tensor_parallel.region`` (the sum over ``model`` backward); the
router's gradient is whole on every model rank and does not.  Where
``model`` does not split the experts the policy leaves the stacks whole
on every model rank and the FFN runs replicated, with no model
collective.

Sharded serving (``serving/sharded.expert_parallel``) builds the same
context once on every rank, routed over the policy's data axes (``ring``
False; under ``pd_disaggregated`` the data ranks of one pod) and with
``balance=False``: nothing is differentiated, so the balance loss's
gathers are skipped and the FFN returns no aux loss.

The model-axis collectives run on the step's
:class:`~repro_torch.distributed.tensor_parallel.TensorParallel`.  The
routing collectives' bytes and host time go to the context's ``fwd``
and ``bwd`` ``CommStats``, the expert-output gathers' to
``out_gather`` and the dispatch sums' to ``dispatch``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core import abstract as AB
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.serving import collective as CL


def routing_group(policy, ring: bool):
    """The routing group's process group on this rank, or None where it is
    this rank alone: the data-parallel axes of more than one rank, less
    ``pod`` where pods average through the compressed ring (``ring``).  A
    group over ``pod`` and ``data`` together is made here
    (``dist.new_group`` for every other coordinate, on every rank in one
    order): call it once, on every rank, outside the step."""
    axes = tuple(a for a in policy.dp_axes() if policy.sizes[a] > 1
                 and not (ring and a == "pod"))
    if not axes:
        return None
    mesh = policy.mesh
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = tuple(mesh.mesh_dim_names)
    lead = [names.index(a) for a in axes]
    # the rank grid as plain integers (the dry run builds this group
    # under fake tensors)
    ranks = np.array(AB.host_read(lambda: mesh.mesh.tolist())).transpose(
        lead + [i for i in range(len(names)) if i not in lead])
    ranks = ranks.reshape(math.prod(policy.sizes[a] for a in axes), -1)
    me, mine = dist.get_rank(), None
    for col in ranks.T.tolist():
        if col != sorted(col):
            raise ValueError(f"routing group {col}: the mesh's ranks are not "
                             "in the batch's block order")
        group = dist.new_group(col)
        if me in col:
            mine = group
    return mine


class ExpertParallel:
    """One rank's view of the MoE FFN's sharding: the routing group (its
    process group, this rank's index and its size; None for this rank
    alone), the expert block this rank computes and, where ``model``
    splits the experts, the step's
    :class:`~repro_torch.distributed.tensor_parallel.TensorParallel`
    ``tp`` (``model``; else None).  ``balance``: whether the FFN computes
    the balance loss over the group's gathered statistics (training);
    serving, which differentiates nothing, sets it False and the FFN skips
    those gathers and returns no aux loss."""

    def __init__(self, cfg: ArchConfig, group=None, tp=None,
                 balance: bool = True):
        e = cfg.moe.num_experts
        self.balance = balance
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.size = dist.get_world_size(group) if group is not None else 1
        self.fwd, self.bwd = CL.CommStats(), CL.CommStats()
        self.out_gather, self.dispatch = CL.CommStats(), CL.CommStats()
        self.model = tp if tp is not None and tp.splits(e) else None
        n = e // self.model.size if self.model is not None else e
        lo = self.model.rank * n if self.model is not None else 0
        self.experts = slice(lo, lo + n)

    def link(self, backward: bool, device) -> CL.Link:
        return CL.Link(self.group, device, self.bwd if backward else self.fwd)

    def offsets(self, counts: torch.Tensor) -> torch.Tensor:
        """The sum of the (E,) expert ``counts`` of the group ranks before
        this one (every group rank calls it)."""
        if self.size == 1:
            return torch.zeros_like(counts)
        parts = self.link(False, counts.device).all_gather(counts)
        return torch.stack(parts).cumsum(0)[self.rank] - counts

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """Every group rank's rows ``x`` concatenated in rank order (the
        group's whole batch); a float ``x`` under grad takes the sum of
        every rank's gradient of the whole, its own rows (module
        docstring)."""
        if self.size == 1:
            return x
        if x.is_floating_point():
            return _Whole.apply(x, self)
        return torch.cat(self.link(False, x.device).all_gather(x.contiguous()))


class _Whole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ep):
        ctx.ep, ctx.n = ep, x.shape[0]
        return torch.cat(ep.link(False, x.device).all_gather(x.contiguous()))

    @staticmethod
    def backward(ctx, g):
        ep = ctx.ep
        parts = ep.link(True, g.device).all_to_all(
            [b.contiguous() for b in g.split(ctx.n)])
        return TP.ordered_sum(parts).to(g.dtype), None

