"""The training step: loss -> gradients -> (optionally compressed)
cross-pod mean -> AdamW (the port of ``repro.training.train_step``).

Without a policy the step is one process's: the loss of the global
batch, ``backward`` and the update.

Under a :class:`~repro_torch.distributed.sharding.ShardingPolicy`
(``make_train_step(cfg, opt_cfg, policy)``, one process a mesh rank; the
launcher's ``--mesh N,D,M``) the step is the explicit form of what GSPMD
makes of the JAX step: every rank takes its block of the global batch
under ``spec_for_activation("tokens")``, all-gathers each parameter its
spec splits over ``data`` (FSDP), runs ``value_and_grad`` on its block,
and sums the gradients over ``data`` in f32 in rank order.  A ``model``
axis above 1 is tensor parallelism: no parameter is gathered over
``model``; the model code runs on the rank's ``model`` shards
(``distributed/tensor_parallel.py``, ``loss_fn(tp=)``), every family,
and the leaves replicated over ``model`` whose gradients are partial on
each rank (``tensor_parallel.partial_leaf``: attention leaves a rank
uses for some heads or positions only, the RG-LRU's per-channel leaves
a rank uses its block of) are summed over ``model`` in f32 in rank
order first; every other gradient is already whole on each model rank.  A MoE
FFN (``distributed/expert_parallel.py``, ``loss_fn(ep=)``) routes over
its routing group, the ranks that share one loss (data, and pods
without the ring): the capacity, each choice's rank within its expert
and the balance loss are the group's, as GSPMD partitions the JAX step's
global-batch FFN; ``model`` splits it by experts.  A leaf
with an FSDP block is reduce-scattered into it (and, replicated, its
rounded blocks are all-gathered back); a leaf too small to split is
all-gathered whole.  Without the ring the sum goes on over ``pod`` in f32 and is
divided by ``dp_size`` and rounded once to the parameter dtype (the "f32
mean" of the ring).  With ``grad_compress`` and pods the data mean is
rounded, then the pods average it through the compressed ring on
``mesh.get_group("pod")``, the ranks of this rank's data coordinate: data
reduced first, pods over the ring, the order of the JAX docstring.  On a
mesh of pods alone a rank's block is its pod's slice of the batch, the
JAX step's pod split; JAX stacks the pods' gradients on a leading pod
dimension and the ring reads only a rank's own row, so each rank hands it
its own (``compressed_cross_pod_mean_own``).  AdamW runs on the shards
(:func:`sharded_global_norm` gives it the whole tree's norm), and the
metrics are the mean over the data-parallel ranks (a MoE ``aux`` is its
routing group's: replicated without the ring, the pods' mean with it, as
JAX reports them).

Gradients keep the parameter dtype, as ``jax.grad`` returns them: bf16
gradients ride the codec, f32 ones (the MoE router, the SSM's ``A_log``, …)
ship raw.  Attention in training is ``layers.chunked_attention`` under
autograd (``models.model.loss_fn``), never the flash kernel.

:func:`shard_train_step` stands where the JAX ``jit_train_step`` stands:
it places the state under the policy and returns the step.  Nothing is
compiled; the step runs eagerly on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as TR
from repro_torch.core.codebook import Codebook
from repro_torch.distributed import expert_parallel as EP
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import model as M
from repro_torch.serving import collective as CL
from repro_torch.training import grad_compress as GC
from repro_torch.training import optimizer as OPT

#: the sharded step's traffic of its last call, each a ``CommStats``
#: (host clock): ``gather`` (parameters, over data), ``reduce`` (gradients:
#: partial ones over model, then over data, and over pod without the
#: ring), ``norm`` (partial norms), under tensor parallelism
#: ``tp_fwd`` / ``tp_bwd`` (the activation and loss collectives of the
#: forward passes, remat's included, and of the backward pass; their
#: ``seconds`` are the staging and wire time), and for a MoE config
#: ``route_fwd`` / ``route_bwd`` (the routing group's counts and
#: statistics, and their gradient sums) and, where ``model`` splits the
#: experts, ``ep_gather`` (the expert outputs' all-gathers over ``model``,
#: forward and remat) and ``ep_dispatch`` (the dispatched tokens' gradient
#: sums over ``model``), timed alike
last_comm: Dict[str, CL.CommStats] = {}


class TrainState(NamedTuple):
    params: dict
    opt: OPT.AdamWState


def init_state(cfg: ArchConfig, generator: torch.Generator,
               device=None, policy: Optional[SH.ShardingPolicy] = None
               ) -> TrainState:
    """Seeded parameters (``models.model.init_params``) and a fresh AdamW
    state, on ``device`` (default: the generator's).  Under ``policy``,
    this rank's shards, bitwise ``shard_state`` of the whole state: each
    leaf (each MoE layer) is drawn whole and cut to the rank's block at
    once, and the moments are made at the block's shape, so no rank holds
    the whole state."""
    place = SH.param_placer(policy) if policy is not None else None
    params = M.init_params(cfg, generator, device, place)
    return TrainState(params=params, opt=OPT.init(params))


def value_and_grad(params, batch: Dict, cfg: ArchConfig, *,
                   kv_block: int = 1024, remat: bool = True, tp=None,
                   ep=None):
    """``((total, (ce, aux)), grads)``: ``loss_fn`` and its gradients in
    the parameters' dtypes (zeros for a parameter the loss does not
    reach), as ``jax.value_and_grad(loss_fn, has_aux=True)`` returns.
    Under ``tp`` the parameters are a rank's ``model`` shards; ``ep`` is
    the MoE FFN's context."""
    flat, treedef = TR.flatten_with_path(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    with torch.enable_grad():
        total, (ce, aux) = M.loss_fn(TR.unflatten(treedef, leaves), batch,
                                     cfg, kv_block=kv_block, remat=remat,
                                     tp=tp, ep=ep)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
    return ((total.detach(), (ce.detach(), aux.detach())),
            TR.unflatten(treedef, list(grads)))


def abstract_state(cfg: ArchConfig) -> TrainState:
    """The state's whole shapes and dtypes as ``meta`` tensors, nothing
    drawn (the JAX ``abstract_state``): what the policy's specs and a
    sharded state's restore template are built from."""
    return init_state(cfg, torch.Generator(), "meta")


def make_train_step(cfg: ArchConfig,
                    opt_cfg: OPT.AdamWConfig = OPT.AdamWConfig(),
                    policy: Optional[SH.ShardingPolicy] = None, *,
                    grad_compress: bool = False,
                    grad_codebook: Codebook = GC.DEFAULT_GRAD_CODEBOOK,
                    kv_block: int = 1024, remat: bool = True,
                    donate: bool = False):
    """``step(state, batch) -> (state, metrics)``; metrics are 0-d tensors
    ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``.  With ``policy``
    the step takes the global batch and the state :func:`shard_state`
    places (module docstring); ``grad_compress`` matters only on a policy
    mesh with pods.  ``donate``: the step writes the new state into the
    tensors of the state it is given and returns them (the same bits; the
    JAX ``jit_train_step``'s ``donate_argnums``), so the caller must not
    use the old state again, and a step holds one state, not two."""
    if policy is not None:
        return _sharded_step(cfg, opt_cfg, policy, grad_compress,
                             grad_codebook, kv_block, remat, donate)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        (total, (ce, aux)), grads = value_and_grad(
            state.params, batch, cfg, kv_block=kv_block, remat=remat)
        params, opt, om = OPT.update(opt_cfg, grads, state.opt, state.params,
                                     inplace=donate)
        metrics = {"loss": total, "ce": ce, "aux": aux, **om}
        return TrainState(params=params, opt=opt), metrics

    return step


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def state_specs(policy: SH.ShardingPolicy, like: TrainState) -> TrainState:
    """The specs of a train state of ``like``'s whole shapes: the moments
    shard exactly like their parameters, the step is replicated."""
    ps = policy.param_specs(like.params)
    return TrainState(params=ps, opt=OPT.AdamWState(step=(), m=ps, v=ps))


def placement(cfg: ArchConfig, policy: SH.ShardingPolicy) -> SH.Placement:
    """The train state's placement under ``policy``: what a
    ``Checkpointer`` or ``reshard`` takes to save the gathered state and
    to restore into shards."""
    like = abstract_state(cfg)
    return SH.Placement(policy, state_specs(policy, like), like)


def shard_state(state: TrainState, policy: SH.ShardingPolicy) -> TrainState:
    """This rank's shards of a whole train state (fresh tensors: the whole
    state can be freed)."""
    return SH.shard_tree(state, state_specs(policy, state), policy.mesh)


def gather_state(state: TrainState, policy: SH.ShardingPolicy,
                 like: TrainState, comm: Optional[CL.CommStats] = None
                 ) -> TrainState:
    """The whole train state from every rank's shards (every rank calls
    it); ``like`` carries the whole shapes (:func:`abstract_state`)."""
    return SH.gather_tree(state, state_specs(policy, like), policy.mesh, comm)


def shard_train_step(step_fn, policy: SH.ShardingPolicy, state: TrainState):
    """``(step, placed state)``: where the JAX ``jit_train_step`` compiles
    the step with the policy's in/out shardings, this places the whole
    ``state`` under the policy (:func:`shard_state`); ``step_fn`` is
    ``make_train_step(..., policy=policy)``, which takes the global batch
    and the placed state and returns them so placed."""
    return step_fn, shard_state(state, policy)


def _axis_dim(spec, axis: str) -> Optional[int]:
    for d, e in enumerate(spec):
        if axis in SH.entry_axes(e):
            return d
    return None


def _sum_over(axis: str, idx: List[int], values: List[torch.Tensor],
              policy: SH.ShardingPolicy, comm) -> None:
    """``values[i]`` for ``i`` in ``idx``: summed over ``axis`` in rank
    order (one all-gather of them all)."""
    if not idx:
        return
    parts = CL.Link(policy.mesh.get_group(axis), values[0].device, comm) \
        .all_gather(torch.stack([values[i] for i in idx]))
    for j, i in enumerate(idx):
        values[i] = TP.ordered_sum([p[j] for p in parts])


def sharded_global_norm(grads: List[torch.Tensor], blocks: List[tuple],
                        specs: List[tuple], policy: SH.ShardingPolicy,
                        comm: Optional[CL.CommStats] = None) -> torch.Tensor:
    """The whole tree's gradient norm from this rank's shards ``grads``
    (placed by ``specs``).  It is summed in FSDP blocks whatever the
    layout: a leaf that ``fsdp=True`` would split over ``data`` (its spec
    in ``blocks``) adds its blocks' f32 sums of squares in data-rank order
    (each rank squares its own block, the partial sums are all-gathered
    over ``data``); a leaf split over ``model`` then adds its model
    blocks' sums in model-rank order; every other leaf adds its whole f32
    sum of squares once, leaves in the JAX leaf order.  So FSDP on and off
    clip by bitwise the same norm, every rank by the same norm, and with
    one rank it is ``OPT.global_norm``."""
    mesh, sizes = policy.mesh, policy.sizes
    n = sizes.get("data", 1)
    keep = [n > 1 and _axis_dim(b, "data") is not None for b in blocks]
    sq = []
    for g, b, s, k in zip(grads, blocks, specs, keep):
        if k and _axis_dim(s, "data") is None:
            g = SH.shard_slice(g, SH.restrict(b, ("data",)), mesh)
        sq.append(torch.sum(g.to(torch.float32) ** 2))
    _sum_over("data", [i for i, k in enumerate(keep) if k], sq, policy, comm)
    if sizes.get("model", 1) > 1:
        _sum_over("model", [i for i, b in enumerate(blocks)
                            if _axis_dim(b, "model") is not None],
                  sq, policy, comm)
    total = 0
    for v in sq:
        total = total + v
    return torch.sqrt(total)


def reduce_gradients(grads: List[torch.Tensor], specs: List[tuple],
                     blocks: List[tuple], policy: SH.ShardingPolicy, *,
                     ring: bool = False,
                     comm: Optional[CL.CommStats] = None,
                     partial: Optional[List[bool]] = None) -> List[torch.Tensor]:
    """This rank's part of the gradient mean over the data-parallel ranks
    (``grads``: the gradients of its ``model`` shards, whole over
    ``data``, leaf by leaf; ``specs``: the leaves' placement; ``blocks``:
    their specs under the policy with ``fsdp=True``, the blocks the norm
    is summed in too).  A leaf is
    summed in f32 in rank order over ``data``, then over ``pod`` (raw)
    unless the ring follows (``ring``: the mean is over ``data`` alone),
    and rounded once to its dtype.  A leaf with an FSDP block is
    reduce-scattered into it and, where the leaf itself is replicated,
    its rounded blocks are all-gathered back: about twice the gradient's
    bytes on the wire whatever the data size, the same f32 sums as
    FSDP's.  A leaf too small to split is all-gathered whole.  A leaf
    marked in ``partial`` (a gradient partial on each ``model`` rank) is
    first summed over ``model`` in f32 in rank order, and that f32 sum
    goes on over ``data``: one rounding; every model rank ends with the
    same bits."""
    mesh, sizes, dp = policy.mesh, policy.sizes, policy.dp_axes()
    n_data = sizes["data"] if "data" in dp else 1
    n_pod = sizes["pod"] if "pod" in dp and not ring else 1
    comm = CL.CommStats() if comm is None else comm
    device = grads[0].device
    link_data = (CL.Link(mesh.get_group("data"), device, comm)
                 if n_data > 1 else None)
    link_pod = (CL.Link(mesh.get_group("pod"), device, comm)
                if n_pod > 1 else None)
    partial = partial or [False] * len(grads)
    link_model = (CL.Link(mesh.get_group("model"), device, comm)
                  if any(partial) else None)
    out = []
    for g, spec, block, part in zip(grads, specs, blocks, partial):
        dtype = g.dtype
        if part:
            g = TP.ordered_sum(link_model.all_gather(g))
        d = _axis_dim(block, "data") if n_data > 1 else None
        if d is not None:
            acc = TP.ordered_sum(link_data.all_to_all(
                [b.contiguous() for b in g.chunk(n_data, d)]))
        elif n_data > 1:
            acc = TP.ordered_sum(link_data.all_gather(g))
        else:
            acc = g.to(torch.float32)
        if n_pod > 1:
            acc = TP.ordered_sum(link_pod.all_gather(acc))
        r = (acc / (n_data * n_pod)).to(dtype)
        if d is not None and _axis_dim(spec, "data") is None:
            r = SH.cat_bits(link_data.all_gather(r), d)
        out.append(r)
    return out


def _sharded_step(cfg, opt_cfg, policy, grad_compress, grad_codebook,
                  kv_block, remat, donate):
    mesh, sizes = policy.mesh, policy.sizes
    dp = policy.dp_axes()
    ring = grad_compress and "pod" in dp and sizes["pod"] > 1
    # the MoE routing group, made on the first call (every rank's first
    # step; a group over pod and data is made once)
    route = []
    like = abstract_state(cfg)
    flat, treedef = TR.flatten_with_path(like.params)
    paths = [SH.path_str(p) for p, _ in flat]
    specs = SH.leaf_specs(policy.param_specs(like.params), like.params)
    # FSDP gathers over data only: a rank computes on its model shards
    fsdp_specs = [SH.restrict(s, ("data",)) for s in specs]
    blocks = SH.leaf_specs(
        dataclasses.replace(policy, fsdp=True).param_specs(like.params),
        like.params)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        global last_comm
        comm = {"gather": CL.CommStats(), "reduce": CL.CommStats(),
                "norm": CL.CommStats()}
        mine = {k: SH.shard_slice(
                    x, policy.spec_for_activation("tokens", tuple(x.shape)), mesh)
                for k, x in batch.items()}
        leaves = TR.leaves(state.params)
        device = leaves[0].device
        tp, partial = None, None
        if policy.tp_size() > 1:
            tp = TP.TensorParallel(mesh.get_group("model"), cfg,
                                   attn_fallback=policy.attn_fallback)
            seq = M.input_positions(mine, cfg)
            partial = [TP.partial_leaf(p, tp, seq) for p in paths]
        ep = None
        if cfg.moe is not None:
            if not route:
                route.append(EP.routing_group(policy, ring))
            ep = EP.ExpertParallel(cfg, route[0], tp)
        t0 = time.perf_counter()
        whole = [SH.gather(p, s, mesh, comm["gather"]) if SH.splits(s, sizes)
                 else p for p, s in zip(leaves, fsdp_specs)]
        comm["gather"].seconds = time.perf_counter() - t0
        (total, (ce, aux)), g = value_and_grad(
            TR.unflatten(treedef, whole), mine, cfg, kv_block=kv_block,
            remat=remat, tp=tp, ep=ep)
        del whole
        ctxs = []
        if tp is not None:
            ctxs += [("tp_fwd", tp.fwd), ("tp_bwd", tp.bwd)]
        if ep is not None:
            ctxs += [("route_fwd", ep.fwd), ("route_bwd", ep.bwd)]
            if ep.model is not None:
                ctxs += [("ep_gather", ep.out_gather),
                         ("ep_dispatch", ep.dispatch)]
        for k, c in ctxs:
            c.seconds = c.staging_s + c.wire_s
            comm[k] = c
        t0 = time.perf_counter()
        grads = reduce_gradients(TR.leaves(g), specs, blocks, policy,
                                 ring=ring, comm=comm["reduce"],
                                 partial=partial)
        del g
        comm["reduce"].seconds = time.perf_counter() - t0
        grads = TR.unflatten(treedef, grads)
        if ring:
            grads = GC.compressed_cross_pod_mean_own(grads, mesh,
                                                     codebook=grad_codebook)
        t0 = time.perf_counter()
        gnorm = sharded_global_norm(TR.leaves(grads), blocks, specs, policy,
                                    comm["norm"])
        comm["norm"].seconds = time.perf_counter() - t0
        params, opt, om = OPT.update(opt_cfg, grads, state.opt, state.params,
                                     gnorm=gnorm, inplace=donate)
        m = torch.stack([total, ce, aux]).to("cpu", torch.float32)
        for a in dp:
            if sizes[a] > 1:
                dist.all_reduce(m, group=mesh.get_group(a))
        total, ce, aux = (m / policy.dp_size()).to(device).unbind()
        last_comm = comm
        metrics = {"loss": total, "ce": ce, "aux": aux, **om}
        return TrainState(params=params, opt=opt), metrics

    return step
