"""Multi-pod dry run on fake ranks: every (arch × shape × mesh) cell, with no
card and no allocation (the port of ``repro.launch.dryrun``).

The JAX dry run lowers and compiles each cell's step against
``ShapeDtypeStruct``s on 512 fake host devices and reads XLA's memory and
cost analyses and the collectives of its HLO.  The port has no compiler:
here each cell runs ONE RANK's eager step on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``) over torch's ``fake``
process group, sized to the production mesh (``launch/mesh.py:
make_production_mesh``), and counts

  - FLOPs: ``torch.utils.flop_counter``'s formulas for every product the
    step dispatches, plus each kernel's operations;
  - bytes accessed: the operand and result bytes of every dispatched
    operation that moves data (no view, no uninitialised allocation, no
    metadata query; a scatter its indices and values), unfused, plus each
    kernel's bytes;
  - the peak live bytes of the rank (every storage from its creation to
    its release, the caching allocator's 512-byte rounding on the card's
    path), the rank's parameters, state and inputs included;
  - collective bytes by kind, from the port's own ``Link`` counters.

Nothing is allocated and nothing is computed, so this is no CPU fallback:
no value meant for the card is produced anywhere.  On the card's path
(``device`` "cuda" in a cell) the kernel wrappers take their abstract forms
(``repro_torch.core.abstract``): a prefill traces the flash kernel, a hop
the codec kernels, each crediting its bound's bytes and operations.  The
fake tensors lie on the host (PyTorch built without CUDA cannot index a
fake ``cuda`` tensor), and the card's path is chosen by the abstract run.
Training records autograd, which the same limit bars on fake ``cuda``
tensors; on the card the train step attends through ``chunked_attention``
all the same (the flash kernel has no backward), so its operations are the
card's.  The attention variants (``attn_*``) run on the plain path
(``device`` "cpu"): their knobs act on ``chunked_attention`` and the flash
kernel refuses them.

Ranks played: every rank of a cell runs one program but for its
coordinate, so rank 0 stands for all; where programs differ (the
``xfer_*`` and ``xferonly_*`` cells: pod 0 sends, pod 1 receives) one rank
of each pod is played, the receiver after the sender (it reads the header
its peer posted), and the cell reports the mean FLOPs and bytes a rank and
the larger peak and collective bytes.  The layer stacks are Python loops,
so every cell counts at full depth (``cost_extrapolation_depths`` [L]).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--variant V] [--out out.json]
  python -m repro_torch.launch.dryrun --all --shape prefill_32k --multi-pod --variant xfer_chunked

It needs no card.  Results are cached per cell in ``build/dryrun/`` of the
checkout, so a sweep is resumable; a cached record is read back only when
it was counted by the same source of the package (``code``, a hash of
every module of ``repro_torch``), and ``--no-cache`` recounts.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import json
import math
import os
import time
import traceback
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import roofline as RL
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig, cells,
                                      get_config, shape_applicable)
from repro_torch.core import abstract as AB
from repro_torch.core import tree as TR
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import layers as LAY
from repro_torch.models import model as M

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")


@functools.lru_cache(maxsize=None)
def code_key() -> str:
    """A hash of every module of the package: the key a cached record must
    carry to be read back (a count from other code is recounted)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for d, subdirs, files in sorted(os.walk(root)):
        subdirs.sort()
        for name in sorted(files):
            if name.endswith(".py"):
                path = os.path.join(d, name)
                h.update(os.path.relpath(path, root).encode())
                with open(path, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()[:16]


def _cell_id(arch: str, shape: str, multi_pod: bool, variant: str = "base") -> str:
    return f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}__{variant}"


# policy knobs per variant (the JAX table)
POLICY_VARIANTS = {
    "base": {},
    "noremat": {},
    "gradcomp": {},
    "fsdp": dict(fsdp=True),
    "moe": dict(moe_dispatch_sharding=True),
    "fsdp_moe": dict(fsdp=True, moe_dispatch_sharding=True),
    # PD-transfer variants (prefill shapes, multi-pod mesh): prefill + KV
    # handoff across the pod axis: raw / paper-chunked / global SplitZip
    "xfer_raw": dict(pd_disaggregated=True),
    "xfer_chunked": dict(pd_disaggregated=True),
    "xfer_global": dict(pd_disaggregated=True),
    # isolated KV handoff (no prefill compute): the paper's codec path alone
    "xferonly_raw": dict(pd_disaggregated=True),
    "xferonly_chunked": dict(pd_disaggregated=True),
    "xferonly_global": dict(pd_disaggregated=True),
    "xferonly_tight": dict(pd_disaggregated=True),
    "xferonly_fp32": dict(pd_disaggregated=True),
    # per-chunk sends with double-buffering (TransferPlan n_chunks > 1)
    "xferonly_pipelined": dict(pd_disaggregated=True),
    # attention variants (chunked attention's knobs)
    "attn_bf16": {},
    "attn_kv4096": {},
    "attn_bf16_kv4096": {},
}

# attention-knob overrides per variant (``models/layers.attn_overrides``)
ATTN_VARIANTS = {
    "attn_bf16": dict(score_dtype="bfloat16"),
    "attn_kv4096": dict(kv_block=4096),
    "attn_bf16_kv4096": dict(score_dtype="bfloat16", kv_block=4096),
}


def make_policy(mesh, variant: str) -> SH.ShardingPolicy:
    return SH.ShardingPolicy(mesh, **POLICY_VARIANTS.get(variant, {}))


def _variant_ctx(variant: str):
    """The attention variants' knobs (``layers.attn_overrides``)."""
    kw = ATTN_VARIANTS.get(variant)
    if not kw:
        return contextlib.nullcontext()
    kw = dict(kw)
    if "score_dtype" in kw:
        kw["score_dtype"] = getattr(torch, kw["score_dtype"])
    return LAY.attn_overrides(**kw)


def cell_device(variant: str) -> str:
    """The path a cell traces: the plain one for the attention variants,
    the card's for every other."""
    return "cpu" if variant in ATTN_VARIANTS else "cuda"


# ---------------------------------------------------------------------------
# the fake world and the counters
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int, rank: int):
    """A ``fake`` process group of ``world`` ranks in which this process is
    ``rank``; destroyed on exit (none may be initialised before)."""
    if dist.is_initialized():
        raise RuntimeError("the dry run plays its ranks on a fake group of "
                           "its own; a process group is already initialised")
    # torch's own registration of the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_local_scalar_dense", "_unsafe_view"}
# in-place scatters touch only the entries their indices name: their bytes
# are the indices and values read and the values written, not ``self``
_SCATTERS = {"index_put_", "_index_put_impl_", "index_put", "scatter_",
             "scatter_add_", "scatter_reduce_", "index_add_", "index_copy_",
             "index_fill_", "masked_scatter_", "masked_fill_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Counts the operations dispatched under it (on fake tensors): FLOPs
    of the products (``torch.utils.flop_counter``'s formulas), bytes
    accessed (operands and results of every operation that moves data),
    and the live bytes of every storage made, with their peak.
    ``round_to``: the allocator's block (512 bytes on the card)."""

    def __init__(self, round_to: int = 1):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary
        self.registry = flop_registry
        self.round_to = round_to
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self._storages = WeakIdKeyDictionary()
        self._refs = []

    def _size(self, st) -> int:
        n = st.nbytes()
        r = self.round_to
        return -(-n // r) * r if n else 0

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live from now until it is released."""
        import weakref
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = self._size(st)
        self._storages[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)

        def release(_, n=n):
            self.live -= n
        self._refs.append(weakref.ref(st, release))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if func.namespace == "c10d":
            return out
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if outs and all(t.device.type == "meta" for t in outs):
            return out              # shapes for a plan: no memory, no work
        if packet in self.registry:
            self.flops += float(self.registry[packet](*args, **kwargs,
                                                      out_val=out))
        name = packet.__name__
        if name in _SCATTERS:
            rest = [t for t in tree_flatten((args[1:], kwargs))[0]
                    if isinstance(t, torch.Tensor)]
            self.bytes += 2 * sum(_nbytes(t) for t in rest)
        elif outs and name not in _NO_BYTES and not _is_view(func):
            # (an operation that returns no tensor only reads metadata)
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        for t in outs:
            self.track(t)
        return out


def _fake(tree):
    """Fake tensors of a tree of ``meta`` tensors' shapes and dtypes (under
    the fake mode in force); a NamedTuple state keeps its type."""
    def one(x):
        return torch.empty(tuple(x.shape), dtype=x.dtype)
    if isinstance(tree, torch.Tensor):
        return one(tree)
    flat, treedef = TR.flatten_with_path(tree)
    return TR.unflatten(treedef, [one(x) for _, x in flat])


def _local(tree, specs_tree, sizes):
    """``meta`` tensors of a rank's blocks of ``tree`` under ``specs_tree``."""
    leaves = TR.leaves(tree)
    specs = SH.leaf_specs(specs_tree, tree)
    flat, treedef = TR.flatten_with_path(tree)
    return TR.unflatten(treedef, [
        torch.empty(SH.local_shape(tuple(x.shape), s, sizes), dtype=x.dtype,
                    device="meta") for x, s in zip(leaves, specs)])


def _tree_bytes(tree) -> int:
    return sum(_nbytes(x) for x in TR.leaves(tree))


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Step:
    """A rank's step: ``fn(*args)`` with ``args`` made fake from ``meta``
    stand-ins at the call (so they count as the rank's), and what it
    leaves to read (``observe(out)``, a dict of plain numbers)."""
    fn: object
    args: tuple
    observe: object


def _xfer_config(variant: str, card: bool):
    from repro_torch.serving import sharded as SV
    return SV.transfer_config(variant, backend="cuda" if card else "torch")


def _hop_counts(session, side=None) -> Dict:
    """A hop's unit records: the raw units' bytes and the compressed
    units' bytes as shipped (a fake stream ships every escape slot: its
    capacity)."""
    from repro_torch.serving import collective as CL
    recs = session.last_comm.records if session.last_comm else []
    out = {"units": len(recs),
           "raw_bytes": sum(r[4] for r in recs if r[0] != CL.COMP),
           "comp_bytes": sum(r[4] for r in recs if r[0] == CL.COMP),
           "records": [list(r) for r in recs]}
    if side is not None:
        out["side_bytes"] = side.sent_bytes + side.recv_bytes
    return out


def _comm(stats) -> Dict:
    return {"bytes": stats.sent_bytes, "recv_bytes": stats.recv_bytes,
            "messages": stats.messages}


def _gathers(fs) -> Dict:
    """The FSDP gathers' bytes and all-gathers (``BlockGather``)."""
    return {"bytes": fs.comm.sent_bytes, "recv_bytes": fs.comm.recv_bytes,
            "calls": fs.calls}


def build_step(cfg: ArchConfig, shape: ShapeConfig, policy: SH.ShardingPolicy,
               variant: str = "base", *, card: bool = True,
               num_steps: int = 0, max_seq: Optional[int] = None) -> Step:
    """One rank's step of a cell (the JAX ``build_lowerable``), its prompt
    ``shape.seq_len`` positions over a cache of ``max_seq`` slots (default:
    as many):

    * train: ``make_train_step`` under the policy (``fsdp``, ``noremat``,
      ``gradcomp``), its state donated as the JAX step donates it;
    * prefill: ``serving/sharded.serve`` (its prefill cell); with
      ``num_steps`` its ``prefill_step`` and then ``decode_loop`` over as
      many steps, the prefill's traffic kept apart;
    * decode: one ``serve_step`` over a full-length cache;
    * under ``fsdp`` (``fsdp``, ``fsdp_moe``) the serving steps gather
      each layer's FSDP blocks over ``data`` before its products
      (``serving/sharded.block_gather``; ``gather`` in what they leave);
    * ``xfer_*``: ``serving/sharded.disaggregated_step`` (pod 0 prefills
      and ships its shards; pod 1 receives, and decodes ``num_steps``);
    * ``xferonly_*``: the session's hop alone (``transfer_shard``).

    Arguments are ``meta`` stand-ins of this rank's blocks."""
    from repro_torch.serving import sharded as SV
    from repro_torch.serving.decode import decode_loop, serve_step
    from repro_torch.serving.prefill import prefill_step
    mesh, sizes = policy.mesh, policy.sizes
    b, s = shape.global_batch, shape.seq_len
    m = max_seq or s
    model_group = (mesh.get_group("model").group_name
                   if sizes.get("model", 1) > 1 else None)

    def model_calls() -> int:
        return AB.current().calls.get(model_group, 0) if model_group else 0

    if variant.startswith("xfer"):
        if sizes.get("pod", 1) < 2:
            raise ValueError("transfer variants need the multi-pod mesh")
        tc = _xfer_config(variant, card)
        if variant.startswith("xferonly"):
            sess = SV.hop_plan(cfg, policy, tc, b, m).session(device="cpu")
            cache = SV.cache_like(cfg, b, m)
            src = mesh.get_local_rank("pod") == sess.plan.src_pod
            block = _local(cache, policy.cache_specs(cache), sizes)

            def hop(cache):
                sess.transfer_shard(cache if src else None)
                return sess
            return Step(hop, (block if src else None,), lambda out: {
                "hop": _hop_counts(out),
                "held": {"cache": _tree_bytes(block)}})
        if shape.kind != "prefill":
            raise ValueError("transfer variants apply to prefill shapes")
        params = M.init_params(cfg, torch.Generator(), "meta",
                               SH.param_placer(policy))

        def xfer(params, batch):
            calls0 = model_calls()
            res = SV.disaggregated_step(params, batch, cfg, policy, tc,
                                        max_seq=m, num_steps=num_steps,
                                        device="cpu")
            return res, model_calls() - calls0

        def seen(out):
            res, calls = out
            cache = res.prefill.state.cache if res.pod == 0 else res.received
            return {"pod": res.pod, "tp_fwd": _comm(res.tp.fwd),
                    "model_calls": calls, "gather": _gathers(res.fsdp),
                    "hop": _hop_counts(res.session, res.side),
                    "held": {"params": _tree_bytes(params),
                             "cache": _tree_bytes(cache)}}
        return Step(xfer, (params, M.input_specs(cfg, shape)), seen)

    if shape.kind == "train":
        from repro_torch.training import optimizer as OPT
        from repro_torch.training import train_step as TS
        step = TS.make_train_step(cfg, OPT.AdamWConfig(), policy,
                                  grad_compress=(variant == "gradcomp"),
                                  remat=(variant != "noremat"),
                                  donate=True)
        params = M.init_params(cfg, torch.Generator(), "meta",
                               SH.param_placer(policy))
        state = TS.TrainState(params=params, opt=OPT.init(params))

        def train(state, batch):
            return step(state, batch)
        return Step(train, (state, M.input_specs(cfg, shape)),
                    lambda out: {"held": {"state": _tree_bytes(state)}})

    params = M.init_params(cfg, torch.Generator(), "meta",
                           SH.param_placer(policy))
    if shape.kind == "prefill" and not num_steps:
        def prefill(params, batch):
            return SV.serve(params, batch, cfg, policy, max_seq=m,
                            num_steps=0)
        return Step(prefill, (params, M.input_specs(cfg, shape)),
                    lambda res: {"tp_fwd": _comm(res.tp.fwd),
                                 "gather": _gathers(res.fsdp), "held": {
                        "params": _tree_bytes(params),
                        "cache": _tree_bytes(res.prefill.state.cache)}})
    if shape.kind == "prefill":
        def serve(params, batch):
            tp = SV.tensor_parallel(policy, cfg)
            ep = SV.expert_parallel(policy, cfg, tp)
            fs = SV.block_gather(policy, cfg)
            pre = prefill_step(params, SV.local_batch(batch, policy), cfg,
                               max_seq=m, tp=tp, ep=ep, fsdp=fs)
            marks = {"prefill_fwd": _comm(tp.fwd),
                     "prefill_gather": _gathers(fs),
                     "held": {"params": _tree_bytes(params),
                              "cache": _tree_bytes(pre.state.cache)}}
            calls0 = model_calls()
            if not cfg.encoder_only:
                decode_loop(params, pre.first_token, pre.state, cfg,
                            num_steps, tp=tp, max_seq=m, ep=ep, fsdp=fs)
            marks["model_calls"] = model_calls() - calls0
            marks["tp_fwd"] = _comm(tp.fwd)
            marks["gather"] = _gathers(fs)
            return marks
        return Step(serve, (params, M.input_specs(cfg, shape)),
                    lambda marks: marks)

    # decode: one step over a full-length cache
    like = M.abstract_state(cfg, b, m)
    cache = _local(like.cache, policy.cache_specs(like.cache), sizes)
    rows = SH.local_shape((b,), policy.spec_for_activation("tokens", (b,)),
                          sizes)
    toks = torch.empty(rows + (1,), dtype=torch.int32, device="meta")
    lens = torch.empty(rows, dtype=torch.int32, device="meta")

    def decode(params, tokens, cache, cache_len):
        from repro_torch.models.kvcache import DecodeState
        tp = SV.tensor_parallel(policy, cfg)
        ep = SV.expert_parallel(policy, cfg, tp)
        fs = SV.block_gather(policy, cfg)
        serve_step(params, tokens, DecodeState(cache=cache,
                                               cache_len=cache_len),
                   cfg, tp=tp, max_seq=m, ep=ep, fsdp=fs)
        return tp, fs
    return Step(decode, (params, toks, cache, lens),
                lambda out: {"tp_fwd": _comm(out[0].fwd),
                             "gather": _gathers(out[1]), "held": {
                                 "params": _tree_bytes(params),
                                 "cache": _tree_bytes(cache)}})


# ---------------------------------------------------------------------------
# playing a rank
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RankCount:
    """What one played rank's step counted."""
    rank: int
    coord: Dict[str, int]
    flops: float
    bytes: float
    peak_bytes: int
    collectives: Dict[str, float]
    kernels: Dict[str, Dict[str, float]]
    seen: Dict
    seconds: float
    ops: int


def play(cfg: ArchConfig, shape: ShapeConfig, mesh_shape, axes, rank: int,
         variant: str = "base", *, run: Optional[AB.Run] = None,
         card: Optional[bool] = None, num_steps: int = 0,
         max_seq: Optional[int] = None) -> RankCount:
    """Play ``rank`` of a fake world of ``mesh_shape`` (``axes``) through
    the cell's step (:func:`build_step`) and count it.  ``run`` carries
    the headers earlier played ranks posted (default: a fresh run);
    ``card`` the path (default: :func:`cell_device`'s)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    card = cell_device(variant) == "cuda" if card is None else card
    run = run if run is not None else AB.Run(card=card)
    run.card = card
    world = math.prod(mesh_shape)
    t0 = time.perf_counter()
    with fake_world(world, rank):
        multi = (tuple(mesh_shape), tuple(axes)) == production_axes(True)
        mesh = (make_production_mesh(multi_pod=multi)
                if multi or (tuple(mesh_shape), tuple(axes)) ==
                production_axes(False) else make_mesh(mesh_shape, axes))
        policy = make_policy(mesh, variant)
        step = build_step(cfg, shape, policy, variant, card=card,
                          num_steps=num_steps, max_seq=max_seq)
        kernels0 = {k: dict(v) for k, v in run.kernels.items()}
        colls0 = dict(run.collectives)
        counter = Counter(round_to=512 if card else 1)
        with FakeTensorMode(allow_non_fake_inputs=True), \
                AB.tracing(run), _variant_ctx(variant), counter:
            args = tuple(None if a is None else _fake(a) for a in step.args)
            out = step.fn(*args)
            seen = step.observe(out)
            del out, args
        coord = SH.coordinate(mesh)
    kernels = {}
    for k, v in run.kernels.items():
        base = kernels0.get(k, {"launches": 0, "bytes": 0.0, "ops": 0.0})
        d = {f: v[f] - base[f] for f in ("launches", "bytes", "ops")}
        if d["launches"]:
            kernels[k] = d
    colls = {k: run.collectives.get(k, 0.0) - colls0.get(k, 0.0)
             for k in RL.COLLECTIVES}
    return RankCount(
        rank=rank, coord=coord,
        flops=counter.flops + sum(v["ops"] for v in kernels.values()),
        bytes=counter.bytes + sum(v["bytes"] for v in kernels.values()),
        peak_bytes=counter.peak, collectives=colls,
        kernels=kernels, seen=seen, seconds=time.perf_counter() - t0,
        ops=counter.ops)


def production_axes(multi_pod: bool):
    return (((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else ((16, 16), ("data", "model")))


def played_ranks(variant: str, mesh_shape) -> List[int]:
    """Rank 0, and where pods run different programs (the transfer
    variants) the rank of pod 1 at the same (data, model) coordinate."""
    if variant.startswith("xfer"):
        return [0, math.prod(mesh_shape[1:])]
    return [0]


def measure(cfg: ArchConfig, shape: ShapeConfig, multi_pod: bool,
            variant: str = "base") -> Dict:
    """Play the cell's ranks and combine their counts: mean FLOPs and bytes
    a rank (each played rank stands for an equal share of the mesh), the
    larger peak and collective bytes."""
    mesh_shape, axes = production_axes(multi_pod)
    run = AB.Run(card=cell_device(variant) == "cuda")
    ranks = [play(cfg, shape, mesh_shape, axes, r, variant, run=run)
             for r in played_ranks(variant, mesh_shape)]
    top = max(ranks, key=lambda r: sum(r.collectives.values()))
    return {
        "ranks": ranks, "mesh_shape": mesh_shape, "axes": axes,
        "flops": sum(r.flops for r in ranks) / len(ranks),
        "bytes": sum(r.bytes for r in ranks) / len(ranks),
        "peak_bytes": max(r.peak_bytes for r in ranks),
        "colls": dict(top.collectives),
    }


def predict(cfg: ArchConfig, mesh_shape, variant: str = "base", *,
            batch: int, prompt: int, max_seq: int,
            num_steps: int = 1) -> List[RankCount]:
    """What each rank of a served world counts, played in rank order (pod
    0's senders before pod 1's receivers) on a ``(pod, data, model)``
    mesh of ``mesh_shape``: a ``prompt``-position prompt of ``batch`` rows
    over ``max_seq`` cache slots; ``base`` prefills and decodes
    ``num_steps`` tokens (the prefill's traffic apart, ``prefill_fwd``),
    an ``xfer_*`` variant runs the disaggregated step (pod 1 decoding
    ``num_steps``); ``fsdp`` serves as ``base`` on FSDP blocks.  Each
    rank's ``seen``: held parameter and cache bytes, ``tp.fwd``, the
    collectives over ``model`` in the decode steps, the FSDP gathers
    (``gather``; the prefill's apart, ``prefill_gather``), and a hop's unit
    records."""
    shape = ShapeConfig("predict", seq_len=prompt, global_batch=batch,
                        kind="prefill")
    run = AB.Run(card=True)
    return [play(cfg, shape, tuple(mesh_shape), ("pod", "data", "model"), r,
                 variant, run=run, card=True, num_steps=num_steps,
                 max_seq=max_seq) for r in range(math.prod(mesh_shape))]


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _rank_dict(r: RankCount) -> Dict:
    """A played rank's counts for the cell's record (a hop's unit records
    summed, not listed)."""
    d = dataclasses.asdict(r)
    if "hop" in d["seen"]:
        d["seen"]["hop"].pop("records")
    return d


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "base", cache: bool = True) -> Dict:
    """One cell's record (the JAX ``run_cell``'s keys, plus ``device``, the
    path traced, ``ranks_played`` and ``code``, the :func:`code_key` it was
    counted by), cached in ``build/dryrun/`` and read back under the same
    key alone."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    cid = _cell_id(arch, shape_name, multi_pod, variant)
    cpath = os.path.join(RESULTS_DIR, cid + ".json")
    if cache and os.path.exists(cpath):
        with open(cpath) as f:
            cached = json.load(f)
        if cached.get("code") == code_key():
            return cached

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        result = {"cell": cid, "status": "skipped", "reason": why,
                  "code": code_key()}
        with open(cpath, "w") as f:
            json.dump(result, f)
        return result

    t0 = time.time()
    try:
        meas = measure(cfg, shape, multi_pod, variant)
        t_cost = time.time() - t0
        ranks = meas["ranks"]
        chips = math.prod(meas["mesh_shape"])
        desc = " × ".join(f"{a}={n}" for a, n in zip(
            meas["axes"], meas["mesh_shape"])) + f"  ({chips} ranks, fake)"
        mem_stats = {"peak_bytes": meas["peak_bytes"],
                     "argument_bytes": max(sum(v for v in r.seen.get(
                         "held", {}).values()) for r in ranks)}
        report = RL.build_report(arch, shape, desc, chips,
                                 {"flops": meas["flops"],
                                  "bytes accessed": meas["bytes"]},
                                 cfg, mem_stats, colls=meas["colls"])
        result = {
            "cell": cid, "status": "ok",
            "t_lower_s": 0.0, "t_compile_s": 0.0,
            "t_costmeasure_s": t_cost,
            "mesh": desc,
            "memory": mem_stats,
            "cost": {"flops": meas["flops"], "bytes accessed": meas["bytes"]},
            "cost_extrapolation_depths": [cfg.num_layers],
            "roofline": report.to_dict(),
            "roofline_scanraw": report.to_dict(),
            "device": cell_device(variant),
            "ranks_played": [_rank_dict(r) for r in ranks],
            "fits": report.fits,
            "roofline_device": report.device.name,
            "code": code_key(),
        }
    except Exception as e:  # a failure here is a fault of the port
        result = {"cell": cid, "status": "error",
                  "error": f"{type(e).__name__}: {e}",
                  "trace": traceback.format_exc()[-2000:],
                  "code": code_key()}
    with open(cpath, "w") as f:
        json.dump(result, f, indent=1)
    return result


def table_row(r: Dict) -> str:
    """A cell's markdown row: peak GB a rank and whether it fits the
    device, the three roofline terms (s), the bottleneck and the useful
    FLOPs ratio."""
    rl, peak = r["roofline"], r["memory"]["peak_bytes"]
    return (f"| {r['cell']} | {peak / 1e9:.2f} | "
            f"{'yes' if r['fits'] else 'no'} | {rl['t_compute']:.4g} | "
            f"{rl['t_memory']:.4g} | {rl['t_collective']:.4g} | "
            f"{rl['bottleneck']} | {rl['useful_flops_ratio']:.3f} |")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--table", action="store_true",
                    help="end with a markdown row a cell (PERF.md)")
    args = ap.parse_args(argv)

    if args.all:
        # --shape with --all keeps that shape's cells (the transfer
        # variants apply to prefill shapes alone)
        todo = [(a, s) for (a, s) in cells()
                if args.shape is None or s == args.shape]
    else:
        todo = [(args.arch, args.shape)]

    results = []
    for arch, shape in todo:
        r = run_cell(arch, shape, args.multi_pod, args.variant,
                     cache=not args.no_cache)
        status = r["status"]
        extra = ""
        if status == "ok":
            rl = r["roofline"]
            extra = (f" bottleneck={rl['bottleneck']}"
                     f" frac={rl['roofline_fraction']:.3f}"
                     f" mem/rank={(r['memory'].get('peak_bytes') or 0)/2**30:.2f}GiB"
                     f" count={r['t_costmeasure_s']:.0f}s")
        elif status == "error":
            extra = " " + r["error"][:160]
        print(f"[{status:>7}] {r['cell']}{extra}", flush=True)
        results.append(r)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if args.table:
        for r in results:
            if r["status"] == "ok":
                print(table_row(r))
    n_err = sum(1 for r in results if r["status"] == "error")
    print(f"done: {len(results)} cells, {n_err} errors")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
