"""Rank bodies for the port's multi-process tests (gloo on the CPU).

Not a test module: ``tests/test_torch_{mesh,ring}.py`` spawn these with
:func:`run_world`.  Each rank loads the JAX reference's ``.npz`` / ``.json``
written by a JAX subprocess, runs the port's collective executors on the
same inputs, asserts rank by rank, and writes a JSON summary the parent
test reads.  Only torch, numpy and ``repro_torch`` are imported here, so
a spawned rank never starts JAX.
"""

from __future__ import annotations

import dataclasses
import json
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import backend as TB
from repro_torch.core import tree as TR
from repro_torch.core.codebook import Codebook
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving import collective as CL
from repro_torch.serving.plan import TransferConfig, TransferPlan
from repro_torch.serving.transfer import transfer_cache_cross_pod
from repro_torch.training import grad_compress as GC

_INT = {1: torch.int8, 2: torch.int16, 4: torch.int32}
_NP_INT = {1: np.int8, 2: np.int16, 4: np.int32}


def run_world(fn, world: int, tmp_path: Path, *args, timeout: float = 180.0):
    """Spawn ``world`` ranks of ``fn(rank, world, store, *args)`` and wait at
    most ``timeout`` seconds; a rank's exception fails the caller."""
    store = str(tmp_path / "store")
    ctx = mp.start_processes(fn, args=(world, store) + args, nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world}-rank world still running after "
                               f"{timeout} s")


def _init(rank: int, world: int, store: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=90))


def to_torch(bits: np.ndarray, dtype: str) -> torch.Tensor:
    """JAX container bits (unsigned numpy) -> a torch tensor of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(bits).view(_NP_INT[bits.dtype.itemsize]))
    return t.view(getattr(torch, dtype))


def as_bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(_INT[x.element_size()]).numpy()


def _slice(x, spec, mesh, sizes):
    for d, a in enumerate(spec):
        if a is not None:
            size = x.shape[d] // sizes[a]
            x = x[(slice(None),) * d
                  + (slice(mesh.get_local_rank(a) * size,
                           (mesh.get_local_rank(a) + 1) * size),)]
    return x


def jax_permute_bytes(lp: TransferPlan, records) -> int:
    """The bytes the JAX mesh body permutes for the same units.  Two pinned
    differences a compressed unit: the JAX body ships its whole
    fixed-capacity escape buffers (3 bytes a slot, 5 for the global
    layout), where the port ships the used slots only; and XLA drops the
    permutes of the escape counts and the ``ok`` flag (its decode reads
    positions, not counts), which the port ships (4 bytes a row and 1):
    the counts say which slots are used."""
    if lp.n_chunks:
        sizes = [s.n_elements for s in lp.segments] + [
            r.n_elements for r in lp.routes
            if r.route in ("fp32_hilo", "fp8", "raw")]
    else:
        sizes = [r.n_elements for r in lp.routes]
    total = 0
    for rec, n in zip(records, sizes):
        total += rec[4]
        if rec[0] == CL.COMP:
            rows = 1 if rec[1] else -(-n // lp.tc.chunk)
            total += (rows * rec[2] - rec[3]) * (5 if rec[1] else 3)
            total -= 4 * rows + 1
    return total


def _count_decodes():
    """Count every decode the torch backend runs in this process."""
    calls = {"n": 0}
    for name in ("decode", "decode_bits"):
        orig = getattr(TB.TorchBackend, name)

        def wrapped(self, comp, _orig=orig):
            calls["n"] += 1
            return _orig(self, comp)
        setattr(TB.TorchBackend, name, wrapped)
    return calls


# ---------------------------------------------------------------------------
# the mesh executor
# ---------------------------------------------------------------------------

def mesh_world(rank, world, store, ref_dir, shape, out_dir, noisy):
    _init(rank, world, store)
    try:
        summary = _mesh_cases(shape, Path(ref_dir), noisy)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(summary))
        dist.barrier()   # no rank tears its connections down under a peer
    finally:
        dist.destroy_process_group()


def _mesh_cases(shape, ref_dir: Path, noisy: bool):
    ref = np.load(ref_dir / "mesh.npz")
    meta = json.loads((ref_dir / "mesh.json").read_text())
    cb = Codebook.from_json(meta["codebook"])
    group = "in_noisy" if noisy else "in"
    cache = {k: to_torch(ref[f"{group}/{k}"], meta["dtypes"][group][k])
             for k in meta["dtypes"][group]}
    mesh = make_mesh(shape, ("pod", "data", "model"))
    sizes = dict(zip(mesh.mesh_dim_names, shape))
    name = "x".join(map(str, shape))
    pod = mesh.get_local_rank("pod")
    decodes = _count_decodes()
    summary = {"pod": pod, "cases": {}, "specs": [
        list(TransferPlan._default_leaf_spec(x, mesh)) for x in TR.leaves(cache)]}
    for n_chunks in (1, 4):
        key = f"{name}/n{n_chunks}" + ("noisy" if noisy else "")
        tc = TransferConfig(codebook=cb, chunk=256, cap=16, n_chunks=n_chunks,
                            compress_fp32=True)
        plan = TransferPlan.build(cache, tc, mesh=mesh)
        assert "target=mesh(pod 0->1)" in plan.describe()
        sess = plan.session(device="cpu")
        before = decodes["n"]
        shard = sess.transfer(cache if pod == 0 else None, select_dst=False)
        case = {"decodes": decodes["n"] - before,
                "stats": dataclasses.asdict(sess.last_stats),
                "sent": sess.last_comm.sent_bytes,
                "received": sess.last_comm.recv_bytes,
                "jax_bytes": jax_permute_bytes(sess._shard_session.plan,
                                               sess.last_comm.records)}
        if pod == 0:
            assert shard is None
        else:
            jax_equal = True
            for (k, x), spec in zip(sorted(cache.items()), plan.in_specs):
                got = as_bits(shard[k])
                assert np.array_equal(got, as_bits(_slice(x, spec, mesh, sizes))), k
                jax_out = torch.from_numpy(ref[f"out/{key}/{k}"].view(
                    _NP_INT[x.element_size()]))
                jax_equal &= np.array_equal(
                    got, _slice(jax_out, spec, mesh, sizes).contiguous().numpy())
            case["jax_equal"] = jax_equal
        # select_dst=True: the whole cache on every destination rank
        whole = plan.session(device="cpu").transfer(
            cache if pod == 0 else None, select_dst=True)
        if pod == 0:
            assert whole is None
        else:
            for k, x in cache.items():
                assert np.array_equal(as_bits(whole[k]), as_bits(x)), k
        summary["cases"][key] = case
    if not noisy:
        # the shim over a one-shot mesh plan: the same hop
        tc = TransferConfig(codebook=cb, chunk=256, cap=16, compress_fp32=True)
        out = transfer_cache_cross_pod(cache, mesh, tc, device="cpu")
        assert (out is None) == (pod == 0)
        if out is not None:
            for k, x in cache.items():
                assert np.array_equal(as_bits(out[k]), as_bits(x)), k
    return summary


def mesh_policy_world(rank, world, store, ref_dir, out_dir):
    _init(rank, world, store)
    try:
        summary = _mesh_policy_case(Path(ref_dir))
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(summary))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _mesh_policy_case(ref_dir: Path):
    """The pd_disaggregated policy's cache specs through the mesh hop."""
    from repro_torch.distributed.sharding import ShardingPolicy
    ref = np.load(ref_dir / "mesh.npz")
    meta = json.loads((ref_dir / "mesh.json").read_text())
    cb = Codebook.from_json(meta["codebook"])
    cache = {k: to_torch(ref[f"in/{k}"], "bfloat16") for k in ("k", "v")}
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
    policy = ShardingPolicy(mesh, pd_disaggregated=True)
    pod = mesh.get_local_rank("pod")
    sizes = dict(zip(mesh.mesh_dim_names, (2, 2, 1)))
    summary = {"pod": pod, "jax_equal": [], "sent": 0}
    for n_chunks in (1, 4):
        tc = TransferConfig(codebook=cb, chunk=256, cap=16, n_chunks=n_chunks)
        plan = TransferPlan.build(cache, tc, mesh=mesh,
                                  specs=policy.cache_specs(cache))
        summary["in_specs"] = [list(s) for s in plan.in_specs]
        sess = plan.session(device="cpu")
        shard = sess.transfer(cache if pod == 0 else None, select_dst=False)
        summary["sent"] += sess.last_comm.sent_bytes
        if pod == 1:
            ok = True
            for (k, x), spec in zip(sorted(cache.items()), plan.in_specs):
                got = as_bits(shard[k])
                ok &= np.array_equal(got, as_bits(_slice(x, spec, mesh, sizes)))
                jax_out = torch.from_numpy(ref[f"out/pd/n{n_chunks}/{k}"]
                                           .view(np.int16))
                ok &= np.array_equal(got, _slice(jax_out, spec, mesh, sizes)
                                     .contiguous().numpy())
            summary["jax_equal"].append(bool(ok))
    whole = plan.session(device="cpu").transfer(cache if pod == 0 else None)
    if pod == 1:
        summary["whole_equal"] = all(np.array_equal(as_bits(whole[k]),
                                                    as_bits(x))
                                     for k, x in cache.items())
    return summary


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def ring_world(rank, world, store, ref_dir, out_dir):
    _init(rank, world, store)
    try:
        summary = _ring_cases(rank, Path(ref_dir))
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(summary))
        dist.barrier()   # no rank tears its connections down under a peer
    finally:
        dist.destroy_process_group()


def _ring_cases(rank: int, ref_dir: Path):
    ref = np.load(ref_dir / "ring.npz")
    meta = json.loads((ref_dir / "ring.json").read_text())
    mesh = make_mesh((4,), ("pod",))

    def tree(name):
        return {k: to_torch(ref[f"in/{name}/{k}"], "bfloat16")
                for k in meta["keys"][name]}

    def same_as_jax(out, name):
        for k, x in out.items():
            assert np.array_equal(as_bits(x), ref[f"out/{name}/{k}"][rank]
                                  .view(np.int16)), (name, k)

    summary = {}
    small = tree("small")
    mean = {k: torch.mean(g.float(), 0).to(g.dtype) for k, g in small.items()}
    for tag, kw in (("raw", {"compress": False}),
                    ("comp", {"codebook": Codebook.from_json(meta["codebook"])})):
        out = GC.compressed_cross_pod_mean(small, mesh, **kw)
        same_as_jax(out, f"small/{tag}")
        for k, x in out.items():
            assert np.array_equal(as_bits(x), as_bits(mean[k])), k
        summary[f"small/{tag}"] = dataclasses.asdict(GC.last_stats)
    cb_n = Codebook.from_json(meta["codebook_normal"])
    out = GC.compressed_cross_pod_mean(tree("normal"), mesh, codebook=cb_n)
    same_as_jax(out, "normal")
    summary["normal"] = dataclasses.asdict(GC.last_stats)
    wide = tree("wide")
    sess = TransferPlan.build(wide, TransferConfig(codebook=cb_n, chunk=256,
                                                   cap=8),
                              mesh=mesh, specs=(("pod",),) * 2).session()
    out = sess.ring_reduce(wide, ratio=1.3)
    same_as_jax(out, "wide")
    summary["wide"] = dataclasses.asdict(sess.last_stats)
    summary["wide_hops"] = len(sess.last_comm.hop_s)
    summary["wide_sent"] = sess.last_comm.sent_bytes
    return summary


def _keystr(path) -> str:
    """A port tree path as JAX's ``keystr`` prints it."""
    return "".join(c if c.startswith((".", "[")) else f"['{c}']" for c in path)


def train_world(rank, world, store, ref_dir, out_dir):
    _init(rank, world, store)
    try:
        summary, arrays = _train_case(rank, world, Path(ref_dir))
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(summary))
        if rank == 0:
            np.savez(Path(out_dir) / "rank0.npz", **arrays)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _train_case(rank: int, world: int, ref_dir: Path):
    """One ``grad_compress`` train step of the reduced smollm from the JAX
    reference's state and batch, under the policy of a mesh of pods (the
    launcher's path); the ring's output is recorded and held bitwise
    against the f32 mean of both pods' gradients computed here."""
    import hashlib

    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_step as TS
    ref = np.load(ref_dir / "gc.npz")
    cfg = get_config("smollm-135m").reduced()
    like = TS.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    flat, treedef = TR.flatten_with_path(like)
    leaves = []
    for path, x in flat:
        a = ref["state/" + _keystr(path)]
        leaves.append(to_torch(a, "bfloat16") if x.dtype == torch.bfloat16
                      else torch.from_numpy(np.array(a)))
    state = TR.unflatten(treedef, leaves)
    toks = torch.from_numpy(ref["tokens"])
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    mesh = make_mesh((world,), ("pod",))
    seen = []
    orig = GC.compressed_cross_pod_mean_own

    def recording(own, *a, **k):
        seen.append((own, orig(own, *a, **k)))
        return seen[-1][1]

    GC.compressed_cross_pod_mean_own = recording
    try:
        step = TS.make_train_step(
            cfg, OPT.AdamWConfig(lr=3e-4, total_steps=2, warmup_steps=1),
            ShardingPolicy(mesh), grad_compress=True, kv_block=32)
        new, metrics = step(state, batch)
    finally:
        GC.compressed_cross_pod_mean_own = orig
    ((own, avg),) = seen
    # the own-row entry against the JAX-shaped one: rank r's row of a
    # stacked tree whose other rows the ring never reads
    own_stats = dataclasses.asdict(GC.last_stats)
    stacked = TR.unflatten(TR.flatten_with_path(own)[1], [
        torch.zeros((world,) + tuple(x.shape), dtype=x.dtype).index_copy(
            0, torch.tensor([rank]), x[None]) for x in TR.leaves(own)])
    via_stacked = GC.compressed_cross_pod_mean(stacked, mesh)
    own_matches_stacked = all(
        np.array_equal(as_bits(a), as_bits(b))
        for a, b in zip(TR.leaves(avg), TR.leaves(via_stacked))) and \
        dataclasses.asdict(GC.last_stats) == own_stats
    half = batch["tokens"].shape[0] // world
    pods = [TS.value_and_grad(state.params, {k: v[i * half:(i + 1) * half]
                                             for k, v in batch.items()},
                              cfg, kv_block=32)[1] for i in range(world)]
    mean_bitwise = all(
        np.array_equal(as_bits(g), as_bits((sum(p.float() for p in ps) / world)
                                           .to(g.dtype)))
        for g, *ps in zip(TR.leaves(avg), *(TR.leaves(p) for p in pods)))
    sha = hashlib.sha256()
    for x in TR.leaves(new.params):
        sha.update(as_bits(x).tobytes())
    arrays = {}
    for path, x in TR.flatten_with_path(avg)[0]:
        arrays["grads/" + _keystr(path)] = x.float().numpy()
    for path, x in TR.flatten_with_path(new.params)[0]:
        arrays["params/" + _keystr(path)] = x.float().numpy()
    summary = dict(
        loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
        lr=float(metrics["lr"]), leaf_ok=GC.last_stats.leaf_ok,
        mean_bitwise=bool(mean_bitwise), params_sha=sha.hexdigest(),
        own_matches_stacked=bool(own_matches_stacked),
        grads_bf16=all(g.dtype == p.dtype for g, p in
                       zip(TR.leaves(avg), TR.leaves(state.params))))
    return summary, arrays


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

def _state_from_ref(ref, cfg):
    """The JAX reference's initial train state (``state/<keystr>`` bits)."""
    from repro_torch.training import train_step as TS
    like = TS.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    flat, treedef = TR.flatten_with_path(like)
    leaves = []
    for path, x in flat:
        a = ref["state/" + _keystr(path)]
        leaves.append(to_torch(a, "bfloat16") if x.dtype == torch.bfloat16
                      else torch.from_numpy(np.array(a)))
    return TR.unflatten(treedef, leaves)


def _sha(tree) -> str:
    import hashlib
    sha = hashlib.sha256()
    for x in TR.leaves(tree):
        sha.update(as_bits(x).tobytes())
    return sha.hexdigest()


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in TR.leaves(tree))


def shard_train_world(rank, world, store, ref_dir, out_dir, arch, shape,
                      kv_block, grad_compress):
    _init(rank, world, store)
    try:
        summary, arrays = _shard_train_cases(Path(ref_dir), Path(out_dir), arch,
                                             tuple(shape), kv_block, grad_compress)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(summary))
        if rank == 0:
            np.savez(Path(out_dir) / "rank0.npz", **arrays)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _shard_train_cases(ref_dir: Path, out_dir: Path, arch, shape, kv_block,
                       grad_compress):
    """The JAX reference's steps through the sharded step, FSDP on and
    off: per run the metrics, the gathered state's bits and its hash, the
    bytes this rank holds against the spec arithmetic, and (FSDP on) a
    checkpoint through a placed ``Checkpointer``."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import checkpoint as CKPT
    from repro_torch.distributed import elastic as EL
    from repro_torch.distributed import sharding as SH
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_step as TS
    ref = np.load(ref_dir / "shard.npz")
    meta = json.loads((ref_dir / "shard.json").read_text())
    cfg = get_config(arch).reduced()
    state0 = _state_from_ref(ref, cfg)
    like = TS.abstract_state(cfg)
    opt_cfg = OPT.AdamWConfig(**meta["opt"])
    mesh = make_mesh(shape, ("pod", "data", "model"))
    summary, arrays = {"runs": {}}, {}
    for fsdp in (True, False):
        policy = SH.ShardingPolicy(mesh, fsdp=fsdp)
        step, placed = TS.shard_train_step(
            TS.make_train_step(cfg, opt_cfg, policy=policy,
                               grad_compress=grad_compress, kv_block=kv_block),
            policy, state0)
        specs = TS.state_specs(policy, like)
        run = {"held": {k: _nbytes(getattr(placed.opt, k) if k != "params"
                                   else placed.params)
                        for k in ("params", "m", "v")},
               "spec_bytes": {
                   "params": SH.held_bytes(like.params, specs.params,
                                           policy.sizes),
                   "m": SH.held_bytes(like.opt.m, specs.opt.m, policy.sizes),
                   "v": SH.held_bytes(like.opt.v, specs.opt.v, policy.sizes)},
               "moments_like_params": all(
                   tuple(m.shape) == tuple(p.shape) == tuple(v.shape)
                   for p, m, v in zip(TR.leaves(placed.params),
                                      TR.leaves(placed.opt.m),
                                      TR.leaves(placed.opt.v))),
               "split_leaves": sum(SH.splits(s, policy.sizes) for s in
                                   SH.leaf_specs(specs.params, like.params)),
               "metrics": []}
        for i in range(len(meta["batches"])):
            toks = torch.from_numpy(ref[f"batch{i}"])
            batch = {"tokens": toks[:, :-1].contiguous(),
                     "labels": toks[:, 1:].contiguous()}
            placed, metrics = step(placed, batch)
            run["metrics"].append({k: float(v) for k, v in metrics.items()})
        run["comm"] = {k: c.sent_bytes for k, c in TS.last_comm.items()}
        whole = TS.gather_state(placed, policy, like)
        run["sha"] = _sha(whole)
        tag = "fsdp" if fsdp else "replicated"
        for path, x in TR.flatten_with_path(whole)[0]:
            arrays[f"{tag}/{_keystr(path)}"] = as_bits(x)
        if fsdp:
            ckpt = CKPT.Checkpointer(str(out_dir / "ckpt"), device="cpu",
                                     placement=TS.placement(cfg, policy))
            ckpt.save(len(meta["batches"]), placed, extra={"arch": cfg.name})
            back, extra, s = ckpt.restore(None)
            run["restored_shards_bitwise"] = (
                s == len(meta["batches"]) and extra == {"arch": cfg.name}
                and _sha(back) == _sha(placed))
            moved, _ = EL.reshard(whole, None, EL.MeshPlan(shape, (
                "pod", "data", "model"), 0.0), device="cpu",
                placement=TS.placement(cfg, policy))
            run["reshard_shards_bitwise"] = _sha(moved) == _sha(placed)
        summary["runs"][tag] = run
    return summary, arrays


def reduce_world(rank, world, store, out_dir):
    """The sharded step's gradient reduction on mesh (1, world, 1), FSDP
    on and off, on seeded gradients of every rank, against their f32
    rank-order mean; then a placed ``Checkpointer`` whose write fails on
    rank 0."""
    _init(rank, world, store)
    try:
        summary = _reduce_cases(rank, world, Path(out_dir))
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(summary))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _reduce_cases(rank, world, out_dir: Path):
    from repro_torch.distributed import checkpoint as CKPT
    from repro_torch.distributed import sharding as SH
    from repro_torch.training import train_step as TS
    mesh = make_mesh((1, world, 1), ("pod", "data", "model"))
    policy = SH.ShardingPolicy(mesh)
    # two leaves with an FSDP block over data, one too small to split
    shapes = [((64 * world, 32), torch.bfloat16),
              ((16 * world, 8), torch.float32), ((3,), torch.bfloat16)]
    blocks = [("data", None), ("data", None), (None,)]
    replicated = [(None,) * len(s) for s, _ in shapes]

    def grads_of(r):
        g = torch.Generator().manual_seed(100 + r)
        return [torch.randn(s, generator=g).to(dt) for s, dt in shapes]

    every = [grads_of(r) for r in range(world)]
    want = []
    for parts in zip(*every):
        acc = parts[0].float()
        for x in parts[1:]:
            acc = acc + x.float()
        want.append((acc / world).to(parts[0].dtype))
    out = {}
    for tag, specs in (("replicated", replicated), ("fsdp", blocks)):
        comm = CL.CommStats()
        got = TS.reduce_gradients(every[rank], specs, blocks, policy,
                                  comm=comm)
        out[f"{tag}_bitwise"] = all(
            np.array_equal(as_bits(g), as_bits(SH.shard_slice(w, s, mesh)))
            for g, w, s in zip(got, want, specs))
        out[f"{tag}_shapes"] = [list(g.shape) for g in got]
        # the two leaves that split, alone: what the reduction receives
        comm = CL.CommStats()
        TS.reduce_gradients(every[rank][:2], specs[:2], blocks[:2], policy,
                            comm=comm)
        out[f"{tag}_recv_bytes"] = comm.recv_bytes
    out["split_whole_bytes"] = sum(x.numel() * x.element_size()
                                   for x in every[rank][:2])
    # a placed save whose write fails on rank 0 fails on every rank at once
    like = {"w": torch.empty((8 * world, 6), dtype=torch.bfloat16,
                             device="meta")}
    ckpt = CKPT.Checkpointer(
        str(out_dir / "ckpt"), device="cpu",
        placement=SH.Placement(SH.ShardingPolicy(mesh, fsdp=True),
                               {"w": ("data", None)}, like))
    if rank == 0:
        def no_space(*a, **k):
            raise OSError("no space left on device")
        ckpt._write = no_space
    shard = {"w": torch.ones((8, 6), dtype=torch.bfloat16)}
    t0 = time.monotonic()
    try:
        ckpt.save(1, shard)
        out["save_raised"] = None
    except (OSError, RuntimeError) as e:
        out["save_raised"] = f"{type(e).__name__}: {e}"
    out["save_seconds"] = time.monotonic() - t0
    return out


def launch_world(rank, world, store, ckpt_dir, out_dir):
    """``launch/train.py --mesh 1,<world>,1`` on this rank; the launcher
    tears the group down itself."""
    import contextlib
    import io
    import os

    from repro_torch.launch import train as LT
    _init(rank, world, store)
    os.environ["WORLD_SIZE"] = str(world)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        LT.main(["--arch", "smollm-135m", "--reduced", "--batch", "4",
                 "--seq", "16", "--device", "cpu", "--mesh", f"1,{world},1",
                 "--steps", "2", "--ckpt-dir", ckpt_dir, "--ckpt-every", "2"])
    (Path(out_dir) / f"rank{rank}.txt").write_text(buf.getvalue())


# ---------------------------------------------------------------------------
# tensor-parallel training
# ---------------------------------------------------------------------------

def _torch_batch(ref, i: int):
    """Batch ``i`` of a reference ``.npz`` (``batch{i}/<key>``): integer
    ids as they are, f32 front-end inputs cast to bf16."""
    out = {}
    for k in ref.files:
        if k.startswith(f"batch{i}/"):
            x = torch.from_numpy(np.array(ref[k]))
            out[k.split("/", 1)[1]] = (x.to(torch.bfloat16)
                                       if x.dtype == torch.float32 else x)
    return out


def with_overrides(cfg, over: dict):
    """``cfg`` with the fields of ``over`` replaced; a dict value replaces
    fields of the nested config it names (``{"ssm": {"head_dim": 128}}``)."""
    kw = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
          else v for k, v in over.items()}
    return dataclasses.replace(cfg, **kw)


def launch_name(arch: str, rank: int) -> str:
    """The file of ``tp_train_world``'s launcher output for ``arch``."""
    return f"launch{rank}.txt" if arch == "smollm-135m" else f"launch-{arch}{rank}.txt"


def tp_train_world(rank, world, store, ref_dir, out_dir, cases, launch_steps,
                   launch_archs=("smollm-135m",)):
    """The cases of ``tests/test_torch_tensor_parallel.py`` on this world,
    then (``launch_steps``) ``launch/train.py --mesh 1,1,<world>`` for each
    of ``launch_archs``; the launcher tears the group down itself, so each
    further launch joins a new one."""
    import contextlib
    import io
    import os
    _init(rank, world, store)
    try:
        summary, arrays = {}, {}
        for case in cases:
            summary[case["name"]], got = _tp_case(Path(ref_dir), Path(out_dir),
                                                  case)
            arrays.update({f"{case['name']}/{k}": v for k, v in got.items()})
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(summary))
        if rank == 0:
            np.savez(Path(out_dir) / "rank0.npz", **arrays)
        if launch_steps:
            from repro_torch.launch import train as LT
            os.environ["WORLD_SIZE"] = str(world)
            for i, arch in enumerate(launch_archs):
                if i:
                    _init(rank, world, f"{store}.{i}")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    LT.main(["--arch", arch, "--reduced", "--batch", "4",
                             "--seq", "16", "--device", "cpu", "--mesh",
                             f"1,1,{world}", "--steps", str(launch_steps)])
                (Path(out_dir) / launch_name(arch, rank)).write_text(
                    buf.getvalue())
        else:
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _tp_case(ref_dir: Path, out_dir: Path, case: dict):
    """One case: the reference's steps through the sharded step on mesh
    ``case["shape"]``; per rank the metrics, its coordinate, the attention
    case (None for a config without attention), the leaves whose
    gradients are partial over ``model``, held bytes against the spec
    arithmetic, the step's traffic (and
    the parameter-gather bytes the data axis alone accounts for), the
    hash of its shards of the leaves replicated over ``model``, the
    gathered state's hash (rank 0: its bits), and with ``ckpt`` a placed
    save restored into mesh ``(1, world, 1)``."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import checkpoint as CKPT
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TPM
    from repro_torch.models import model as M
    from repro_torch.serving.collective import _padded
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_step as TS
    ref = np.load(ref_dir / f"{case['ref']}.npz")
    meta = json.loads((ref_dir / f"{case['ref']}.json").read_text())
    cfg = with_overrides(get_config(case["arch"]).reduced(), case["over"])
    state0 = _state_from_ref(ref, cfg)
    like = TS.abstract_state(cfg)
    shape = tuple(case["shape"])
    mesh = make_mesh(shape, ("pod", "data", "model"))
    policy = SH.ShardingPolicy(mesh, fsdp=case["fsdp"],
                               attn_fallback=case["attn_fallback"])
    step, placed = TS.shard_train_step(
        TS.make_train_step(cfg, OPT.AdamWConfig(**meta["opt"]), policy,
                           grad_compress=case["grad_compress"],
                           kv_block=meta["kv_block"],
                           donate=case.get("donate", False)),
        policy, state0)
    specs = TS.state_specs(policy, like)
    leaf = SH.leaf_specs(specs, like)
    tpm = TPM.TensorParallel(mesh.get_group("model"), cfg,
                             attn_fallback=case["attn_fallback"])
    seq = M.input_positions(_torch_batch(ref, 0), cfg)
    out = {"coord": SH.coordinate(mesh),
           "case": tpm.attention(seq) if cfg.num_heads else None,
           "partial": sorted(SH.path_str(p) for p, _ in
                             TR.flatten_with_path(like.params)[0]
                             if TPM.partial_leaf(SH.path_str(p), tpm, seq)),
           "held": _nbytes(placed),
           "spec_bytes": SH.held_bytes(like, specs, policy.sizes),
           "split_over_model": sum("model" in SH.entry_axes(e) for s in leaf
                                   for e in s),
           "data_gather_bytes": sum(
               _padded(x.numel() * x.element_size())
               for x, s in zip(TR.leaves(placed.params),
                               SH.leaf_specs(specs.params, like.params))
               if SH.splits(SH.restrict(s, ("data",)), policy.sizes)),
           "metrics": []}
    for i in range(meta["steps"]):
        placed, metrics = step(placed, _torch_batch(ref, i))
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    out["comm"] = {k: c.sent_bytes for k, c in TS.last_comm.items()}
    out["replicated_sha"] = _sha([x for x, s in zip(TR.leaves(placed), leaf)
                                  if not any("model" in SH.entry_axes(e)
                                             for e in s)])
    whole = TS.gather_state(placed, policy, like)
    out["sha"] = _sha(whole)
    arrays = {_keystr(p): as_bits(x) for p, x in TR.flatten_with_path(whole)[0]}
    if case.get("ckpt"):
        ckpt_dir = str(out_dir / case["name"] / "ckpt")
        CKPT.Checkpointer(ckpt_dir, device="cpu",
                          placement=TS.placement(cfg, policy)).save(
            meta["steps"], placed, extra={"arch": cfg.name})
        other = SH.ShardingPolicy(make_mesh((1, dist.get_world_size(), 1),
                                            ("pod", "data", "model")),
                                  fsdp=True)
        back, extra, s = CKPT.Checkpointer(
            ckpt_dir, device="cpu",
            placement=TS.placement(cfg, other)).restore(None)
        out["restored"] = dict(step=s, extra=extra,
                               sha=_sha(TS.gather_state(back, other, like)),
                               held=_nbytes(back),
                               spec_bytes=SH.held_bytes(
                                   like, TS.state_specs(other, like),
                                   other.sizes))
    return out, arrays


# ---------------------------------------------------------------------------
# expert parallelism: MoE training under the model and data axes
# ---------------------------------------------------------------------------

def _moe_config(arch: str, capacity_factor: float):
    """Reduced ``arch`` with its MoE ``capacity_factor`` replaced."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch).reduced()
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


def ep_train_world(rank, world, store, ref_dir, out_dir, cases, route_meshes,
                   launch=None):
    """The routing collectives on ``route_meshes``, then the cases of
    ``tests/test_torch_expert_parallel.py`` on this world, then (``launch``:
    its arguments) ``launch/train.py``, which tears the group down itself."""
    import contextlib
    import io
    import os
    _init(rank, world, store)
    try:
        summary, arrays = {"route": {}}, {}
        for shape in route_meshes:
            tag = ",".join(map(str, shape))
            summary["route"][tag], got = _ep_route(Path(ref_dir), tuple(shape))
            arrays.update({f"route{tag}/{k}": v for k, v in got.items()})
        for case in cases:
            summary[case["name"]], got = _ep_case(Path(ref_dir),
                                                  Path(out_dir), case)
            arrays.update({f"{case['name']}/{k}": v for k, v in got.items()})
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(summary))
        if rank == 0:
            np.savez(Path(out_dir) / "rank0.npz", **arrays)
        if launch:
            from repro_torch.launch import train as LT
            os.environ["WORLD_SIZE"] = str(world)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                LT.main(launch)
            (Path(out_dir) / f"launch{rank}.txt").write_text(buf.getvalue())
        else:
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _ep_route(ref_dir: Path, shape):
    """The MoE FFN of ``route.npz``'s one layer on mesh ``shape`` (pod 1):
    this rank takes its data block of the (B, S, d) tokens and its expert
    block, routes and runs ``moe_ffn(ep=)`` and back-propagates the mean
    over its rows of ``y . up`` plus 0.01 aux.  Held here against the
    unsharded ``route`` / ``moe_ffn`` on the whole tokens: the slots of
    this rank's choices, its output rows and the group's drops, ``me``,
    ``fe`` and aux bitwise; the data-reduced gradients (the train step's
    f32 rank-order mean) beside the whole ones.  Returns the reduced
    gradients for the parent to hold against JAX."""
    from repro_torch.distributed import expert_parallel as EP
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.distributed.tensor_parallel import ordered_sum
    from repro_torch.models import moe as MOE
    ref = np.load(ref_dir / "route.npz")
    cfg = _moe_config("qwen3-moe-30b-a3b", float(ref["capacity_factor"]))
    mc, e = cfg.moe, cfg.moe.num_experts
    mesh = make_mesh(shape, ("pod", "data", "model"))
    policy = ShardingPolicy(mesh)
    group = EP.routing_group(policy, ring=False)
    tp = (TP.TensorParallel(mesh.get_group("model"), cfg)
          if policy.tp_size() > 1 else None)
    ep = EP.ExpertParallel(cfg, group, tp)
    x = to_torch(ref["x"], "bfloat16")
    up = to_torch(ref["up"], "bfloat16")
    p = {"router": torch.from_numpy(np.array(ref["router"])),
         "w_gate_up": to_torch(ref["w_gate_up"], "bfloat16"),
         "w_down": to_torch(ref["w_down"], "bfloat16")}
    b, s, _ = x.shape
    n = shape[1]
    rows = slice(mesh.get_local_rank("data") * b // n,
                 (mesh.get_local_rank("data") + 1) * b // n)
    cap, cap_local = MOE.capacity(b * s, mc), MOE.capacity(b * s // n, mc)

    def loss(y, aux, up_):
        return (y.float() * up_.float()).sum(-1).mean() + 0.01 * aux

    # the whole batch in one process
    pw = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xw = x.clone().requires_grad_(True)
    yw, aw = MOE.moe_ffn(pw, xw, mc)
    loss(yw, aw, up).backward()
    rw = MOE.route(p["router"], x.reshape(b * s, -1), mc, cap)
    # this rank's block
    ps = {k: (v if k == "router" else v[ep.experts]).clone().requires_grad_(True)
          for k, v in p.items()}
    xs = x[rows].clone().requires_grad_(True)
    ys, a_s = MOE.moe_ffn(ps, xs, mc, ep)
    loss(ys, a_s, up[rows]).backward()
    rs = MOE.route(p["router"], x[rows].reshape(-1, x.shape[-1]), mc, cap, ep)
    k = mc.top_k
    t0 = rows.start * s * k
    slot_whole = torch.empty_like(rw["slot"])
    slot_whole[rw["order"]] = rw["slot"]
    slot_mine = torch.empty_like(rs["slot"])
    slot_mine[rs["order"]] = rs["slot"]
    drops = _group_sum((rs["slot"] == e * cap).sum(), group)
    whole_top1 = ep.whole(rs["expert_idx"][:, 0])
    whole_probs = ep.whole(rs["probs"].detach())

    def reduce(g, split_model):
        """The step's gradient reduction of one leaf: the f32 sum over the
        routing group in rank order, divided by its size; expert leaves
        gathered over model."""
        if group is not None:
            g = ordered_sum(CL.Link(group, "cpu", CL.CommStats())
                            .all_gather(g)) / n
        if split_model and ep.model is not None:
            g = torch.cat(CL.Link(ep.model.group, "cpu",
                                  CL.CommStats()).all_gather(g.contiguous()))
        return g

    grads = {kk: reduce(v.grad.float(), kk != "router") for kk, v in ps.items()}
    out = dict(
        cap=cap, cap_local=cap_local, group_size=ep.size,
        split_experts=ep.model is not None,
        slots_bitwise=torch.equal(slot_mine, slot_whole[t0:t0 + slot_mine.numel()]),
        out_bitwise=torch.equal(as_bits_t(ys), as_bits_t(yw[rows])),
        aux_bitwise=torch.equal(a_s.detach(), aw.detach()),
        me_bitwise=torch.equal(whole_probs.mean(0), rw["probs"].mean(0)),
        fe_bitwise=torch.equal(
            torch.nn.functional.one_hot(whole_top1, e).float().mean(0),
            torch.nn.functional.one_hot(rw["expert_idx"][:, 0], e).float().mean(0)),
        drops=int(drops), drops_whole=int((rw["slot"] == e * cap).sum()),
        aux=float(a_s.detach()),
        x_grad_rel=_rel(xs.grad.float() / n, xw.grad[rows].float()),
        grad_rel={kk: _rel(g, pw[kk].grad.float()) for kk, g in grads.items()})
    arrays = {f"grad/{kk}": g.numpy() for kk, g in grads.items()}
    arrays["out"] = ys.detach().float().numpy()
    arrays["rows"] = np.array([rows.start, rows.stop])
    return out, arrays


def _group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """An integer count summed over ``group`` (None: this rank alone)."""
    if group is None:
        return x
    return torch.stack(CL.Link(group, "cpu", CL.CommStats())
                       .all_gather(x.reshape(1))).sum()


def as_bits_t(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(_INT[x.element_size()])


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp(min=1e-30))


def _ep_case(ref_dir: Path, out_dir: Path, case: dict):
    """One case: the reference's steps through the sharded step on mesh
    ``case["shape"]``; per rank the metrics, the capacity and routing-group
    size each MoE layer used and the group's dropped choices (first step's
    forward), held bytes against the spec arithmetic, whether the leaf-by-
    leaf placed init is bitwise ``shard_state`` of the whole one, the
    step's traffic and the parameter-gather bytes the data axis accounts
    for, the hash of the leaves replicated over ``model`` and of the
    gathered state (rank 0: its bits)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import moe as MOE
    from repro_torch.serving.collective import _padded
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_step as TS
    ref = np.load(ref_dir / f"{case['ref']}.npz")
    meta = json.loads((ref_dir / f"{case['ref']}.json").read_text())
    cfg = _moe_config(case["arch"], meta["capacity_factor"])
    state0 = _state_from_ref(ref, cfg)
    like = TS.abstract_state(cfg)
    shape = tuple(case["shape"])
    mesh = make_mesh(shape, ("pod", "data", "model"))
    policy = SH.ShardingPolicy(mesh, fsdp=case["fsdp"])
    step, placed = TS.shard_train_step(
        TS.make_train_step(cfg, OPT.AdamWConfig(**meta["opt"]), policy,
                           grad_compress=case["grad_compress"],
                           kv_block=meta["kv_block"],
                           donate=case.get("donate", False)),
        policy, state0)
    seeded = TS.init_state(cfg, torch.Generator().manual_seed(3), "cpu", policy)
    whole = TS.shard_state(TS.init_state(cfg, torch.Generator().manual_seed(3),
                                         "cpu"), policy)
    specs = TS.state_specs(policy, like)
    leaf = SH.leaf_specs(specs, like)
    out = {"coord": SH.coordinate(mesh),
           "placed_init_bitwise": _sha(seeded) == _sha(whole),
           "held": _nbytes(placed),
           "spec_bytes": SH.held_bytes(like, specs, policy.sizes),
           "split_over_model": sum("model" in SH.entry_axes(e) for s in leaf
                                   for e in s),
           "data_gather_bytes": sum(
               _padded(x.numel() * x.element_size())
               for x, s in zip(TR.leaves(placed.params),
                               SH.leaf_specs(specs.params, like.params))
               if SH.splits(SH.restrict(s, ("data",)), policy.sizes)),
           "metrics": [], "layers": []}
    seen, routes, orig = [], [], MOE.moe_ffn

    def recording(p, x, mc, ep=None):
        y, aux = orig(p, x, mc, ep)
        if torch._C._current_graph_task_id() == -1:    # not remat's re-run
            size = ep.size if ep is not None else 1
            cap = MOE.capacity(x.shape[0] * x.shape[1] * size, mc)
            with torch.no_grad():
                r = MOE.route(p["router"], x.reshape(-1, x.shape[-1]), mc,
                              cap, ep)
                dropped = _group_sum((r["slot"] == mc.num_experts * cap).sum(),
                                     ep.group if ep is not None else None)
            routes.append(r["expert_idx"].numpy())
            if len(seen) < cfg.num_layers:
                seen.append(dict(cap=cap, group_size=size,
                                 dropped=int(dropped)))
        return y, aux

    arrays = {}
    MOE.moe_ffn = recording
    try:
        for i in range(meta["steps"]):
            placed, metrics = step(placed, _torch_batch(ref, i))
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            if i == 0:          # the gathered state after the first step
                arrays.update({"step1/" + _keystr(p): as_bits(x) for p, x in
                               TR.flatten_with_path(TS.gather_state(
                                   placed, policy, like))[0]})
    finally:
        MOE.moe_ffn = orig
    out["layers"] = seen
    out["comm"] = {k: c.sent_bytes for k, c in TS.last_comm.items()}
    out["replicated_sha"] = _sha([x for x, s in zip(TR.leaves(placed), leaf)
                                  if not any("model" in SH.entry_axes(e)
                                             for e in s)])
    whole = TS.gather_state(placed, policy, like)
    out["sha"] = _sha(whole)
    arrays.update({_keystr(p): as_bits(x)
                   for p, x in TR.flatten_with_path(whole)[0]})
    # this rank's top-k experts, (step, layer) in call order, for the
    # parent's replay of the run's routing
    np.savez(out_dir / f"{case['name']}.rank{dist.get_rank()}.npz",
             **{f"route/{j}": r for j, r in enumerate(routes)})
    return out, arrays


# ---------------------------------------------------------------------------
# sharded serving: prefill and decode under the policy, the shard hop
# ---------------------------------------------------------------------------

def _np_params(ref) -> dict:
    """The nested numpy parameter tree of a reference ``.npz``
    (``params/<a>/<b>`` keys; bf16 leaves as their uint16 bits)."""
    tree: dict = {}
    for k in ref.files:
        if k.startswith("params/"):
            node = tree
            *path, leaf = k.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = np.array(ref[k])
    return tree


def _stats_dict(stats) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(stats), default=str))


def _bits_list(x: torch.Tensor) -> list:
    return as_bits(x).reshape(-1).tolist()


def serve_tp_world(rank, world, store, ref_dir, out_dir, cases, cli=(),
                   units="attention"):
    """The cases of ``tests/test_torch_serve_tp.py``,
    ``tests/test_torch_serve_families.py``,
    ``tests/test_torch_serve_recurrent.py`` and
    ``tests/test_torch_serve_frontends.py`` on this world: each a serve
    case (prefill, teacher-forced ``serve_step``, greedy ``decode_loop``)
    or a hop case (the disaggregated step and the whole-cache hop), a MoE
    case's routing recorded (:class:`RouteRecorder`); then the unit
    checks: ``units="attention"`` the merges (GQA's and MLA's latent one),
    the vocab argmax and the placed draws, ``"recurrent"`` the recurrent
    decode steps (:func:`_recurrent_units`), None none.  Writes ``rank<r>.json`` and ``rank<r>.npz``.  Then each
    argument list of ``cli`` through ``serving/sharded.py``'s ``main``
    (which tears the group down itself, so each joins a new one), its
    output in ``cli<i>_rank<r>.txt``.  One thread a rank: the products
    are tiny and the worlds run side by side."""
    import contextlib
    import io
    import os
    torch.set_num_threads(1)
    _init(rank, world, store)
    try:
        summary, arrays = {}, {}
        for case in cases:
            run = _serve_case if case["kind"] == "serve" else _hop_case
            rec = RouteRecorder() if case.get("moe") else None
            with rec if rec is not None else contextlib.nullcontext():
                summary[case["name"]], got = run(Path(ref_dir), case, rec)
            arrays.update({f"{case['name']}/{k}": v for k, v in got.items()})
        if units == "recurrent":
            summary["units"] = _recurrent_units(rank)
        elif units == "attention":
            summary["units"] = _serve_units(rank)
            summary["units"]["latent_merge_max_abs"] = _latent_merge(rank)
            summary["placed_draws"] = _placed_draws()
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(summary))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)
        dist.barrier()
        if cli:
            from repro_torch.serving import sharded as SV
            os.environ["WORLD_SIZE"] = str(world)
            for i, argv in enumerate(cli):
                if i:
                    _init(rank, world, f"{store}.{i}")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    SV.main(list(argv))
                (Path(out_dir) / f"cli{i}_rank{rank}.txt").write_text(
                    buf.getvalue())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _ref_prompt(ref) -> dict:
    """The prompt a reference holds: ``tokens``, a vision prompt's
    ``patches`` before them, or an audio prompt's ``frames`` (the bf16
    inputs kept as their bits)."""
    out = {}
    if "tokens" in ref.files:
        out["tokens"] = torch.from_numpy(np.array(ref["tokens"]))
    for k in ("patches", "frames"):
        if k in ref.files:
            out[k] = to_torch(np.array(ref[k]), "bfloat16")
    return out


def _serve_setup(ref_dir: Path, case: dict):
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.serve import prompt_positions
    from repro_torch.models import kvcache as KC
    from repro_torch.models import model as M
    from repro_torch.models.weights import params_from_jax
    from repro_torch.serving import sharded as SV
    ref = np.load(ref_dir / f"{case['ref']}.npz")
    cfg = with_overrides(get_config(case["arch"]).reduced(),
                         case.get("over", {}))
    mesh = make_mesh(tuple(case["shape"]), ("pod", "data", "model"))
    policy = SH.ShardingPolicy(mesh, pd_disaggregated=case.get("pd", False),
                               attn_fallback=case.get("attn_fallback", "seq"))
    params = params_from_jax(_np_params(ref), "cpu", policy=policy)
    prompt = _ref_prompt(ref)
    b, s = next(iter(prompt.values())).shape[0], prompt_positions(cfg, prompt)
    m = int(ref["max_seq"])
    like_p = M.init_params(cfg, torch.Generator(), "meta")
    like_c = SV.cache_like(cfg, b, m, s)
    # the slots init_cache allots the window: the prompt's, as a prefill
    # leaves it (serving/sharded.cache_like)
    slots = min(m, s) if cfg.hybrid is not None else m
    tp = SV.tensor_parallel(policy, cfg)
    rows = SH.shard_slice(torch.arange(b), policy.spec_for_activation(
        "tokens", (b,)), mesh)
    out = {"coord": SH.coordinate(mesh), "case": tp.attention(s),
           "rows": rows.tolist(), "vocab_split": tp.splits(cfg.vocab_size),
           "cache_split": tp.splits(m), "tp_rank": tp.rank,
           "tp_size": tp.size,
           "held_params": _nbytes(params),
           "spec_params": SH.held_bytes(like_p, policy.param_specs(like_p),
                                        policy.sizes),
           "spec_cache": SH.held_bytes(like_c, policy.cache_specs(like_c),
                                       policy.sizes),
           "init_cache": _nbytes(KC.init_cache(cfg, b, slots, policy=policy)),
           "split_over_model": sum(
               "model" in SH.entry_axes(e) for sp in SH.leaf_specs(
                   policy.param_specs(like_p), like_p) for e in sp)}
    return ref, cfg, policy, params, prompt, m, tp, out


def _serve_case(ref_dir: Path, case: dict, rec=None):
    """One serve case: the rank's prefill, ``STEPS`` teacher-forced
    ``serve_step``s on the JAX run's tokens, and ``decode_loop``'s greedy
    tokens; the rank's last logits, step logits and cache blocks after the
    prefill and after the steps, as arrays.  A MoE case runs under
    ``serving/sharded.expert_parallel`` and ``rec`` (a
    :class:`RouteRecorder`) keeps its routing: the prefill's and the
    teacher-forced steps' top-k experts as arrays.  An encoder-only case
    has no steps: its prefill (every frame's vocab columns, from the
    model's prefill under the same context) and ``serve``'s prefill cell."""
    from repro_torch.models import model as M
    from repro_torch.serving import sharded as SV
    from repro_torch.serving.decode import serve_step
    from repro_torch.serving.prefill import prefill_step
    ref, cfg, policy, params, prompt, m, tp, out = _serve_setup(ref_dir, case)
    ep = SV.expert_parallel(policy, cfg, tp)
    rows = out["rows"]
    local = SV.local_batch(prompt, policy)
    pre = prefill_step(params, local, cfg, max_seq=m, kv_block=4, tp=tp,
                       ep=ep)
    n_pre = len(rec.calls) if rec is not None else 0
    out["prefill_bytes"] = tp.fwd.sent_bytes
    out["held_cache"] = _nbytes(pre.state.cache)
    out["first_token"] = pre.first_token.tolist()
    out["cache_len"] = pre.state.cache_len.tolist()
    arrays = {"last_logits": pre.last_logits.float().numpy()}
    arrays.update({k: as_bits(x) for k, x in pre.state.cache.items()})
    if cfg.encoder_only:
        frames, _ = M.prefill(params, local, cfg, max_seq=m, kv_block=4,
                              tp=tp)
        arrays["frame_logits"] = frames.float().numpy()
        res = SV.serve(params, prompt, cfg, policy, max_seq=m, num_steps=4,
                       kv_block=4)
        out["greedy"] = res.tokens
        out["greedy_first"] = res.prefill.first_token.tolist()
        out["serve_cache"] = sorted(res.state.cache)
        out["serve_cache_len"] = res.state.cache_len.tolist()
        return out, arrays
    st = type(pre.state)(cache={k: v.clone() for k, v in pre.state.cache.items()},
                         cache_len=pre.state.cache_len)
    feed = np.array(ref["step_inputs"])
    logits = []
    for i in range(feed.shape[0]):
        lg, st = serve_step(params, torch.from_numpy(feed[i][rows])[:, None],
                            st, cfg, tp=tp, max_seq=m, ep=ep)
        logits.append(lg.float().numpy())
    arrays["step_logits"] = np.stack(logits)
    arrays.update({k + "_after": as_bits(x) for k, x in st.cache.items()})
    if rec is not None:
        n_steps = len(rec.calls)
        arrays.update(rec.arrays(0, n_pre, "prefill", 1))
        arrays.update(rec.arrays(n_pre, n_steps, "steps", feed.shape[0]))
    res = SV.serve(params, prompt, cfg, policy, max_seq=m,
                   num_steps=feed.shape[0], kv_block=4)
    out["greedy"] = res.tokens.tolist()
    out["greedy_first"] = res.prefill.first_token.tolist()
    if rec is not None:
        out["routing"] = rec.summary()
        out["ep_fwd_bytes"] = res.ep.fwd.sent_bytes
        out["ep_gather_bytes"] = res.ep.out_gather.sent_bytes
    return out, arrays


def _hop_case(ref_dir: Path, case: dict, rec=None):
    """One hop case on a (2, data, model) ``pd_disaggregated`` world: the
    disaggregated step (pod 0 prefills and ships its own shards, pod 1
    decodes ``STEPS`` greedy tokens from them, each step's logits kept),
    then the same plan's whole-cache hop of pod 0's gathered cache.  Per
    rank: the shards' hash (sent or received, each way), both hops'
    ``TransferStats``, the first token, the tokens."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.serve import prompt_positions
    from repro_torch.serving import sharded as SV
    ref, cfg, policy, params, prompt, m, tp, out = _serve_setup(ref_dir, case)
    tc = SV.transfer_config(case["variant"])
    b, s = next(iter(prompt.values())).shape[0], prompt_positions(cfg, prompt)
    steps = np.array(ref["step_inputs"]).shape[0]
    logits = []
    res = SV.disaggregated_step(params, prompt, cfg, policy, tc,
                                max_seq=m, num_steps=steps, kv_block=4,
                                device="cpu",
                                on_logits=lambda i, lg: logits.append(
                                    lg.float().numpy()))
    out["pod"] = res.pod
    if rec is not None:
        arrays_rec = rec.arrays(0, len(rec.calls),
                                "prefill" if res.pod == 0 else "steps",
                                1 if res.pod == 0 else steps)
        out["routing"] = rec.summary()
    out["stats"] = _stats_dict(res.session.last_stats)
    out["side_bytes"] = res.side.sent_bytes + res.side.recv_bytes
    whole_sess = SV.hop_plan(cfg, policy, tc, b, m, s).session(device="cpu")
    out["routes"] = {r.key: r.route for r in whole_sess.plan.routes}
    arrays = {}
    if res.pod == 0:
        blocks = res.prefill.state.cache
        out["sha"] = _sha(blocks)
        out["first_token"] = res.prefill.first_token.tolist()
        out["held_cache"] = _nbytes(blocks)
        out["cache_len"] = res.prefill.state.cache_len.tolist()
        # the whole cache only to drive the whole-cache path: gathered over
        # pod 0's (data, model) ranks
        whole = SH.gather_tree(blocks, policy.cache_specs(
            SV.cache_like(cfg, b, m, s)), policy.mesh)
        whole_sess.transfer(whole, select_dst=False)
        arrays["last_logits"] = res.prefill.last_logits.float().numpy()
    else:
        out["sha"] = _sha(res.received)
        out["held_cache"] = _nbytes(res.received)
        out["first_token"] = res.first_token.tolist()
        out["tokens"] = None if res.tokens is None else res.tokens.tolist()
        out["received"] = sorted(res.received)
        out["cache_len"] = res.state.cache_len.tolist()   # after the steps
        got = whole_sess.transfer(None, select_dst=False)
        out["whole_sha"] = _sha(got)
        if logits:
            arrays["step_logits"] = np.stack(logits)
    out["whole_stats"] = _stats_dict(whole_sess.last_stats)
    plan = whole_sess.plan
    out["plan"] = dict(routes=len(plan.routes), segments=len(plan.segments),
                       stream_len=plan.stream_len,
                       in_specs=[list(sp) for sp in plan.in_specs],
                       granularity=plan.granularity)
    out["records"] = len(res.session.last_comm.records)
    if rec is not None:
        arrays.update(arrays_rec)
    return out, arrays


def _serve_units(rank: int) -> dict:
    """The merge of partial attention against whole-key attention, and the
    vocab-parallel argmax with forced ties, on this world's model axis
    (the whole world as one ``model`` group)."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import tensor_parallel as TPM
    from repro_torch.models import layers as L
    world = dist.get_world_size()
    cfg = get_config("smollm-135m").reduced()
    tp = TPM.TensorParallel(dist.group.WORLD, cfg)
    g = torch.Generator().manual_seed(11)
    b, h, d, s = 3, 4, 8, 6 * world
    q = torch.randn((b, 1, h, d), generator=g).to(torch.bfloat16)
    k = torch.randn((b, s, 2, d), generator=g).to(torch.bfloat16)
    v = torch.randn((b, s, 2, d), generator=g).to(torch.bfloat16)
    n = torch.tensor([1, s // 2 + 1, s], dtype=torch.int32)  # row 0: rank 0 only
    qg = q.reshape(b, 1, 2, 2, d).permute(0, 2, 3, 1, 4).float()

    def scores(blk):
        sc = torch.matmul(qg, k[:, blk].permute(0, 2, 1, 3).float()[:, :, None]
                          .transpose(-1, -2)) / np.sqrt(d)
        pos = torch.arange(blk.start, blk.stop)
        return torch.where((pos[None, :] < n[:, None])[:, None, None, None, :],
                           sc, torch.tensor(L.NEG_INF))

    def values(blk):
        return v[:, blk].permute(0, 2, 1, 3).float()[:, :, None]
    # whole-key attention in f32 (p unrounded, as the partials keep it)
    whole = torch.matmul(torch.softmax(scores(slice(0, s)), -1),
                         values(slice(0, s)))
    blk = slice(rank * 6, (rank + 1) * 6)
    sc = scores(blk)
    mx = sc.amax(-1)
    p = torch.exp(sc - mx[..., None])
    merged = TPM.merge_partials(mx, p.sum(-1), torch.matmul(p, values(blk)), tp)
    # vocab argmax: each rank 5 columns; row 0 ties across every rank (the
    # first rank's first column wins), row 1 ties inside the last rank,
    # row 2 a single largest value on rank 1's last column
    vr = 5
    lg = torch.zeros((3, vr), dtype=torch.float32)
    lg[0, 2] = 7.0
    lg[0, 0] = 7.0 if rank == 0 else 3.0
    if rank == world - 1:
        lg[1, 1] = lg[1, 3] = 9.0
    if rank == 1:
        lg[2, 4] = 2.5
    got = TPM.vocab_argmax(lg, tp)
    parts = [torch.empty_like(lg) for _ in range(world)]
    dist.all_gather(parts, lg)
    whole_lg = torch.cat(parts, dim=-1)
    return {"merge_max_abs": float((merged - whole).abs().max()),
            "argmax": got.tolist(),
            "argmax_whole": torch.argmax(whole_lg, dim=-1).tolist()}


def _recurrent_units(rank: int) -> dict:
    """The recurrent decode steps under ``tp`` against the whole steps on
    the same whole state (the world as one ``model`` group, each rank's
    parameter blocks placed by the policy at (1, 1, world)): reduced
    Mamba-2's ``mamba2_decode_tp`` against ``mamba2_decode`` and reduced
    recurrentgemma's ``recurrent_block_step_tp`` against
    ``recurrent_block_step`` (where its U = 128 splits).  Per step: the
    output's largest excess over ``8e-3 |want|``, the f32 state block's
    largest distance, and whether the new conv block is bitwise the whole
    step's."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.models import rglru as RG
    from repro_torch.models import ssm as SSM
    from repro_torch.serving import sharded as SV
    world = dist.get_world_size()
    policy = SH.ShardingPolicy(make_mesh((1, 1, world),
                                         ("pod", "data", "model")))
    g = torch.Generator().manual_seed(21)
    b = 3

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dtype)

    def excess(got, want):
        d = (got.float() - want.float()).abs() - 8e-3 * want.float().abs()
        return float(d.max())

    out = {}
    for arch, over in (("mamba2-2.7b", {}),
                       ("recurrentgemma-9b", {"num_layers": 5})):
        cfg = with_overrides(get_config(arch).reduced(), over)
        tp = SV.tensor_parallel(policy, cfg)
        whole = M.init_params(cfg, torch.Generator().manual_seed(3))
        placed = SV.place_params(cfg, torch.Generator().manual_seed(3), policy)
        x = randn(b, 1, cfg.d_model)
        if cfg.ssm is not None:
            _, heads, conv_ch = SSM.dims(cfg.d_model, cfg.ssm)
            st = SSM.SSMState(
                ssm=randn(b, heads, cfg.ssm.head_dim, cfg.ssm.d_state,
                          dtype=torch.float32, scale=0.1),
                conv=randn(b, cfg.ssm.conv_width - 1, conv_ch))
            want_o, want = SSM.mamba2_decode(
                M.layer_params(whole["layers"], 1)["mixer"], x, st, cfg.ssm,
                cfg.d_model)
            got_o, got = SSM.mamba2_decode_tp(
                M.layer_params(placed["layers"], 1)["mixer"], x,
                SSM.state_block(st, cfg.ssm, cfg.d_model, tp), cfg.ssm,
                cfg.d_model, tp)
            blk = SSM.state_block(want, cfg.ssm, cfg.d_model, tp)
            out["mamba2"] = dict(
                out_excess=excess(got_o, want_o),
                state_max_abs=float((got.ssm - blk.ssm).abs().max()),
                conv_bitwise=bool(torch.equal(got.conv, blk.conv)),
                split=dict(heads=tp.splits(heads), conv=tp.splits(conv_ch)))
            continue
        u = cfg.hybrid.lru_width
        if not tp.splits(u):
            out["rglru"] = None
            continue
        blk = tp.block(u)
        st = {"h": randn(b, u, dtype=torch.float32, scale=0.5),
              "conv": randn(b, cfg.hybrid.conv_width - 1, u)}
        want_o, want = RG.recurrent_block_step(
            M.layer_params(whole["extra"], 1)["block"], x, st)
        got_o, got = RG.recurrent_block_step_tp(
            M.layer_params(placed["extra"], 1)["block"], x,
            {"h": st["h"][:, blk], "conv": st["conv"][..., blk]}, tp)
        out["rglru"] = dict(
            out_excess=excess(got_o, want_o),
            state_max_abs=float((got["h"] - want["h"][:, blk]).abs().max()),
            conv_bitwise=bool(torch.equal(got["conv"],
                                          want["conv"][..., blk])))
    return out


def _placed_draws() -> dict:
    """The port's own draws carried through ``params_from_jax(policy=)``
    against ``init_params(place=)`` under the same policy (the world as
    (1, 1, world) and, where it divides, (1, 2, world / 2))."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.models.weights import params_from_jax
    from repro_torch.serving import sharded as SV
    world = dist.get_world_size()
    cfg = get_config("smollm-135m").reduced()
    whole = M.init_params(cfg, torch.Generator().manual_seed(5))
    def conv(tree):
        return {k: conv(v) if isinstance(v, dict) else as_bits(v).view(np.uint16)
                if v.dtype == torch.bfloat16 else v.numpy() for k, v in tree.items()}
    np_whole = conv(whole)
    out = {}
    shapes = [(1, 1, world)] + ([(1, 2, world // 2)] if world % 2 == 0 else [])
    for shape in shapes:
        policy = SH.ShardingPolicy(make_mesh(shape, ("pod", "data", "model")))
        placed = SV.place_params(cfg, torch.Generator().manual_seed(5), policy)
        carried = params_from_jax(np_whole, "cpu", policy=policy)
        out["x".join(map(str, shape))] = _sha(placed) == _sha(carried)
    return out


# ---------------------------------------------------------------------------
# sharded serving of MLA and MoE
# ---------------------------------------------------------------------------

class RouteRecorder:
    """Within: every MoE FFN call under ``ep`` keeps this rank's top-k
    experts (``calls``) and holds the routing collectives against one
    process on the routing group's whole batch: the slots of this rank's
    choices (the counts prefix) and its output rows, bitwise, against
    ``route`` / ``moe_ffn`` on the group's gathered tokens with every
    expert (the expert blocks gathered over ``model``)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.orig = orig = MOE.moe_ffn

        def recording(p, x, mc, ep=None):
            y, aux = orig(p, x, mc, ep)
            if ep is not None:
                self.calls.append(_route_check(orig, p, x, y, mc, ep))
            return y, aux
        MOE.moe_ffn = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as MOE
        MOE.moe_ffn = self.orig
        return False

    def arrays(self, lo: int, hi: int, name: str, steps: int) -> dict:
        """Calls ``lo:hi`` as ``route/<name>``: (steps, layers, T, k)."""
        idx = [c["expert_idx"] for c in self.calls[lo:hi]]
        n = len(idx) // steps
        return {f"route/{name}": np.stack(
            [np.stack(idx[i * n:(i + 1) * n]) for i in range(steps)])}

    def summary(self) -> dict:
        return {"calls": len(self.calls),
                "slots_bitwise": all(c["slots_ok"] for c in self.calls),
                "out_bitwise": all(c["out_ok"] for c in self.calls),
                "caps": sorted({c["cap"] for c in self.calls}),
                "group_sizes": sorted({c["group"] for c in self.calls}),
                "split_experts": all(c["split"] for c in self.calls)}


def _route_check(orig, p, x, y, mc, ep) -> dict:
    from repro_torch.models import moe as MOE
    b, s, d = x.shape
    t, k = b * s, mc.top_k
    cap = MOE.capacity(t * ep.size, mc)
    stats = CL.CommStats()
    r = MOE.route(p["router"], x.reshape(t, d), mc, cap, ep)

    def gathered(z, group):
        if group is None:
            return z
        return torch.cat(CL.Link(group, z.device, stats).all_gather(
            z.contiguous()))
    xs = gathered(x, ep.group)
    rw = MOE.route(p["router"], xs.reshape(-1, d), mc, cap)
    mine = torch.empty_like(r["slot"])
    mine[r["order"]] = r["slot"]
    whole = torch.empty_like(rw["slot"])
    whole[rw["order"]] = rw["slot"]
    pw = dict(p)
    if ep.model is not None:
        for name in ("w_gate_up", "w_down"):
            pw[name] = gathered(p[name], ep.model.group)
    yw, _ = orig(pw, xs, mc)
    me = ep.rank
    return {"expert_idx": r["expert_idx"].numpy(), "cap": cap,
            "group": ep.size, "split": ep.model is not None,
            "slots_ok": torch.equal(mine, whole[me * t * k:(me + 1) * t * k]),
            "out_ok": torch.equal(as_bits_t(y),
                                  as_bits_t(yw[me * b:(me + 1) * b]))}


def _latent_merge(rank: int) -> float:
    """``mla.latent_partials`` over each rank's span of an f32 latent cache
    (its ``p`` then unrounded), merged over the world as one ``model``
    group (``merge_partials``), against whole-key absorbed attention in
    f32: the largest absolute difference."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import tensor_parallel as TPM
    from repro_torch.models import mla as MLA
    world = dist.get_world_size()
    cfg = get_config("minicpm3-4b").reduced()
    tp = TPM.TensorParallel(dist.group.WORLD, cfg)
    g = torch.Generator().manual_seed(13)
    b, h, r, pr, span = 3, 4, 16, 8, 5
    s = span * world
    q_lat = torch.randn((b, 1, h, r), generator=g)
    q_rope = torch.randn((b, 1, h, pr), generator=g)
    ckv = torch.randn((b, s, r), generator=g)
    krope = torch.randn((b, s, pr), generator=g)
    n = torch.tensor([1, s // 2 + 1, s])          # row 0: rank 0's keys only
    scale = MLA.mla_scale(cfg.mla)
    sc = (torch.einsum("bqhr,bsr->bqhs", q_lat, ckv)
          + torch.einsum("bqhp,bsp->bqhs", q_rope, krope)) * scale
    valid = torch.arange(s)[None, :] < n[:, None]
    sc = torch.where(valid[:, None, None, :], sc, torch.tensor(-1e30))
    whole = torch.einsum("bqhs,bsr->bqhr", torch.softmax(sc, -1), ckv)
    blk = slice(rank * span, (rank + 1) * span)
    m, l, acc = MLA.latent_partials(q_lat, q_rope, ckv[:, blk], krope[:, blk],
                                    blk.start, n, scale)
    merged = TPM.merge_partials(m, l, acc, tp)
    return float((merged - whole).abs().max())


def _count_link_calls(calls: dict) -> None:
    """Count every ``Link`` collective (``all_to_all``, ``all_to_all_v``,
    ``all_gather``) by its process group's name into ``calls``."""
    for name in ("all_to_all", "all_to_all_v", "all_gather"):
        orig = getattr(CL.Link, name)

        def counted(self, *a, _orig=orig, **k):
            key = self.group.group_name
            calls[key] = calls.get(key, 0) + 1
            return _orig(self, *a, **k)
        setattr(CL.Link, name, counted)


def dryrun_world(rank, world, store, out_dir, cases):
    """The served worlds of ``tests/test_torch_dryrun.py`` on real gloo
    ranks: each case a reduced config on its ``(pod, data, model)`` mesh,
    ``xfer_*`` (the disaggregated step, pod 1 decoding ``steps`` tokens) or
    ``base`` (``prefill_step`` then ``decode_loop``), seeded parameters
    (``serving/sharded.place_params``) and prompt.  Per rank: held
    parameter and cache bytes, ``tp.fwd`` (the prefill's apart under
    ``base``), the collectives over ``model`` in the decode steps (pod 0 of
    a hop: in its prefill), and the hop's unit records; written to
    ``rank<r>.json``."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.serve import make_prompt
    from repro_torch.serving import sharded as SV
    from repro_torch.serving.decode import decode_loop
    from repro_torch.serving.prefill import prefill_step
    torch.set_num_threads(1)
    _init(rank, world, store)
    calls: dict = {}
    _count_link_calls(calls)
    try:
        out = {}
        for case in cases:
            cfg = get_config(case["arch"]).reduced()
            xfer = case["variant"] != "base"
            mesh = make_mesh(tuple(case["mesh"]), ("pod", "data", "model"))
            policy = SH.ShardingPolicy(mesh, pd_disaggregated=xfer)
            params = SV.place_params(cfg, torch.Generator().manual_seed(
                case["seed"]), policy, "cpu")
            prompt = make_prompt(cfg, case["batch"], case["prompt"],
                                 device="cpu", seed=case["seed"] + 1)
            model = mesh.get_group("model").group_name
            nb = (lambda tree: sum(x.numel() * x.element_size()
                                   for x in TR.leaves(tree)))

            def fwd(tp):
                return {"bytes": tp.fwd.sent_bytes,
                        "recv_bytes": tp.fwd.recv_bytes,
                        "messages": tp.fwd.messages}
            rec = {"coord": SH.coordinate(mesh), "held": {"params": nb(params)}}
            if xfer:
                calls0 = calls.get(model, 0)
                res = SV.disaggregated_step(
                    params, prompt, cfg, policy,
                    SV.transfer_config(case["variant"]),
                    max_seq=case["max_seq"], num_steps=case["steps"],
                    device="cpu")
                recs = res.session.last_comm.records
                rec.update(
                    pod=res.pod, tp_fwd=fwd(res.tp),
                    model_calls=calls.get(model, 0) - calls0,
                    hop={"units": len(recs), "records": [list(r) for r in recs],
                     "wire_bytes": res.session.last_stats.wire_bytes,
                     "side_bytes": res.side.sent_bytes
                     + res.side.recv_bytes})
                rec["held"]["cache"] = nb(res.prefill.state.cache
                                          if res.pod == 0 else res.received)
            else:
                tp = SV.tensor_parallel(policy, cfg)
                ep = SV.expert_parallel(policy, cfg, tp)
                pre = prefill_step(params, SV.local_batch(prompt, policy),
                                   cfg, max_seq=case["max_seq"], tp=tp,
                                   ep=ep)
                rec["prefill_fwd"] = fwd(tp)
                rec["held"]["cache"] = nb(pre.state.cache)
                calls0 = calls.get(model, 0)
                decode_loop(params, pre.first_token, pre.state, cfg,
                            case["steps"], tp=tp, max_seq=case["max_seq"],
                            ep=ep)
                rec["model_calls"] = calls.get(model, 0) - calls0
                rec["tp_fwd"] = fwd(tp)
            out[case["name"]] = rec
            dist.barrier()
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# sharded serving under FSDP: the same world with fsdp off and on
# ---------------------------------------------------------------------------

def serve_fsdp_world(rank, world, store, ref_dir, out_dir, cases, cli=()):
    """The cases of ``tests/test_torch_serve_fsdp.py`` on this world, each
    served twice in the same world, under its mesh's policy with ``fsdp``
    off and then on (:func:`_fsdp_serve`, :func:`_fsdp_hop`); writes
    ``rank<r>.json`` and ``rank<r>.npz`` (a case with a reference: the
    ``fsdp`` run's last and step logits).  Then each argument list of
    ``cli`` through ``serving/sharded.py``'s ``main``, its output in
    ``cli<i>_rank<r>.txt``."""
    import contextlib
    import io
    import os
    torch.set_num_threads(1)
    _init(rank, world, store)
    try:
        summary, arrays = {}, {}
        for case in cases:
            run = _fsdp_hop if case["kind"] == "hop" else _fsdp_serve
            summary[case["name"]], got = run(Path(ref_dir), case)
            arrays.update({f"{case['name']}/{k}": v for k, v in got.items()})
            dist.barrier()
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(summary))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)
        dist.barrier()
        if cli:
            from repro_torch.serving import sharded as SV
            os.environ["WORLD_SIZE"] = str(world)
            for i, argv in enumerate(cli):
                if i:
                    _init(rank, world, f"{store}.{i}")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    SV.main(list(argv))
                (Path(out_dir) / f"cli{i}_rank{rank}.txt").write_text(
                    buf.getvalue())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _fsdp_setup(ref_dir: Path, case: dict, fsdp: bool):
    """A case's config, policy (``fsdp`` as given), this rank's parameter
    blocks (from the reference's numpy parameters, or seeded:
    ``serving/sharded.place_params``) and the global prompt."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.serve import make_prompt
    from repro_torch.models.weights import params_from_jax
    from repro_torch.serving import sharded as SV
    cfg = with_overrides(get_config(case["arch"]).reduced(),
                         case.get("over", {}))
    mesh = make_mesh(tuple(case["shape"]), ("pod", "data", "model"))
    policy = SH.ShardingPolicy(mesh, fsdp=fsdp,
                               pd_disaggregated=case["kind"] == "hop")
    if case.get("ref"):
        ref = np.load(ref_dir / f"{case['ref']}.npz")
        params = params_from_jax(_np_params(ref), "cpu", policy=policy)
        prompt = _ref_prompt(ref)
    else:
        params = SV.place_params(cfg, torch.Generator().manual_seed(
            case["seed"]), policy, "cpu")
        prompt = make_prompt(cfg, case["batch"], case["prompt"],
                             device="cpu", seed=case["seed"] + 1)
    return cfg, policy, params, prompt


def _fsdp_common(cfg, policy, params, res) -> dict:
    """Held parameter bytes against the spec arithmetic, and the FSDP
    gathers' bytes (sent, received) and all-gathers."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M
    like = M.abstract_params(cfg)
    return {"held": _nbytes(params),
            "spec": SH.held_bytes(like, policy.param_specs(like),
                                  policy.sizes),
            "gather": [res.fsdp.comm.sent_bytes, res.fsdp.comm.recv_bytes,
                       res.fsdp.calls]}


def _fsdp_serve(ref_dir: Path, case: dict):
    """``serving/sharded.serve`` with ``fsdp`` off, then on: per run the
    first token, the greedy tokens, hashes of the last logits, of each
    step's logits and of the cache blocks after the prefill and after the
    steps, and :func:`_fsdp_common`'s counts."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.serving import sharded as SV
    out, arrays = {}, {}
    for on in (False, True):
        cfg, policy, params, prompt = _fsdp_setup(ref_dir, case, on)
        logits = []
        res = SV.serve(params, prompt, cfg, policy, max_seq=case["max_seq"],
                       num_steps=case["steps"], kv_block=4,
                       on_logits=lambda i, lg: logits.append(lg.clone()))
        out["coord"] = SH.coordinate(policy.mesh)
        out["on" if on else "off"] = dict(
            _fsdp_common(cfg, policy, params, res),
            first=res.prefill.first_token.tolist(),
            tokens=None if res.tokens is None else res.tokens.tolist(),
            last_logits=_sha(res.prefill.last_logits),
            steps=[_sha(x) for x in logits],
            prefill_cache=_sha(res.prefill.state.cache),
            cache=_sha(res.state.cache),
            cache_len=res.state.cache_len.tolist())
        if on and case.get("ref"):
            out["rows"] = SH.shard_slice(
                torch.arange(case["batch"]), policy.spec_for_activation(
                    "tokens", (case["batch"],)), policy.mesh).tolist()
            out["tp_rank"], out["tp_size"] = res.tp.rank, res.tp.size
            out["vocab_split"] = res.tp.splits(cfg.vocab_size)
            arrays["last_logits"] = res.prefill.last_logits.float().numpy()
            arrays["step_logits"] = torch.stack(logits).float().numpy()
    return out, arrays


def _fsdp_hop(ref_dir: Path, case: dict):
    """``serving/sharded.disaggregated_step`` on a ``pd_disaggregated``
    mesh with ``fsdp`` off, then on: per run the pod, the hop's
    ``TransferStats``, the side message's bytes, the hash of the shards
    sent (pod 0) or received (pod 1), the first token, pod 1's tokens and
    its steps' logits hashes, and :func:`_fsdp_common`'s counts."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.serving import sharded as SV
    out = {}
    for on in (False, True):
        cfg, policy, params, prompt = _fsdp_setup(ref_dir, case, on)
        logits = []
        res = SV.disaggregated_step(
            params, prompt, cfg, policy, SV.transfer_config(case["variant"]),
            max_seq=case["max_seq"], num_steps=case["steps"], kv_block=4,
            device="cpu", on_logits=lambda i, lg: logits.append(lg.clone()))
        src = res.pod == 0
        out["coord"] = SH.coordinate(policy.mesh)
        out["on" if on else "off"] = dict(
            _fsdp_common(cfg, policy, params, res), pod=res.pod,
            stats=_stats_dict(res.session.last_stats),
            side_bytes=res.side.sent_bytes + res.side.recv_bytes,
            shards=_sha(res.prefill.state.cache if src else res.received),
            first=(res.prefill.first_token if src
                   else res.first_token).tolist(),
            tokens=None if src else res.tokens.tolist(),
            steps=[_sha(x) for x in logits])
    return out, {}


def fsdp_gathers(arch: str, shape, over=None, steps: int = 0) -> dict:
    """What a rank's gathers hand to gloo under the ``fsdp`` specs of a
    ``(pod, data, model)`` mesh of ``shape``, from the specs alone: a
    pass's bytes and all-gathers, and the prefill's and a decode step's
    (``tests/test_torch_serve_fsdp.py``'s docstring): per pass the
    gathered layers' and top-level leaves' ``data`` blocks, each padded
    to ``collective.ALIGN``, one all-gather a layer and a read."""
    import math

    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as TM
    cfg = with_overrides(get_config(arch).reduced(), over or {})
    sizes = dict(zip(("pod", "data", "model"), shape))
    pol = SH.ShardingPolicy(sizes, fsdp=True, pd_disaggregated=sizes["pod"] > 1)
    stacks, depth, tops = {}, {}, {}
    for p, x in TR.flatten_with_path(TM.abstract_params(cfg))[0]:
        path = SH.path_str(p)
        spec = pol.spec_for_param(path, tuple(x.shape))
        if not any("data" in SH.entry_axes(e) for e in spec):
            continue
        n = math.prod(SH.local_shape(tuple(x.shape), spec, sizes)) \
            * x.element_size()
        if SH.stack_dims(path):
            key = path.split("/")[0]
            n //= x.shape[0]
            stacks[key] = stacks.get(key, 0) + -(-n // CL.ALIGN) * CL.ALIGN
            depth[key] = x.shape[0]
        else:
            tops[path] = -(-n // CL.ALIGN) * CL.ALIGN
    layers = sum(stacks[k] * depth[k] for k in stacks)
    n_layers = sum(depth.values())

    def read(*names):
        got = sum(tops.get(k, 0) for k in names)
        return got, int(got > 0)
    head = read("final_norm", "embed" if cfg.tie_embeddings else "lm_head")
    first = read(*{"audio_frames": ("frontend_proj",),
                   "vision_patches": ("embed", "frontend_proj")}.get(
                       cfg.frontend, ("embed",)))
    step = read("embed")
    pre = (layers + first[0] + head[0], n_layers + first[1] + head[1])
    dec = (layers + step[0] + head[0], n_layers + step[1] + head[1])
    return {"prefill": pre, "step": dec, "layer_calls": n_layers,
            "decode_steps": 0 if cfg.encoder_only else steps}
