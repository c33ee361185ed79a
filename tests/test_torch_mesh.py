"""The port's mesh executor across gloo ranks against the JAX mesh executor.

A JAX subprocess (4 host devices) runs the JAX session's own mesh program
(``_build_mesh_fn``: what ``transfer(cache, select_dst=False)`` runs,
compiled once with ``jax.jit`` so one executable gives the output and the
post-SPMD HLO) on meshes ``(2, 1, 1)`` and ``(2, 2, 1)`` at n_chunks 1 and
4, and writes the inputs, each output at ``dst_pod`` (a host index), the
``collective-permute`` bytes of the HLO and the default leaf specs.  The
port's ranks (``tests/torch_ranks.py``, one world a test) run the same
plans: every destination rank's shard is held bitwise against the JAX
output and against the input (bf16 K/V, an f32 leaf on the hi/lo route, a
float8_e5m2 leaf, a raw int32 leaf).

Deliberate differences, each pinned here:
(a) source ranks decode nothing (the JAX body decodes zero-filled streams
    at ``src_pod``);
(b) a shard that overflows its escape capacity walks the capacity schedule
    and falls back to raw, so it arrives intact (the JAX body encodes once
    at plan capacity and ships the overflowed streams);
(c) ``last_stats`` counts the bytes each rank handed to
    ``torch.distributed`` (JAX: None).  They equal the HLO's permute bytes
    less the unused escape slots, which the port does not ship, plus the
    escape counts and ``ok`` bytes, which XLA drops as dead
    (``torch_ranks.jax_permute_bytes``).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_ranks  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.launch.mesh import describe, make_mesh  # noqa: E402
from repro_torch.serving import collective as CL  # noqa: E402
from repro_torch.serving.plan import TransferConfig, TransferPlan  # noqa: E402
from repro_torch.serving.transfer import transfer_cache_cross_pod  # noqa: E402

JAX_MESH_SCRIPT = textwrap.dedent(r"""
    import json, os, re, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.core import codebook as cbm
    from repro.serving.plan import TransferConfig, TransferPlan

    out_dir = sys.argv[1]
    rng = np.random.default_rng(0)
    def kv(shape):
        x = rng.normal(size=shape) * rng.choice([0.25, 1.0, 4.0], size=shape)
        return jnp.asarray(x, dtype=jnp.bfloat16)
    cache = {"k": kv((2, 4, 64, 2, 16)), "v": kv((2, 4, 64, 2, 16)),
             "ssm": jnp.asarray(rng.normal(size=(2, 4, 32)), jnp.float32),
             "act8": jnp.asarray(rng.normal(size=(2, 128)) * 0.5,
                                 jnp.float8_e5m2),
             "small": jnp.arange(6, dtype=jnp.int32)}
    # random bits: far more escapes a 256-element chunk than cap 16 holds
    noisy = {"k": jnp.asarray(rng.integers(0, 1 << 16, size=(2, 4, 64, 2, 16),
                                           dtype=np.uint16)).view(jnp.bfloat16)}
    cb = cbm.calibrate([np.asarray(jax.lax.bitcast_convert_type(
        cache["k"], jnp.uint16))], k=16)
    W = {1: np.uint8, 2: np.uint16, 4: np.uint32}
    def bits(x):
        x = np.asarray(x)
        return x.view(W[x.dtype.itemsize])
    SIZE = {"pred": 1, "u8": 1, "s8": 1, "u16": 2, "s16": 2, "bf16": 2,
            "u32": 4, "s32": 4, "f32": 4}
    def permute_bytes(hlo):
        total = 0
        for line in hlo.splitlines():
            m = re.search(r"=\s*(.*?)\s+collective-permute(?:-start)?\(", line)
            for dt, dims in (re.findall(r"(\w+)\[([\d,]*)\]", m.group(1))
                             if m else ()):
                total += int(np.prod([int(d) for d in dims.split(",") if d])) * SIZE[dt]
        return total
    res = {}
    meta = {"codebook": cb.to_json(), "hlo_bytes": {}, "specs": {},
            "dtypes": {"in": {k: str(x.dtype) for k, x in cache.items()},
                       "in_noisy": {"k": "bfloat16"}}}
    for k, x in cache.items():
        res[f"in/{k}"] = bits(x)
    res["in_noisy/k"] = bits(noisy["k"])
    for shape in [(2, 1, 1), (2, 2, 1)]:
        mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                    ("pod", "data", "model"))
        name = "x".join(map(str, shape))
        meta["specs"][name] = [list(TransferPlan._default_leaf_spec(x, mesh))
                               for x in jax.tree.leaves(cache)]
        for n_chunks in (1, 4):
            for tag, c in (("", cache), ("noisy", noisy)):
                if tag and shape != (2, 1, 1):
                    continue
                tc = TransferConfig(codebook=cb, chunk=256, cap=16,
                                    n_chunks=n_chunks, compress_fp32=True)
                sess = TransferPlan.build(c, tc, mesh=mesh).session()
                leaves, treedef = jax.tree_util.tree_flatten(c)
                compiled = jax.jit(sess._build_mesh_fn()).lower(*leaves).compile()
                out = jax.tree_util.tree_unflatten(treedef, compiled(*leaves))
                key = f"{name}/n{n_chunks}{tag}"
                for p, x in jax.tree_util.tree_flatten_with_path(out)[0]:
                    res[f"out/{key}/{p[0].key}"] = bits(np.asarray(x)[sess.plan.dst_pod])
                    res[f"src/{key}/{p[0].key}"] = bits(np.asarray(x)[sess.plan.src_pod])
                meta["hlo_bytes"][key] = permute_bytes(compiled.as_text())
    # the pd_disaggregated policy's cache specs drive the hop (the dry
    # run's TransferPlan.build(mesh=, specs=policy.cache_specs(cache)))
    from repro.distributed.sharding import ShardingPolicy
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2, 1),
                ("pod", "data", "model"))
    kvc = {"k": cache["k"], "v": cache["v"]}
    specs = ShardingPolicy(mesh, pd_disaggregated=True).cache_specs(kvc)
    for n_chunks in (1, 4):
        tc = TransferConfig(codebook=cb, chunk=256, cap=16, n_chunks=n_chunks)
        sess = TransferPlan.build(kvc, tc, mesh=mesh, specs=specs).session()
        leaves, treedef = jax.tree_util.tree_flatten(kvc)
        out = jax.tree_util.tree_unflatten(
            treedef, jax.jit(sess._build_mesh_fn())(*leaves))
        for k, x in out.items():
            res[f"out/pd/n{n_chunks}/{k}"] = bits(np.asarray(x)[sess.plan.dst_pod])
        meta["pd_in_specs"] = [list(s) for s in sess.plan.in_specs]
    np.savez(os.path.join(out_dir, "mesh.npz"), **res)
    with open(os.path.join(out_dir, "mesh.json"), "w") as f:
        json.dump(meta, f)
    print("MESH-JAX-OK")
""")


def _subprocess_env():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get(
        "PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_mesh")
    out = subprocess.run([sys.executable, "-c", JAX_MESH_SCRIPT, str(d)],
                         capture_output=True, text=True, env=_subprocess_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return d, np.load(d / "mesh.npz"), json.loads((d / "mesh.json").read_text())


def _world(tmp_path, ref_dir, shape, noisy=False):
    out = tmp_path / "ranks"
    out.mkdir()
    world = int(np.prod(shape))
    torch_ranks.run_world(torch_ranks.mesh_world, world, tmp_path, str(ref_dir),
                          shape, str(out), noisy, timeout=240)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 1)], ids=["2x1x1", "2x2x1"])
def test_mesh_hop_matches_jax(tmp_path, jax_ref, shape):
    """Every destination shard bitwise equal to the JAX output at dst_pod
    and to the input (asserted in the ranks), whole-tensor and chunked,
    ``select_dst`` both ways and the one-shot shim; then the pinned
    differences (a) and (c), and the default specs."""
    ref_dir, ref, meta = jax_ref
    ranks = _world(tmp_path, ref_dir, shape)
    name = "x".join(map(str, shape))
    for r in ranks:
        assert r["specs"] == meta["specs"][name]
        for key, case in r["cases"].items():
            st = case["stats"]
            wire = (sum(st["chunk_wire_bytes"]) + sum(st["leaf_wire_bytes"].values())
                    + st["raw_passthrough_bytes"] + st["fp32_lo_wire_bytes"]
                    + st["fp8_wire_bytes"])
            assert all(st["chunk_ok"]) and all(st["leaf_ok"].values())
            # (c): both ends count the same unit bytes; with the unused
            # escape slots added back they are the HLO's permute bytes
            assert case["jax_bytes"] == meta["hlo_bytes"][key]
            assert wire < meta["hlo_bytes"][key]
            if r["pod"] == 0:
                assert case["decodes"] == 0          # (a)
                assert case["sent"] > wire and case["received"] == 0
            else:
                assert case["jax_equal"] and case["decodes"] > 0
                assert case["received"] > wire and case["sent"] == 0
    src = {json.dumps(r["cases"][f"{name}/n1"]["stats"]) for r in ranks
           if r["pod"] == 0}
    dst = {json.dumps(r["cases"][f"{name}/n1"]["stats"]) for r in ranks
           if r["pod"] == 1}
    if shape == (2, 1, 1):
        assert src == dst
    # (a), the JAX side: index src_pod holds a decode of zero-filled streams
    assert not np.array_equal(ref[f"src/{name}/n1/k"], ref["in/k"])


def test_policy_cache_specs_drive_mesh_hop(tmp_path, jax_ref):
    """The port's ``pd_disaggregated`` policy on (pod 2, data 2): its
    ``cache_specs`` build the plan whose ``in_specs`` equal the JAX plan's
    from the JAX policy's specs, and every destination shard equals the
    JAX mesh program's output at ``dst_pod`` and the input, bitwise
    (asserted in the ranks), at n_chunks 1 and 4."""
    ref_dir, ref, meta = jax_ref
    out = tmp_path / "ranks"
    out.mkdir()
    torch_ranks.run_world(torch_ranks.mesh_policy_world, 4, tmp_path,
                          str(ref_dir), str(out), timeout=240)
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]
    for r in ranks:
        assert r["in_specs"] == meta["pd_in_specs"]
        assert r["in_specs"][0][1] == "data"
        if r["pod"] == 1:
            assert r["jax_equal"] == [True, True] and r["whole_equal"]
        else:
            assert r["sent"] > 0


def test_overflowing_shard_arrives_intact(tmp_path, jax_ref):
    """(b), both sides: a leaf of random bits at cap 16.  The JAX mesh
    output differs from the input; the port's shard walks the capacity
    schedule (retries, then raw) and equals it bitwise."""
    ref_dir, ref, meta = jax_ref
    for n in (1, 4):
        assert not np.array_equal(ref[f"out/2x1x1/n{n}noisy/k"], ref["in_noisy/k"])
    ranks = _world(tmp_path, ref_dir, (2, 1, 1), noisy=True)
    dst = [r for r in ranks if r["pod"] == 1][0]
    for key in ("2x1x1/n1noisy", "2x1x1/n4noisy"):
        case = dst["cases"][key]
        st = case["stats"]
        assert not case["jax_equal"]       # the shard equals the input instead
        assert (not all(st["leaf_ok"].values()) or not all(st["chunk_ok"])
                or sum(st["chunk_retry_steps"]) > 0)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s1",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_plan_validation(world_of_one):
    cb = tcb.DEFAULT_BF16_CODEBOOK
    cache = {"k": torch.zeros(4, 8, dtype=torch.bfloat16),
             "f": torch.zeros(3, dtype=torch.float32)}
    tc = TransferConfig(codebook=cb)
    with pytest.raises(ValueError, match="'pod'"):
        TransferPlan.build(cache, tc, mesh=make_mesh((1,), ("data",)))
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    assert describe(mesh) == "pod=1 × data=1 × model=1  (1 ranks, cpu transport)"
    with pytest.raises(ValueError, match="host-side"):
        TransferPlan.build(cache, TransferConfig(codebook=cb, backend="wire"),
                           mesh=mesh)
    with pytest.raises(ValueError, match="not a mesh dimension"):
        TransferPlan.build(cache, tc, mesh=mesh, specs=(("x",), ()))
    with pytest.raises(ValueError, match="specs for"):
        TransferPlan.build(cache, tc, mesh=mesh, specs=((),))
    with pytest.raises(ValueError, match="more entries"):
        TransferPlan.build(cache, tc, mesh=mesh, specs=((None, None), ()))
    plan = TransferPlan.build(cache, tc, mesh=mesh)
    assert plan.in_specs == ((None,), (None, "data"))   # leaves f, k
    assert "target=mesh(pod 0->1)" in plan.describe()
    with pytest.raises(ValueError, match="verify/faults"):
        plan.session(verify=True)
    sess = plan.session(device="cpu")
    with pytest.raises(ValueError, match="two pods of 1"):
        sess.transfer(cache)
    for call in (lambda: sess.transfer_compressed(cache),
                 lambda: sess.resend_last(), lambda: sess.enable_prefix_cache(),
                 lambda: sess.save("x", cache), lambda: sess.load("x"),
                 lambda: sess.reshard(cache)):
        with pytest.raises(ValueError, match="mesh"):
            call()
    with pytest.raises(ValueError, match="return_hlo"):
        transfer_cache_cross_pod(cache, mesh, tc, return_hlo=True)


def test_make_mesh_and_transport_refusals(monkeypatch, tmp_path):
    with pytest.raises(RuntimeError, match="initialised"):
        make_mesh((2,), ("pod",))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s2",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh((2,), ("pod",))
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        with pytest.raises(NotImplementedError, match="gloo only"):
            CL.Link(None, "cpu", CL.CommStats())
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
