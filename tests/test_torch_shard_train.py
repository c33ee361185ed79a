"""The port's sharded train step across gloo ranks against the JAX
unsharded step, on the CPU.

The JAX step under a ``ShardingPolicy`` does not run on jax 0.9
(``with_sharding_constraint`` rejects Explicit axes; ROADMAP queue 3), and
GSPMD's contract is that sharding does not change the function, so the
port's sharded step (``training/train_step.py``, ``make_train_step(policy=)``)
is held against ``jax.jit(make_train_step(cfg))`` without a policy, on the
same initial state (the JAX seeded init, bitwise) and the same numpy
global batches: two steps of batch 8 x 16 at reduced smollm-135m on meshes
(pod 1, data 2) and, with ``grad_compress``, (pod 2, data 2), and at
reduced minicpm3-4b (the MLA family) on (pod 1, data 2).  The ranks are
spawned with ``tests/torch_ranks.py:run_world``.  (A ``model`` axis:
``tests/test_torch_tensor_parallel.py``.)  (Reduced mamba2-2.7b is
not held here: its two AdamW steps move the zero-initialised ``conv_b``
2 lr apart from JAX's where a near-zero gradient's sign flips, so
``tests/test_torch_train.py`` holds them with an exception for those
elements.)

Bounds, those of ``tests/test_torch_train.py`` for its three train steps,
and why: each rank's gradients are the gradients of its block of the
batch, averaged in f32 and rounded once to bf16 (twice with the ring: the
data mean, then the pod mean), where JAX differentiates the whole batch in
one program; both round bf16 at other places.  Loss within ``CE_ATOL`` =
2e-3 (seen: at most 1.9e-4), grad norm rtol 5e-3 (seen: 8.8e-4), each
parameter leaf within a relative L2 norm of 5e-3 (seen: 1.4e-3), the
moments within ``GRAD_RTOL`` = 5e-2 (seen: 2.2e-2), lr exact.

Held exactly: FSDP on and off give bitwise the same gathered state at
data 2 (each element's f32 sum is ``a + b`` in either layout, and the
norm is summed in FSDP blocks in both), every rank gathers the same
state, a rank holds exactly the bytes its specs give (parameters bf16,
moments f32, the moments shaped like their parameters), and a placed
``Checkpointer`` writes the gathered state, which the unsharded port
``Checkpointer`` and the JAX one load bitwise and from which the
unsharded launcher resumes; its restore, and ``reshard`` of the whole
state onto the policy, end in this rank's shards bitwise.
"""

import functools
import json

import pytest

jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

import torch_ranks  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.distributed import checkpoint as JCK  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.distributed import checkpoint as TCK  # noqa: E402
from repro_torch.distributed import tensor_parallel as TPM  # noqa: E402
from repro_torch.distributed.sharding import ShardingPolicy  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402

CE_ATOL, GRAD_RTOL, PARAM_RTOL = 2e-3, 5e-2, 5e-3
OPT = dict(lr=3e-4, total_steps=2, warmup_steps=1)
BATCH, SEQ, STEPS, KV_BLOCK = 8, 16, 2, 16


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view({1: np.int8, 2: np.int16, 4: np.int32}[x.dtype.itemsize])


def _f32(bits: np.ndarray, like) -> np.ndarray:
    """Port bits (a signed view) as f32 values of ``like``'s dtype."""
    if like.dtype == jax.numpy.bfloat16:
        return (bits.astype(np.int32) << 16).view(np.float32)
    return bits.view(np.asarray(like).dtype).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_ref(arch):
    """The JAX unsharded step's initial state, batches and results."""
    jc = jget(arch).reduced()
    state = JTS.init_state(jc, jax.random.PRNGKey(0))
    step = jax.jit(JTS.make_train_step(jc, JO.AdamWConfig(**OPT), None,
                                       kv_block=KV_BLOCK))
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, jc.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
               for _ in range(STEPS)]
    arrays = {f"batch{i}": b for i, b in enumerate(batches)}
    for p, x in jax.tree_util.tree_flatten_with_path(state)[0]:
        arrays["state/" + jax.tree_util.keystr(p)] = np.asarray(x).view(np.uint16) \
            if x.dtype == jax.numpy.bfloat16 else np.asarray(x)
    s, metrics = state, []
    for b in batches:
        s, m = step(s, {"tokens": b[:, :-1], "labels": b[:, 1:]})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, s, metrics, arrays


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One gloo world a case, run once for the module."""
    cache = {}

    def run(arch, shape, grad_compress):
        key = (arch, shape, grad_compress)
        if key not in cache:
            cache[key] = _world(tmp_path_factory.mktemp("shard"), arch, shape,
                                grad_compress)
        return cache[key]
    return run


def _world(tmp_path, arch, shape, grad_compress):
    init, final, metrics, arrays = jax_ref(arch)
    ref = tmp_path / "ref"
    ref.mkdir()
    np.savez(ref / "shard.npz", **arrays)
    (ref / "shard.json").write_text(json.dumps(
        {"opt": OPT, "batches": list(range(STEPS))}))
    out = tmp_path / "ranks"
    out.mkdir()
    world = int(np.prod(shape))
    torch_ranks.run_world(torch_ranks.shard_train_world, world, tmp_path,
                          str(ref), str(out), arch, shape, KV_BLOCK,
                          grad_compress, timeout=240)
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
    return final, metrics, ranks, np.load(out / "rank0.npz"), out


CASES = [("smollm-135m", (1, 2, 1), False), ("smollm-135m", (2, 2, 1), True),
         ("minicpm3-4b", (1, 2, 1), False)]


@pytest.mark.parametrize("arch,shape,grad_compress", CASES,
                         ids=["smollm-1x2x1", "smollm-2x2x1-ring", "minicpm3-1x2x1"])
def test_sharded_step_matches_jax_unsharded(world, arch, shape,
                                            grad_compress):
    final, jmetrics, ranks, got, out = world(arch, shape, grad_compress)
    for tag in ("fsdp", "replicated"):
        assert len({r["runs"][tag]["sha"] for r in ranks}) == 1, tag
        for r in ranks:
            run = r["runs"][tag]
            for tm, jm in zip(run["metrics"], jmetrics):
                assert abs(tm["loss"] - jm["loss"]) <= CE_ATOL
                assert abs(tm["ce"] - jm["ce"]) <= CE_ATOL
                np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                           rtol=5e-3)
                assert tm["lr"] == jm["lr"]
        flat = jax.tree_util.tree_flatten_with_path(final)[0]
        for p, x in flat:
            k = jax.tree_util.keystr(p)
            if k == ".opt.step":
                assert int(got[f"{tag}/{k}"]) == STEPS
                continue
            bound = PARAM_RTOL if k.startswith(".params") else GRAD_RTOL
            assert rel(np.asarray(x, np.float32),
                       _f32(got[f"{tag}/{k}"], x)) <= bound, (tag, k)
    # FSDP on and off: bitwise the same state
    assert ranks[0]["runs"]["fsdp"]["sha"] == ranks[0]["runs"]["replicated"]["sha"]
    for r in ranks:
        fs, rep = r["runs"]["fsdp"], r["runs"]["replicated"]
        assert fs["held"] == fs["spec_bytes"] and rep["held"] == rep["spec_bytes"]
        assert fs["moments_like_params"] and rep["moments_like_params"]
        assert fs["split_leaves"] > 0 and rep["split_leaves"] == 0
        # FSDP holds a data rank's share of the split leaves
        assert fs["held"]["params"] < rep["held"]["params"]
        assert fs["held"]["m"] * 4 < rep["held"]["m"] * 3
        assert fs["comm"]["gather"] > 0 and rep["comm"]["gather"] == 0
        assert fs["restored_shards_bitwise"] and fs["reshard_shards_bitwise"]


def test_placed_checkpoint_loads_unsharded_and_in_jax(world):
    final, _, ranks, got, out = world("smollm-135m", (1, 2, 1), False)
    ckpt = str(out / "ckpt")
    tc = tget("smollm-135m").reduced()
    back, extra, step = TCK.Checkpointer(ckpt, device="cpu").restore(
        TTS.abstract_state(tc))
    assert step == STEPS and extra == {"arch": tc.name}
    assert type(back) is TTS.TrainState and type(back.opt) is TO.AdamWState
    for p, x in TR.flatten_with_path(back)[0]:
        assert np.array_equal(torch_ranks.as_bits(x),
                              got["fsdp/" + torch_ranks._keystr(p)]), p
    jback, _, jstep = JCK.Checkpointer(ckpt).restore(final)
    assert jstep == STEPS
    for p, x in jax.tree_util.tree_flatten_with_path(jback)[0]:
        assert np.array_equal(_bits(x), got["fsdp/" + jax.tree_util.keystr(p)]), p


def test_launcher_data_axis_and_unsharded_resume(tmp_path, capsys):
    ckpt, out = tmp_path / "ck", tmp_path / "out"
    out.mkdir()
    torch_ranks.run_world(torch_ranks.launch_world, 2, tmp_path, str(ckpt),
                          str(out), timeout=240)
    lead, other = ((out / f"rank{r}.txt").read_text() for r in range(2))
    assert "done: 2 steps" in lead and "checkpointed -> " in lead
    assert other == ""
    assert TCK.steps_available(str(ckpt)) == [2]
    LT.main(["--arch", "smollm-135m", "--reduced", "--batch", "4", "--seq",
             "16", "--device", "cpu", "--steps", "3", "--ckpt-dir",
             str(ckpt), "--resume"])
    resumed = capsys.readouterr().out
    assert "resumed from step 2" in resumed and "done: 1 steps" in resumed


def test_gradient_reduction_and_failed_save_four_ranks(tmp_path):
    """At data 4, FSDP off reduce-scatters a splittable leaf and
    all-gathers its rounded blocks: bitwise the f32 rank-order mean, as
    FSDP's shards are, for twice FSDP's bytes received and half of what
    all-gathering the whole gradients would take.  A placed save whose
    write fails on rank 0 raises on every rank, well before the group's
    90 s timeout."""
    out = tmp_path / "ranks"
    out.mkdir()
    torch_ranks.run_world(torch_ranks.reduce_world, 4, tmp_path, str(out),
                          timeout=120)
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]
    for r in ranks:
        assert r["replicated_bitwise"] and r["fsdp_bitwise"]
        assert r["replicated_shapes"] == [[256, 32], [64, 8], [3]]
        assert r["fsdp_shapes"] == [[64, 32], [16, 8], [3]]
        assert r["replicated_recv_bytes"] == 2 * r["fsdp_recv_bytes"]
        assert 2 * r["replicated_recv_bytes"] == 3 * r["split_whole_bytes"]
        assert r["save_seconds"] < 30
    assert ranks[0]["save_raised"] == "OSError: no space left on device"
    for r in ranks[1:]:
        assert r["save_raised"] == (
            "RuntimeError: checkpoint of step 1: rank 0's write failed: "
            "OSError: no space left on device")
    assert not (out / "ckpt").exists()


@pytest.mark.parametrize("spec,want", [("2,2,1", (2, 2, 1)),
                                       ("1,2,1", (1, 2, 1)), ("4", (4, 1, 1)),
                                       ("2,1,1", (2, 1, 1))])
def test_parse_mesh_accepts_data_axis(spec, want):
    assert LT.parse_mesh(spec) == want


@pytest.mark.parametrize("spec,want", [("2,2,2", (2, 2, 2)),
                                       ("1,1,4", (1, 1, 4))])
def test_parse_mesh_accepts_model_axis(spec, want):
    assert LT.parse_mesh(spec) == want


def test_pods_without_ring_refused_data_axis_alone_not(capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    # pods without the ring sum raw over pod (the JAX launcher's step):
    # it gets as far as the process group
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 4"):
        LT.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                 "--mesh", "2,2,1"])
    # a data axis alone needs no ring: it gets as far as the process group
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        LT.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                 "--mesh", "1,2,1"])


@pytest.mark.parametrize("arch,family", [("mamba2-2.7b", "ssm"),
                                         ("recurrentgemma-9b", "hybrid"),
                                         ("qwen3-moe-30b-a3b", "moe")])
def test_tensor_parallel_accepted(arch, family):
    """Tensor parallelism covers every family: the SSM and hybrid ones
    build at a model axis of 2 with pods through the ring, MoE (split by
    experts) at a model axis of 2; and ``tensor_parallel`` refuses no
    family any more."""
    cfg = tget(arch).reduced()
    assert not hasattr(TPM, "REFUSED") and not hasattr(TPM, "refuse")
    if family == "moe":
        TTS.make_train_step(cfg, policy=ShardingPolicy(
            {"pod": 1, "data": 1, "model": 2}))
        return
    TTS.make_train_step(cfg, policy=ShardingPolicy(
        {"pod": 2, "data": 1, "model": 2}), grad_compress=True)


def test_moe_with_data_axis_refused():
    """No longer refused: a MoE batch split over data, or over pods with or
    without the ring, routes over its routing group (global-batch
    capacity and balance loss; ``distributed/expert_parallel.py``)."""
    cfg = tget("qwen3-moe-30b-a3b").reduced()
    for sizes, ring in (({"pod": 1, "data": 2, "model": 1}, False),
                        ({"pod": 2, "data": 2, "model": 1}, True),
                        ({"pod": 2, "data": 1, "model": 1}, False)):
        TTS.make_train_step(cfg, policy=ShardingPolicy(sizes),
                            grad_compress=ring)
    # the per-pod split under grad_compress is the JAX step's
    TTS.make_train_step(cfg, policy=ShardingPolicy(
        {"pod": 2, "data": 1, "model": 1}), grad_compress=True)
    TTS.make_train_step(cfg, policy=ShardingPolicy({"data": 1, "model": 1}))
