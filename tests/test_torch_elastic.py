"""The port's elastic re-meshing, checkpoint-restart training and training
launcher against the JAX package's, on the CPU.

* ``legal_meshes``, ``replan_after_failure`` and ``simulate_elastic_run``
  give the JAX package's plans, scores and order, exactly.
* ``reshard`` ships a ``TrainState`` (a NamedTuple: bf16 parameters,
  f32 moments on the hi/lo route, an int32 step) bitwise, with
  ``TransferStats`` equal to the JAX ``reshard``'s field by field, under
  faults too.  Its device check counts the ranks of the initialised group
  (1 without one), where JAX counts ``jax.device_count()``: a deliberate
  difference, pinned here.
* ``ResilientTrainer``: the trainer tests of ``tests/test_fault_tolerance.py``
  and ``tests/test_bulk_plane.py::TestResilientTrainerStats``, each run in
  both packages under the same ``FaultPlan`` with equal reports.
* A JAX-saved reduced ``TrainState`` checkpoint restores bitwise into the
  port and the reverse, with the same ``.params/...`` leaf keys in both
  manifests (a NamedTuple flattened as a plain tuple would key ``[0]/...``
  and fail the load).
* ``launch/train.py --device cpu --reduced`` runs, checkpoints and resumes
  to the losses of an uninterrupted run.
Every comparison is exact.
"""

import dataclasses
import json
import os

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.distributed import checkpoint as JCK  # noqa: E402
from repro.distributed import elastic as JEL  # noqa: E402
from repro.distributed import fault_tolerance as JFT  # noqa: E402
from repro.serving import faults as JF  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.distributed import checkpoint as TCK  # noqa: E402
from repro_torch.distributed import elastic as TEL  # noqa: E402
from repro_torch.distributed import fault_tolerance as TFT  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models.weights import train_state_from_jax  # noqa: E402
from repro_torch.serving import faults as TF  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402
from test_torch_faults import assert_same_stats  # noqa: E402

ARCHS = ("smollm-135m", "qwen3-moe-235b-a22b", "hubert-xlarge", "minicpm3-4b")


def plans_of(ps):
    return [(tuple(p.shape), tuple(p.axes), p.score) for p in ps]


def same_bits(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), TR.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert tuple(a.shape) == tuple(b.shape)
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}[b.element_size()]
        assert a.tobytes() == b.contiguous().view(ints).numpy().tobytes()


# ---------------------------------------------------------------------------
# mesh planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_legal_meshes_match_jax(arch):
    jc, tc = jget(arch), tget(arch)
    for batch in (1, 4, 8, 32):
        js, ts = JShape("t", 128, batch, "train"), TShape("t", 128, batch, "train")
        for n in (1, 2, 4, 6, 8, 16):
            assert plans_of(TEL.legal_meshes(n, tc, ts)) == \
                plans_of(JEL.legal_meshes(n, jc, js)), (batch, n)
            assert plans_of(TEL.legal_meshes(n, tc, ts, True, 2)) == \
                plans_of(JEL.legal_meshes(n, jc, js, True, 2)), (batch, n)


def test_rejects_dp_exceeding_global_batch():
    """The JAX regression: global_batch 4 on 8 chips admits no dp = 8."""
    shape = TShape(name="t", seq_len=128, global_batch=4, kind="train")
    plans = TEL.legal_meshes(8, tget("smollm-135m"), shape)
    assert plans
    for p in plans:
        assert shape.global_batch % p.shape[0] == 0
        assert p.shape[0] <= shape.global_batch
    assert (8, 1) not in {p.shape for p in plans}


def test_multi_pod_divisibility():
    shape = TShape(name="t", seq_len=128, global_batch=4, kind="train")
    for p in TEL.legal_meshes(8, tget("smollm-135m"), shape, multi_pod=True,
                              n_pods=2):
        assert shape.global_batch % (p.shape[0] * p.shape[1]) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_replan_and_simulate_match_jax(arch):
    jc, tc = jget(arch), tget(arch)
    js, ts = JShape("t", 128, 8, "train"), TShape("t", 128, 8, "train")
    currents = [((4, 2), ("data", "model")), ((2, 4, 1), ("pod", "data", "model")),
                ((1, 1), ("data", "model"))]
    for shape, axes in currents:
        jcur = JEL.MeshPlan(shape, axes, 0.0)
        tcur = TEL.MeshPlan(shape, axes, 0.0)
        for surviving in (0, 1, 3, 5, 7, 12):
            jn = JEL.replan_after_failure(jcur, surviving, jc, js)
            tn = TEL.replan_after_failure(tcur, surviving, tc, ts)
            assert (tn is None) == (jn is None)
            if jn is not None:
                assert plans_of([tn]) == plans_of([jn]), (shape, surviving)
                assert tn.n_devices == jn.n_devices
    kinds = [(3, "shrink", -2), (1, "shrink", -1), (7, "grow", 4), (9, "shrink", -20)]
    jh = JEL.simulate_elastic_run([JEL.ElasticEvent(*e) for e in kinds], 8, jc, js)
    th = TEL.simulate_elastic_run([TEL.ElasticEvent(*e) for e in kinds], 8, tc, ts)
    assert plans_of(th) == plans_of(jh) and len(th) == len(kinds) + 1


# ---------------------------------------------------------------------------
# reshard
# ---------------------------------------------------------------------------

def small_states(seed=3):
    rng = np.random.default_rng(seed)
    p = {"w": rng.normal(size=(256, 64)).astype(np.float32),
         "norm": (1 + 0.01 * rng.normal(size=(64,))).astype(np.float32)}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    m = {k: jnp.asarray(rng.normal(size=v.shape) * 1e-3, jnp.float32) for k, v in p.items()}
    v = {k: jnp.asarray(np.abs(rng.normal(size=v.shape)) * 1e-6, jnp.float32)
         for k, v in p.items()}
    js = JTS.TrainState(params=jp, opt=JO.AdamWState(
        step=jnp.asarray(7, jnp.int32), m=m, v=v))
    return js, train_state_from_jax(jax.tree.map(np.asarray, js))


@pytest.mark.parametrize("faulty", [False, True])
def test_reshard_round_trip_matches_jax(faulty):
    js, ts = small_states()
    one = (1, 1), ("data", "model")
    kw = {}
    if faulty:
        kw = dict(verify=True)
        jkw = dict(kw, faults=JF.FaultPlan(corrupt_chunks=(0,), seed=2))
        tkw = dict(kw, faults=TF.FaultPlan(corrupt_chunks=(0,), seed=2))
    else:
        jkw = tkw = kw
    jo, jstats = JEL.reshard(js, None, JEL.MeshPlan(*one, 0.0), **jkw)
    to, tstats = TEL.reshard(ts, None, TEL.MeshPlan(*one, 0.0), device="cpu", **tkw)
    assert type(to) is TTS.TrainState and type(to.opt) is TO.AdamWState
    same_bits(js, to)
    same_bits(jo, to)
    assert_same_stats(jstats, tstats)
    assert set(tstats.leaf_ok) >= {".params/w", ".opt/.m/w"}
    if faulty:
        assert tstats.refetches == tstats.verify_failures > 0
    back, _ = TEL.reshard(to, TEL.MeshPlan(*one, 0.0), TEL.MeshPlan(*one, 0.0),
                          device="cpu")
    same_bits(js, back)


def test_reshard_counts_the_group_not_jax_devices():
    """Without a process group the port sees one device, so a 2-device
    plan is refused (JAX counts its host devices)."""
    _, ts = small_states()
    assert TEL.visible_devices() == 1
    with pytest.raises(ValueError, match="devices"):
        TEL.reshard(ts, None, TEL.MeshPlan((2, 1), ("data", "model"), 0.0),
                    device="cpu")
    with pytest.raises(ValueError, match="devices"):
        TEL.reshard(ts, None, TEL.MeshPlan((64, 64), ("data", "model"), 0.0),
                    device="cpu")


# ---------------------------------------------------------------------------
# ResilientTrainer
# ---------------------------------------------------------------------------

def _trainers(fault_source, cfg_kw, saves):
    """The same closure trainer in both packages (``test_fault_tolerance``'s)."""
    out = []
    for FT, log in ((JFT, saves[0]), (TFT, saves[1])):
        ckpt = {"state": 0, "step": 0}

        def step_fn(state, step):
            return state + 1, {"loss": float(step)}

        def save_fn(step, state, ckpt=ckpt, log=log):
            log.append(step)
            ckpt["state"], ckpt["step"] = state, step

        def restore_fn(ckpt=ckpt):
            return ckpt["state"], ckpt["step"]

        out.append(FT.ResilientTrainer(step_fn, save_fn, restore_fn,
                                       FT.FaultConfig(**cfg_kw),
                                       fault_source=fault_source()))
    return out


def _crashes(at):
    def make():
        fired = set()

        def faults(step):
            if step in at and step not in fired:
                fired.add(step)
                return "crash"
            return None
        return faults
    return make


@pytest.mark.parametrize("case", ["crashes", "cadence", "stragglers"])
def test_trainer_reports_match_jax(case):
    source, cfg_kw, total = {
        "crashes": (_crashes({7, 12}), dict(max_restarts=4, checkpoint_every=5), 20),
        "cadence": (lambda: (lambda s: None), dict(checkpoint_every=4), 10),
        "stragglers": (lambda: (lambda s: "straggler:2" if s in (1, 5) else None),
                       dict(max_restarts=4, checkpoint_every=5), 8),
    }[case]
    saves = ([], [])
    jt, tt = _trainers(source, cfg_kw, saves)
    jr, tr = jt.run(0, total), tt.run(0, total)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert saves[1] == saves[0]
    assert tr.steps_completed == total
    if case == "crashes":
        assert tr.restarts == tr.failures_seen == 2
    if case == "cadence":
        assert saves[1] == [4, 8, 10]
    if case == "stragglers":
        assert tr.stragglers_mitigated == 2


def test_trainer_restart_budget_exhausts_loudly():
    saves = ([], [])
    for tr in _trainers(lambda: (lambda s: "crash" if s == 3 else None),
                        dict(max_restarts=2, checkpoint_every=5), saves):
        with pytest.raises(RuntimeError, match="restart budget"):
            tr.run(0, 10)


def test_trainer_argument_checks():
    with pytest.raises(ValueError, match="not both"):
        TFT.ResilientTrainer(lambda s, i: (s, {}), lambda *a: None,
                             checkpointer=object())
    with pytest.raises(ValueError, match="need"):
        TFT.ResilientTrainer(lambda s, i: (s, {}))


def test_checkpointer_recovery_stats_match_jax(tmp_path):
    """``TestResilientTrainerStats``: crashes restored through a
    Checkpointer under a corrupting FaultPlan; the reports and the
    aggregated TransferStats equal the JAX run's."""
    reports = []
    for name, CK, FT, FP, state, inc in (
            ("jax", JCK, JFT, JF,
             {"w": jnp.zeros((64, 64), jnp.bfloat16)},
             lambda s: jax.tree.map(lambda x: x + 1, s)),
            ("port", TCK, TFT, TF,
             {"w": torch.zeros((64, 64), dtype=torch.bfloat16)},
             lambda s: {k: x + 1 for k, x in s.items()})):
        kw = {} if CK is JCK else {"device": "cpu"}
        ck = CK.Checkpointer(str(tmp_path / name), **kw,
                             faults=FP.FaultPlan(corrupt_chunks=(0,),
                                                 persistent_attempts=1))
        tr = FT.ResilientTrainer(
            lambda s, i, inc=inc: (inc(s), {"loss": float(i)}),
            cfg=FT.FaultConfig(max_restarts=4, checkpoint_every=5),
            fault_source=_crashes({7, 12})(), checkpointer=ck)
        rep = tr.run(state, 20)
        reports.append((rep, tr))
    (jr, _), (tr_, trainer) = reports
    assert tr_.steps_completed == 20 and tr_.restarts == 2
    assert tr_.transfer_stats.refetches > 0 and tr_.transfer_stats.verify_failures > 0
    assert tr_.transfer_stats.wire_bytes > 0
    assert_same_stats(jr.transfer_stats, tr_.transfer_stats)
    assert {k: v for k, v in dataclasses.asdict(tr_).items() if k != "transfer_stats"} \
        == {k: v for k, v in dataclasses.asdict(jr).items() if k != "transfer_stats"}


def test_checkpointer_cold_restart_before_first_save(tmp_path):
    ck = TCK.Checkpointer(str(tmp_path), device="cpu")
    tr = TFT.ResilientTrainer(lambda s, i: (s + 1, {"loss": 0.0}),
                              cfg=TFT.FaultConfig(checkpoint_every=5),
                              fault_source=_crashes({2})(), checkpointer=ck)
    rep = tr.run(torch.zeros(4), 6)
    assert rep.restarts == 1 and rep.steps_completed == 6


def test_closure_api_unchanged():
    saves = []
    tr = TFT.ResilientTrainer(lambda s, i: (s, {"loss": 0.0}),
                              lambda s, st: saves.append(s),
                              lambda: ({"w": 0}, 0),
                              TFT.FaultConfig(max_restarts=4, checkpoint_every=5))
    rep = tr.run({"w": 0}, 6)
    assert rep.steps_completed == 6 and rep.transfer_stats is None
    assert saves == [5, 6]


# ---------------------------------------------------------------------------
# train-state checkpoints across packages
# ---------------------------------------------------------------------------

def test_train_state_checkpoints_cross_packages(tmp_path):
    jc = jget("smollm-135m").reduced()
    js = JTS.init_state(jc, jax.random.PRNGKey(0))
    ts = train_state_from_jax(jax.tree.map(np.asarray, js))
    JCK.Checkpointer(str(tmp_path / "jax")).save(3, js, extra={"arch": jc.name})
    out, extra, step = TCK.Checkpointer(str(tmp_path / "jax"), device="cpu").restore(ts)
    assert step == 3 and extra == {"arch": jc.name}
    assert type(out) is TTS.TrainState and type(out.opt) is TO.AdamWState
    same_bits(js, out)
    TCK.Checkpointer(str(tmp_path / "port")).save(5, ts)
    jo, _, jstep = JCK.Checkpointer(str(tmp_path / "port")).restore(js)
    assert jstep == 5 and type(jo) is JTS.TrainState
    same_bits(jo, ts)
    manifests = [json.loads((tmp_path / d / f"step_{s:010d}" / TCK.MANIFEST).read_text())
                 for d, s in (("jax", 3), ("port", 5))]
    keys = [[e["key"] for e in m["leaves"]] for m in manifests]
    assert keys[0] == keys[1] and keys[0][0] == ".params/embed"
    assert ".opt/.step" in keys[0] and ".opt/.m/embed" in keys[0]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(capsys, *args):
    LT.main(["--arch", "smollm-135m", "--reduced", "--batch", "2", "--seq", "16",
             "--device", "cpu", *args])
    return capsys.readouterr().out


def _losses(out):
    return {int(ln.split()[1]): ln.split()[3] for ln in out.splitlines()
            if ln.startswith("step ")}


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    first = _launch(capsys, "--steps", "3", "--ckpt-dir", d, "--ckpt-every", "2")
    assert sorted(_losses(first)) == [0, 1, 2]
    assert first.count("checkpointed -> ") == 1
    assert "done: 3 steps" in first and "checkpoint plane: " in first
    assert TCK.steps_available(d) == [2]
    resumed = _launch(capsys, "--steps", "3", "--ckpt-dir", d, "--resume")
    assert "resumed from step 2" in resumed and "done: 1 steps" in resumed
    assert sorted(_losses(resumed)) == [2]
    # the data stream and the restored state give the uninterrupted step
    assert _losses(resumed)[2] == _losses(first)[2]


def test_launcher_refusals(capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    # pods without the ring (a raw sum over pod) reach the process group
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        _launch(capsys, "--mesh", "2")
    with pytest.raises(SystemExit, match="torchrun"):
        _launch(capsys, "--mesh", "2", "--grad-compress")
    # a model axis is tensor parallelism: one process for each of 2 x 1 x 2
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 4"):
        _launch(capsys, "--mesh", "2,1,2", "--grad-compress")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LT.main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])
    assert os.environ.get("WORLD_SIZE") is None
