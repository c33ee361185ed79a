"""The port's multi-pod dry run (``repro_torch.launch.dryrun``,
``repro_torch.analysis.roofline``, ``make_production_mesh``, the abstract
stand-ins of ``models/model.py``) against the JAX package's and against
the port's own gloo ranks, on the CPU.

Held against the JAX package:

* ``cells()`` and ``shape_applicable`` for every architecture and shape,
  reason strings included; the variant tables and ``_cell_id`` (read from
  the JAX module in a subprocess: importing it sets ``XLA_FLAGS`` to 512
  host devices);
* ``abstract_params``, ``input_specs`` and ``abstract_state`` at full size
  for every architecture: each leaf's path, shape and dtype equal to the
  JAX ``jax.eval_shape`` ones;
* ``model_flops_estimate`` for every cell, and ``RooflineReport.to_dict()``
  on the ``V5E`` record for given inputs: equal;
* ``attn_overrides(score_dtype=bf16, kv_block=8)`` on a reduced prefill
  against the JAX prefill under its own ``attn_overrides``: the cache and
  the last logits within ATOL 4e-2 / RTOL 2e-2 (the serving files' bound:
  the bf16 scores and ``p`` round in the same places, the f32 sums in
  another order), and away from the port's own prefill without them (the
  knobs act).

Held against the port's own real runs: a reduced dense prefill's FLOPs
equal the sum of its products (2·m·n·k) exactly; reduced dense, MLA and
MoE worlds are dry-run on fake ranks and then run on real gloo ranks
(``torch_ranks.dryrun_world``), and every rank's held parameter and cache
bytes, ``tp.fwd`` bytes and messages (the prefill's and the decode step's),
collectives over ``model`` and the hop's raw units are predicted exactly,
its compressed units within the predicted capacity bytes (a unit that
overflowed its capacity on the real ranks and shipped raw is data the
static figure cannot see: the dry run ships every unit compressed).  An
``fsdp`` prefill and decode cell on (1, 2, 2) holds the ``fsdp`` spec
arithmetic's parameter bytes and gathers one pass of blocks
(``torch_ranks.fsdp_gathers``) over the ``base`` cell's traffic.  The production
meshes on 256- and 512-rank fake groups (a subprocess) have JAX's shapes
and axis names, ``check_transport`` refuses a ``fake`` group outside the
dry run, and ``run_cell`` records a cell that does not apply as skipped
with JAX's reason.  Every fake group here is torn down before the test
ends (``dryrun.fake_world``).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_ranks  # noqa: E402
from repro.analysis import roofline as JRL  # noqa: E402
from repro.configs import base as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.analysis import roofline as RL  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import abstract as AB  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.distributed import sharding as TSH  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving import collective as CL  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = list(TB.PORTED)
ATOL, RTOL = 4e-2, 2e-2


def _jax_leaves(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree):
    return [(torch_ranks._keystr(p), tuple(x.shape),
             str(x.dtype).replace("torch.", ""))
            for p, x in TR.flatten_with_path(tree)[0]]


# ---------------------------------------------------------------------------
# held against the JAX package
# ---------------------------------------------------------------------------

def test_cells_and_shape_applicable_match_jax():
    assert TB.ARCH_IDS == JB.ARCH_IDS and sorted(TB.SHAPES) == sorted(JB.SHAPES)
    for arch in ARCHS:
        for name in TB.SHAPES:
            got = TB.shape_applicable(TB.get_config(arch), TB.SHAPES[name])
            want = JB.shape_applicable(JB.get_config(arch), JB.SHAPES[name])
            assert got == want, (arch, name)
    assert TB.cells() == JB.cells()
    assert TB.cells(ARCHS) == JB.cells(ARCHS)


def test_variant_tables_and_cell_ids_match_jax():
    code = textwrap.dedent("""
        import json
        import repro.launch.dryrun as D
        print(json.dumps([D.POLICY_VARIANTS, D.ATTN_VARIANTS,
                          D._cell_id("qwen3-32b", "prefill_32k", True,
                                     "xfer_chunked"),
                          D._cell_id("smollm-135m", "train_4k", False)]))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    pv, av, c1, c2 = json.loads(out.stdout.strip().splitlines()[-1])
    assert D.POLICY_VARIANTS == pv
    assert D.ATTN_VARIANTS == av
    assert D._cell_id("qwen3-32b", "prefill_32k", True, "xfer_chunked") == c1
    assert D._cell_id("smollm-135m", "train_4k", False) == c2


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_inputs_and_state_match_jax_at_full_size(arch):
    jc, tc = JB.get_config(arch), TB.get_config(arch)
    want = jax.eval_shape(lambda: JM.init_params(jc, jax.random.PRNGKey(0)))
    got = TM.abstract_params(tc)
    assert all(x.device.type == "meta" for x in TR.leaves(got))
    assert _port_leaves(got) == _jax_leaves(want)
    for name in TB.SHAPES:
        assert _port_leaves(TM.input_specs(tc, TB.SHAPES[name])) == \
            _jax_leaves(JM.input_specs(jc, JB.SHAPES[name])), name
        shape = JB.SHAPES[name]
        if shape.kind != "decode" or jc.encoder_only:
            continue
        js = JM.abstract_state(jc, shape.global_batch, shape.seq_len)
        ts = TM.abstract_state(tc, shape.global_batch, shape.seq_len)
        assert _port_leaves(ts.cache) == _jax_leaves(js.cache), name
        assert _port_leaves(ts.cache_len) == _jax_leaves(js.cache_len)


def test_model_flops_estimate_matches_jax_for_every_cell():
    for arch, name in TB.cells(ARCHS):
        got = RL.model_flops_estimate(TB.get_config(arch), TB.SHAPES[name])
        want = JRL.model_flops_estimate(JB.get_config(arch), JB.SHAPES[name])
        assert got == want, (arch, name)


@pytest.mark.parametrize("arch,shape,chips,flops,nbytes,colls,peak", [
    ("qwen3-32b", "prefill_32k", 512, 2.4e14, 3.1e12,
     {"all-gather": 5, "all-to-all": 7e9, "collective-permute": 9e8}, 1.6e10),
    ("smollm-135m", "train_4k", 256, 9.1e12, 2.3e12, {"all-reduce": 3e6},
     None),
    ("mamba2-2.7b", "long_500k", 256, 1.0, 0.0, {}, 0.0),
])
def test_roofline_report_on_v5e_matches_jax(arch, shape, chips, flops, nbytes,
                                            colls, peak):
    colls = {k: colls.get(k, 0) for k in RL.COLLECTIVES}
    mem = None if peak is None else {"peak_bytes": peak}
    cost = {"flops": flops, "bytes accessed": nbytes}
    want = JRL.build_report(arch, JB.SHAPES[shape], "m", chips, cost, "",
                            JB.get_config(arch), mem, colls=colls)
    got = RL.build_report(arch, TB.SHAPES[shape], "m", chips, cost,
                          TB.get_config(arch), mem, colls=colls,
                          device=RL.V5E)
    assert got.to_dict() == want.to_dict()
    assert (RL.V5E.peak_flops, RL.V5E.hbm_bw, RL.V5E.link_bw) == \
        (JRL.PEAK_FLOPS, JRL.HBM_BW, JRL.ICI_BW)
    h100 = RL.build_report(arch, TB.SHAPES[shape], "m", chips, cost,
                           TB.get_config(arch), mem, colls=colls)
    assert h100.t_compute == flops * chips / (chips * 989e12)
    assert h100.t_collective == sum(colls.values()) / 50e9


def test_attn_overrides_prefill_matches_jax():
    b, s, max_seq = 2, 16, 24
    jc, tc = JB.get_config("smollm-135m").reduced(), \
        TB.get_config("smollm-135m").reduced()
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (b, s))
    toks = toks.astype(np.int32)
    with JL.attn_overrides(score_dtype=jnp.bfloat16, kv_block=8):
        jl, js = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                            max_seq=max_seq)
    with TL.attn_overrides(score_dtype=torch.bfloat16, kv_block=8):
        tl, ts = TM.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                            max_seq=max_seq)
    assert TL._ATTN_OVERRIDES == {}
    plain, _ = TM.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                          max_seq=max_seq)
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl, np.float32), atol=ATOL,
                               rtol=RTOL)
    for k in js.cache:
        np.testing.assert_allclose(ts.cache[k].float().numpy(),
                                   np.asarray(js.cache[k], np.float32),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    assert not torch.equal(tl, plain)        # the knobs act
    # the flash kernel has neither knob: the card's path refuses them
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), AB.tracing(card=True):
        q = torch.empty(1, 8, 4, 32, dtype=torch.bfloat16)
        k = torch.empty(1, 8, 2, 32, dtype=torch.bfloat16)
        assert TL.prefill_attention(q, k, k).shape == (1, 8, 4, 32)
        with TL.attn_overrides(kv_block=4), pytest.raises(NotImplementedError):
            TL.prefill_attention(q, k, k)


# ---------------------------------------------------------------------------
# held against the port's own runs
# ---------------------------------------------------------------------------

def test_dense_prefill_flops_are_its_products():
    """A reduced smollm prefill on the plain path (one KV block): every
    product counted once, 2·m·n·k each, nothing else."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = TB.get_config("smollm-135m").reduced()
    b, s = 2, 16
    counter = D.Counter()
    with FakeTensorMode(), counter:
        params = D._fake(TM.abstract_params(cfg))
        TM.prefill(params, {"tokens": torch.empty(b, s, dtype=torch.int32)},
                   cfg, max_seq=s, kv_block=s)
    t, d, h, hkv, hd, f = (b * s, cfg.d_model, cfg.num_heads,
                           cfg.num_kv_heads, cfg.head_dim, cfg.d_ff)
    layer = (2 * t * d * h * hd + 2 * 2 * t * d * hkv * hd    # q, k, v
             + 2 * 2 * b * h * s * s * hd                      # scores, p.v
             + 2 * t * h * hd * d                              # wo
             + 3 * 2 * t * d * f)                              # the MLP
    head = 2 * b * d * cfg.vocab_size                          # last position
    assert counter.flops == cfg.num_layers * layer + head
    assert counter.bytes > 0 and counter.peak > 0


CASES = [
    dict(name="dense_xfer", arch="smollm-135m", variant="xfer_chunked",
         mesh=(2, 1, 2)),
    dict(name="mla_xfer", arch="minicpm3-4b", variant="xfer_chunked",
         mesh=(2, 1, 2)),
    dict(name="moe_xfer", arch="qwen3-moe-30b-a3b", variant="xfer_chunked",
         mesh=(2, 1, 2)),
    dict(name="dense_base", arch="smollm-135m", variant="base",
         mesh=(1, 2, 2)),
]
for _c in CASES:
    _c.update(batch=4, prompt=12, max_seq=24, steps=1, seed=3)


def test_dry_run_predicts_gloo_ranks(tmp_path):
    torch_ranks.run_world(torch_ranks.dryrun_world, 4, tmp_path,
                          str(tmp_path), CASES, timeout=240)
    real = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(4)]
    compressed = set()
    for case in CASES:
        cfg = TB.get_config(case["arch"]).reduced()
        pred = D.predict(cfg, case["mesh"], case["variant"],
                         batch=case["batch"], prompt=case["prompt"],
                         max_seq=case["max_seq"], num_steps=case["steps"])
        for r, p in zip(real, pred):
            got, want = r[case["name"]], p.seen
            tag = (case["name"], p.rank)
            assert got["coord"] == p.coord, tag
            assert got["held"]["params"] == want["held"]["params"], tag
            assert got["held"]["cache"] == want["held"]["cache"], tag
            assert got["tp_fwd"] == want["tp_fwd"], tag
            assert got["model_calls"] == want["model_calls"], tag
            assert got["model_calls"] > 0, tag
            if "prefill_fwd" in want:
                assert got["prefill_fwd"] == want["prefill_fwd"], tag
            if "hop" in want:
                gh, wh = got["hop"], want["hop"]
                assert got["pod"] == want["pod"], tag
                assert gh["units"] == wh["units"] > 0, tag
                assert gh["side_bytes"] == wh["side_bytes"], tag
                assert gh["wire_bytes"] == sum(g[4] for g in gh["records"])
                for g, w in zip(gh["records"], wh["records"]):
                    if w[0] == CL.RAW:         # a leaf the plan routes raw
                        assert g == w, tag
                    elif g[0] == CL.COMP:      # within its capacity
                        assert g[4] <= w[4], (tag, g, w)
                        compressed.add(case["name"])
                    else:                      # overflowed: shipped raw
                        assert g[0] == CL.FALLBACK and w[0] == CL.COMP, tag
    # every hop world compressed some unit within its capacity
    assert compressed == {c["name"] for c in CASES if c["variant"] != "base"}


def test_production_meshes_on_fake_ranks_have_jax_shapes():
    code = textwrap.dedent("""
        import json
        from repro.launch.mesh import make_production_mesh as jmesh
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.mesh import make_production_mesh, mesh_shape
        out = []
        for multi, world in ((False, 256), (True, 512)):
            j = jmesh(multi_pod=multi)
            with fake_world(world, world - 1):
                m = make_production_mesh(multi_pod=multi)
                out.append([dict(j.shape), list(j.axis_names), mesh_shape(m),
                            list(m.mesh_dim_names), m.get_coordinate()])
        print(json.dumps(out))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    (js1, ja1, ts1, ta1, c1), (js2, ja2, ts2, ta2, c2) = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert js1 == ts1 == {"data": 16, "model": 16} and ja1 == ta1
    assert js2 == ts2 == {"pod": 2, "data": 16, "model": 16} and ja2 == ta2
    assert ta2 == ["pod", "data", "model"]
    assert c1 == [15, 15] and c2 == [1, 15, 15]


def test_check_transport_refuses_a_fake_group_outside_the_dry_run():
    with D.fake_world(4, 1):
        group = dist.group.WORLD
        with pytest.raises(NotImplementedError, match="gloo only"):
            CL.check_transport(group)
        with pytest.raises(NotImplementedError):
            CL.Link(group, "cpu", CL.CommStats())
        with AB.tracing():
            CL.check_transport(group)
    assert not dist.is_initialized()


def test_run_cell_records_a_cell_that_does_not_apply(monkeypatch, tmp_path):
    monkeypatch.setattr(D, "RESULTS_DIR", str(tmp_path))
    for arch, shape in (("hubert-xlarge", "decode_32k"),
                        ("qwen3-32b", "long_500k")):
        r = D.run_cell(arch, shape, False)
        _, why = JB.shape_applicable(JB.get_config(arch), JB.SHAPES[shape])
        assert r == {"cell": D._cell_id(arch, shape, False),
                     "status": "skipped", "reason": why,
                     "code": D.code_key()}
        assert (tmp_path / f"{r['cell']}.json").exists()


def test_run_cell_reads_back_only_a_record_of_the_same_code(monkeypatch,
                                                            tmp_path):
    """The cache is keyed on the package's source: a record that other code
    counted is recounted, one of this code is read back as it stands."""
    monkeypatch.setattr(D, "RESULTS_DIR", str(tmp_path))
    args = ("hubert-xlarge", "decode_32k", False)
    path = tmp_path / f"{D._cell_id(*args)}.json"
    stale = {"cell": D._cell_id(*args), "status": "ok", "code": "0" * 16}
    path.write_text(json.dumps(stale))
    r = D.run_cell(*args)
    assert r["status"] == "skipped" and r["code"] == D.code_key()
    same = dict(stale, code=D.code_key())
    path.write_text(json.dumps(same))
    assert D.run_cell(*args) == same
    assert D.run_cell(*args, cache=False)["status"] == "skipped"


def test_used_slot_helpers_select_the_slots_in_use_or_every_slot_when_fake():
    """The one place the dry run's figure "every escape slot in use" is
    decided: real tensors select by the mask, fake ones take every slot."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mask = torch.tensor([[True, False], [False, True]])
    (got,) = AB.used_slots(mask, torch.arange(4).reshape(2, 2))
    assert got.tolist() == [0, 3]
    dst = torch.zeros(2, 2, dtype=torch.int64)
    AB.fill_used_slots(dst, mask, torch.tensor([7, 8]))
    assert dst.tolist() == [[7, 0], [0, 8]]
    assert AB.n_used_slots(torch.tensor([1, 2]), 99) == 3
    with AB.tracing(), FakeTensorMode():
        fmask = torch.zeros(2, 2, dtype=torch.bool)
        (got,) = AB.used_slots(fmask, torch.empty(2, 2, dtype=torch.int64))
        assert tuple(got.shape) == (4,)
        fdst = torch.empty(2, 2)
        AB.fill_used_slots(fdst, fmask, torch.empty(4))
        assert AB.n_used_slots(torch.empty(2, dtype=torch.int32), 99) == 99


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_fsdp_serving_cells_play(kind):
    """An ``fsdp`` serving cell plays on (1, 2, 2): the rank holds the
    ``fsdp`` spec arithmetic's parameter bytes, and its ``all-gather``
    bytes are the ``base`` cell's (the ``model`` axis's) plus one pass of
    the gathered layers' and top-level leaves' blocks (a prefill's reads
    ``embed``, a decode step's too: ``torch_ranks.fsdp_gathers``), in one
    all-gather a layer and a read; no group is left initialised."""
    arch = "smollm-135m"
    cfg = TB.get_config(arch).reduced()
    shape = TB.ShapeConfig("s", 16, 4, kind)
    mesh, axes = (1, 2, 2), ("pod", "data", "model")
    base = D.play(cfg, shape, mesh, axes, 0, "base")
    got = D.play(cfg, shape, mesh, axes, 0, "fsdp")
    assert not dist.is_initialized()
    sizes = dict(zip(axes, mesh))
    pol = TSH.ShardingPolicy(sizes, fsdp=True)
    like = TM.abstract_params(cfg)
    assert got.seen["held"]["params"] == TSH.held_bytes(
        like, pol.param_specs(like), sizes) < base.seen["held"]["params"]
    nbytes, calls = torch_ranks.fsdp_gathers(arch, mesh)[
        "prefill" if kind == "prefill" else "step"]
    assert got.seen["gather"] == {"bytes": nbytes, "recv_bytes": nbytes,
                                  "calls": calls} and calls == 4
    assert base.seen["gather"] == {"bytes": 0, "recv_bytes": 0, "calls": 0}
    assert got.collectives["all-gather"] == \
        base.collectives["all-gather"] + nbytes
    assert got.seen["tp_fwd"] == base.seen["tp_fwd"]


def test_wrappers_launch_or_run_plain_outside_the_abstract_form():
    """Real CPU tensors take the plain version even inside a card run: the
    abstract forms act on fake tensors only."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import splitzip_encode as E
    bits = torch.zeros((2, 1024), dtype=torch.int16).view(torch.uint16)
    exps = tuple(range(120, 135))
    with AB.tracing(card=True) as run:
        got = E.encode_fused(bits, exps)
        q = torch.zeros((1, 4, 2, 16), dtype=torch.bfloat16)
        FA.flash_attention(q, q, q)
    assert run.kernels == {}
    want = E.encode_fused_plain(bits, exps)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
