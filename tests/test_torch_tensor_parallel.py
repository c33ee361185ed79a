"""The port's tensor-parallel train step across gloo ranks against the JAX
unsharded step, on the CPU.

The JAX step under a ``ShardingPolicy`` does not run on jax 0.9
(``with_sharding_constraint`` rejects Explicit axes; ROADMAP queue 3), and
GSPMD's contract is that sharding does not change the function, so the
port's step on a mesh with a ``model`` axis (``make_train_step(policy=)``,
``distributed/tensor_parallel.py``) is held against
``jax.jit(make_train_step(cfg))`` without a policy, on the same initial
state (the JAX seeded init, bitwise) and the same numpy global batches:
two steps of batch 8 x 16 (the vision config: 8 patches + 16 tokens).
The cases, one per attention case and layout:

* reduced smollm-135m at (pod 1, data 1, model 2): 4 / 2 heads split
  (case ``heads``); reduced minicpm3-4b (MLA) and the front ends, reduced
  pixtral-12b (patches through a column-split ``frontend_proj``) and
  hubert-xlarge (frames, not causal), at (1, 1, 2);
* reduced smollm at (1, 1, 4): 4 query heads split, 2 KV heads not
  (case ``kv``);
* a reduced dense config with 6 / 3 heads and tied embeddings at
  (1, 1, 4): heads do not split, so the ``seq`` fallback, and with
  ``attn_fallback="none"`` the replicated attention; reduced minicpm3
  with 6 heads and tied embeddings at (1, 1, 4), MLA's ``seq`` fallback;
* reduced llama3.2-3b at (1, 2, 2), FSDP on and off (the gathered states
  bitwise equal), with a placed checkpoint restored into (1, 4, 1) and
  loaded by the JAX ``Checkpointer``;
* reduced smollm at (2, 1, 2) with ``grad_compress`` (pods through the
  compressed ring);
* reduced mamba2-2.7b at (1, 1, 2), where ``in_proj`` (K 560) and
  ``out_proj`` (d_inner 256) both split, and with ``ssm.head_dim`` 128
  (2 heads, K 546) at (1, 1, 4), where ``in_proj`` does not split and
  ``out_proj`` does;
* reduced recurrentgemma-9b at 5 layers (one triple and 2 extra
  recurrent blocks) at (1, 1, 2): the LRU width split, the local
  attention's 4 query heads over 1 KV head in case ``kv`` with its window
  8 inside the 16 positions; and at (1, 2, 2) with FSDP on and off (the
  gathered states bitwise equal), the run without FSDP donating its state
  to the step (``make_train_step(donate=True)``: updated in place, the
  same bits).

Bounds, those of ``tests/test_torch_train.py`` for its train steps, and
why: a rank's products are the whole products' columns or rows, but the
row-split sums are f32 sums of f32 parts rounded once, the seq fallback
blocks the keys at other boundaries, and the vocab-parallel log-softmax
sums its exponentials in rank order, where JAX rounds bf16 at its own
places.  Loss within ``CE_ATOL`` = 2e-3, grad norm rtol 5e-3, each
parameter leaf within a relative L2 norm of 5e-3, the moments within
``GRAD_RTOL`` = 5e-2, lr exact.  The recurrent families carry the
exception of
``tests/test_torch_train.py::test_mamba2_steps_match_jax_but_sign_flips``,
which the unsharded port needs as much: AdamW's first update is about
lr times the gradient's sign, so where round-off flips that sign the two
packages move 2 lr apart.  A leaf initialised to 0 (``conv_b``, Mamba-2's
``dt_bias``, the RG-LRU's ``b_a`` and ``b_x``) is after two steps its
updates alone, so one flip moves its relative L2 by about 2 / sqrt(n)
(the single-process port lands 0.08-0.16 from JAX on reduced Mamba-2's
``conv_b`` and 0.11-0.27 on the hybrid's; seen here).  At this batch the
flipped elements (more than one update from JAX's) have first gradients
of up to 0.82% of their leaf's largest, above the one bf16 ulp of the
train test (0.39-0.78%).  So where JAX's first gradient (its first
moment after one step) exceeds ``ZERO_GRAD_FRAC`` = 2% of the leaf's
largest, such a leaf's elements are held within ``PARAM_RTOL`` as a
relative L2 (seen at most 4.8e-3, the hybrid's ``b_a`` at (1, 2, 2);
one flip there would read about 0.1), and below it each element within
the two updates' distance (2 lr summed over the steps) plus one
rounding.  One rounding elementwise does not hold above any threshold
up to 5%: the second update follows gradients a few percent apart, and
moves elements up to 3.4% of the two steps' lr past it.  Every moment
leaf is held against JAX within ``GRAD_RTOL``, except these, whose
reading there is over the bound and which are held within
``GRAD_RTOL`` of the port's single-process step instead
(``MOMENT_WITNESS``; relative L2 against JAX for the split and the
single process, then the split against the single process): Mamba-2's
``D`` gradient differs by about 5% from JAX's, which the moments carry
(``v`` 4.8e-2 / 5.1e-2 / 8.0e-3 at (1, 1, 2); with head_dim 128 ``m``
0.11 / 0.11 / 1.8e-2 and ``v`` 6.1e-2 / 5.6e-2 / 8.9e-3); and the
hybrid's extra blocks' ``v`` of ``lam`` at (1, 2, 2) reads 5.01e-2 /
3.7e-2 / 4.6e-2: the hybrid's moments scatter 2-5% between any two of
the three runs after a first step with flipped elements, and the
data axis's half-batch sums move its step-1 gradients by 0.3%.

Held exactly: every rank gathers the same state; each rank holds the
bytes its specs give; after two steps every leaf replicated over
``model`` is bitwise the same on the ranks of one (pod, data) coordinate
(their gradients are whole on every model rank, or summed over ``model``
in rank order: exactly the partial attention leaves and, in the hybrid,
the RG-LRU's per-channel leaves a rank slices); no parameter is gathered
over ``model`` (the step's
parameter-gather bytes are exactly those of the ``data`` gathers of the
rank's model shards, 0 without FSDP); a TP-placed checkpoint restores
into another mesh and into the JAX state bitwise; ``launch/train.py
--mesh 1,1,2`` prints the single-process launcher's losses within
``CE_ATOL`` (smollm and mamba2).
"""

import concurrent.futures
import functools
import json
import re

import pytest

jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_ranks  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.distributed import checkpoint as JCK  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.distributed.sharding import ShardingPolicy  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models.weights import train_state_from_jax  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402

CE_ATOL, GRAD_RTOL, PARAM_RTOL = 2e-3, 5e-2, 5e-3
OPT = dict(lr=3e-4, total_steps=2, warmup_steps=1)
BATCH, SEQ, STEPS, KV_BLOCK = 8, 16, 2, 16
# the configs' overrides of the reduced ones, by the suffix of their
# reference's name
OVERRIDES = {"six": {"num_heads": 6, "num_kv_heads": 3, "tie_embeddings": True},
             "h128": {"ssm": {"head_dim": 128}},
             "five": {"num_layers": 5}}


def _case(name, arch, shape, over=None, fsdp=False, grad_compress=False,
          attn_fallback="seq", ckpt=False, donate=False):
    return dict(name=name, arch=arch, over=OVERRIDES.get(over, {}),
                shape=list(shape), fsdp=fsdp, grad_compress=grad_compress,
                attn_fallback=attn_fallback, ckpt=ckpt, donate=donate,
                ref=arch if over is None else f"{arch}-{over}")


# world size -> its cases, each with the attention case it must take (None:
# no attention)
WORLDS = {
    2: [(_case("smollm-112", "smollm-135m", (1, 1, 2)), "heads"),
        (_case("minicpm3-112", "minicpm3-4b", (1, 1, 2)), "heads"),
        (_case("pixtral-112", "pixtral-12b", (1, 1, 2)), "heads"),
        (_case("hubert-112", "hubert-xlarge", (1, 1, 2)), "heads"),
        (_case("mamba2-112", "mamba2-2.7b", (1, 1, 2)), None),
        (_case("rgemma5-112", "recurrentgemma-9b", (1, 1, 2), "five"), "kv")],
    4: [(_case("smollm-114", "smollm-135m", (1, 1, 4)), "kv"),
        (_case("six-114-seq", "smollm-135m", (1, 1, 4), "six"), "seq"),
        (_case("six-114-none", "smollm-135m", (1, 1, 4), "six",
               attn_fallback="none"), "none"),
        (_case("minicpm3-six-114-seq", "minicpm3-4b", (1, 1, 4), "six"),
         "seq"),
        (_case("llama-122-fsdp", "llama3.2-3b", (1, 2, 2), fsdp=True,
               ckpt=True), "heads"),
        (_case("llama-122", "llama3.2-3b", (1, 2, 2)), "heads"),
        (_case("smollm-212-ring", "smollm-135m", (2, 1, 2),
               grad_compress=True), "heads"),
        (_case("mamba2-h128-114", "mamba2-2.7b", (1, 1, 4), "h128"), None),
        (_case("rgemma5-122-fsdp", "recurrentgemma-9b", (1, 2, 2), "five",
               fsdp=True), "kv"),
        (_case("rgemma5-122", "recurrentgemma-9b", (1, 2, 2), "five",
               donate=True), "kv")],
}
CASES = {c["name"]: (world, c, want) for world, cs in WORLDS.items()
         for c, want in cs}
REFS = {c["ref"]: (c["arch"], c["over"]) for _, c, _ in CASES.values()}
RECURRENT = [n for n, (_, c, _) in CASES.items()
             if c["arch"] in ("mamba2-2.7b", "recurrentgemma-9b")]
# a zero-initialised leaf's elements held as a leaf: JAX's first gradient
# above this share of the leaf's largest (module docstring)
ZERO_GRAD_FRAC = 2e-2
# the moment leaves held against the port's single-process step, not JAX's
# (module docstring), by case
_D = "['layers']['mixer']['D']"
_LAM = ".opt.v['extra']['block']['lam']"
MOMENT_WITNESS = {"mamba2-112": {".opt.v" + _D},
                  "mamba2-h128-114": {".opt.m" + _D, ".opt.v" + _D},
                  "rgemma5-122-fsdp": {_LAM}, "rgemma5-122": {_LAM}}
WITNESS_REFS = {CASES[n][1]["ref"] for n in MOMENT_WITNESS}
LAUNCH_STEPS = 2
LAUNCH_ARCHS = ("smollm-135m", "mamba2-2.7b")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view({1: np.int8, 2: np.int16, 4: np.int32}[x.dtype.itemsize])


def _f32(bits: np.ndarray, like) -> np.ndarray:
    if like.dtype == jax.numpy.bfloat16:
        return (bits.astype(np.int32) << 16).view(np.float32)
    return bits.view(np.asarray(like).dtype).astype(np.float32)


def _np_batch(cfg, rng):
    """A numpy global batch with the JAX stream's keys and shapes (f32
    front-end inputs, cast to bf16 by each package)."""
    def ids(n):
        return rng.integers(0, cfg.vocab_size, (BATCH, n)).astype(np.int32)

    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal(
            (BATCH, SEQ, cfg.frontend_dim)).astype(np.float32),
            "labels": ids(SEQ)}
    out = {"tokens": ids(SEQ), "labels": ids(SEQ)}
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.standard_normal(
            (BATCH, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return out


def _jax_config(ref):
    arch, over = REFS[ref]
    return torch_ranks.with_overrides(jget(arch).reduced(), over)


def _port_config(ref):
    arch, over = REFS[ref]
    return torch_ranks.with_overrides(tget(arch).reduced(), over)


@functools.lru_cache(maxsize=None)
def jax_inputs(ref):
    """The JAX seeded initial state and the numpy global batches of the
    reference ``ref`` (an arch id, with a suffix of ``OVERRIDES`` for an
    overridden config), and the arrays the ranks load."""
    jc = _jax_config(ref)
    state = JTS.init_state(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    batches = [_np_batch(jc, rng) for _ in range(STEPS)]
    arrays = {f"batch{i}/{k}": v for i, b in enumerate(batches)
              for k, v in b.items()}
    for p, x in jax.tree_util.tree_flatten_with_path(state)[0]:
        arrays["state/" + jax.tree_util.keystr(p)] = np.asarray(x).view(np.uint16) \
            if x.dtype == jax.numpy.bfloat16 else np.asarray(x)
    return state, batches, arrays


@functools.lru_cache(maxsize=None)
def jax_ref(ref):
    """The JAX unsharded step's state and metrics after ``STEPS`` steps, and
    its first moment after the first step (each leaf as f32, keyed by its
    parameter's path in the state: ``(1 - b1)`` times the clipped first
    gradient)."""
    state, batches, _ = jax_inputs(ref)
    step = jax.jit(JTS.make_train_step(_jax_config(ref), JO.AdamWConfig(**OPT),
                                       None, kv_block=KV_BLOCK))
    s, metrics = state, []
    for b in batches:
        s, m = step(s, {k: jax.numpy.asarray(v, jax.numpy.bfloat16)
                        if v.dtype == np.float32 else jax.numpy.asarray(v)
                        for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if len(metrics) == 1:
            first = {".params" + jax.tree_util.keystr(p): np.asarray(x, np.float32)
                     for p, x in jax.tree_util.tree_flatten_with_path(s.opt.m)[0]}
    return s, metrics, first


def zero_init(ref):
    """The recurrent families' parameter leaves initialised to 0, by their
    path in the state (module docstring); empty for the others."""
    jc = _jax_config(ref)
    if jc.ssm is None and jc.hybrid is None:
        return set()
    flat = jax.tree_util.tree_flatten_with_path(jax_inputs(ref)[0].params)[0]
    return {".params" + jax.tree_util.keystr(p) for p, x in flat
            if not np.any(np.asarray(x, np.float32))}


@functools.lru_cache(maxsize=None)
def port_ref(ref):
    """The port's single-process step's state after ``STEPS`` steps from
    the same initial state and batches: each leaf as f32, keyed by its
    path in the JAX state."""
    state, batches, _ = jax_inputs(ref)
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    s = train_state_from_jax(jax.tree.map(np.asarray, state))
    step = TTS.make_train_step(_port_config(ref), TO.AdamWConfig(**OPT), None,
                               kv_block=KV_BLOCK)
    for b in batches:
        s, _ = step(s, {k: torch.from_numpy(v) for k, v in b.items()})
    return {jax.tree_util.keystr(p): x.float().numpy()
            for (p, _), x in zip(flat, TR.leaves(s))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world run once for the module: ``world -> (ranks, rank 0's
    arrays, out dir)``.  The JAX steps run in a thread meanwhile."""
    cache = {}

    def run(world):
        if world not in cache:
            tmp = tmp_path_factory.mktemp(f"tp{world}")
            ref = tmp / "ref"
            ref.mkdir()
            names = sorted({c["ref"] for c, _ in WORLDS[world]})
            for name in names:
                np.savez(ref / f"{name}.npz", **jax_inputs(name)[2])
                (ref / f"{name}.json").write_text(json.dumps(
                    {"opt": OPT, "steps": STEPS, "kv_block": KV_BLOCK}))
            out = tmp / "ranks"
            out.mkdir()
            launch = LAUNCH_STEPS if world == 2 else 0
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                refs = pool.submit(lambda: [
                    (jax_ref(n), port_ref(n) if n in WITNESS_REFS else None)
                    for n in names])
                torch_ranks.run_world(torch_ranks.tp_train_world, world, tmp,
                                      str(ref), str(out),
                                      [c for c, _ in WORLDS[world]], launch,
                                      LAUNCH_ARCHS, timeout=300)
                refs.result()
            ranks = [json.loads((out / f"rank{r}.json").read_text())
                     for r in range(world)]
            cache[world] = ranks, np.load(out / "rank0.npz"), out
        return cache[world]
    return run


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_jax_unsharded(worlds, name):
    world, case, want = CASES[name]
    ranks, got, _ = worlds(world)
    final, jmetrics, first = jax_ref(case["ref"])
    lrs = sum(m["lr"] for m in jmetrics)
    zero = zero_init(case["ref"])
    runs = [r[name] for r in ranks]
    assert {r["case"] for r in runs} == {want}
    assert len({r["sha"] for r in runs}) == 1
    for r in runs:
        for tm, jm in zip(r["metrics"], jmetrics):
            assert abs(tm["loss"] - jm["loss"]) <= CE_ATOL
            assert abs(tm["ce"] - jm["ce"]) <= CE_ATOL
            np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                       rtol=5e-3)
            assert tm["lr"] == jm["lr"]
    for p, x in jax.tree_util.tree_flatten_with_path(final)[0]:
        k = jax.tree_util.keystr(p)
        if k == ".opt.step":
            assert int(got[f"{name}/{k}"]) == STEPS
            continue
        bound = PARAM_RTOL if k.startswith(".params") else GRAD_RTOL
        a, b = np.asarray(x, np.float32), _f32(got[f"{name}/{k}"], x)
        if k in zero:
            # its updates alone: held as a leaf where JAX's first gradient
            # stands above round-off; below it the sign may flip, so at
            # most the two updates' distance apart, plus one rounding
            g = np.abs(first[k])
            above = g > ZERO_GRAD_FRAC * g.max()
            assert rel(a[above], b[above]) <= PARAM_RTOL, (k,)
            assert np.all((np.abs(a - b) <= 2 * lrs + 2 ** -7 * np.maximum(
                np.abs(a), np.abs(b)))[~above]), (k,)
            continue
        if k in MOMENT_WITNESS.get(name, ()):
            a = port_ref(case["ref"])[k]
        assert rel(a, b) <= bound, (k,)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_placement_replicas_and_no_model_gathers(worlds, name):
    world, case, _ = CASES[name]
    runs = [r[name] for r in worlds(world)[0]]
    by_coord = {}
    for r in runs:
        assert r["held"] == r["spec_bytes"]
        assert r["split_over_model"] > 0
        # parameters cross the model group never: only data gathers
        assert r["comm"]["gather"] == r["data_gather_bytes"]
        assert (r["data_gather_bytes"] > 0) == case["fsdp"]
        assert r["comm"]["tp_fwd"] > 0 and r["comm"]["tp_bwd"] > 0
        c = r["coord"]
        by_coord.setdefault((c["pod"], c["data"]), set()).add(r["replicated_sha"])
    assert all(len(s) == 1 for s in by_coord.values()), by_coord


def test_tp_fsdp_on_and_off_bitwise(worlds):
    runs = worlds(4)[0]
    assert {r["llama-122-fsdp"]["sha"] for r in runs} == \
        {r["llama-122"]["sha"] for r in runs}
    for r in runs:
        assert r["llama-122-fsdp"]["held"] < r["llama-122"]["held"]


def test_tp_checkpoint_restores_into_another_mesh_and_jax(worlds):
    ranks, got, out = worlds(4)
    for r in ranks:
        back = r["llama-122-fsdp"]["restored"]
        assert back["step"] == STEPS and back["extra"] == {
            "arch": tget("llama3.2-3b").reduced().name}
        assert back["sha"] == r["llama-122-fsdp"]["sha"]
        assert back["held"] == back["spec_bytes"]
    final, _, _ = jax_ref("llama3.2-3b")
    jback, _, jstep = JCK.Checkpointer(
        str(out / "llama-122-fsdp" / "ckpt")).restore(final)
    assert jstep == STEPS
    for p, x in jax.tree_util.tree_flatten_with_path(jback)[0]:
        assert np.array_equal(
            _bits(x), got["llama-122-fsdp/" + jax.tree_util.keystr(p)]), p


def _losses(text: str):
    return [float(v) for v in re.findall(r"loss (\S+)", text)]


def test_launcher_model_axis_matches_single_process(worlds, capsys):
    out = worlds(2)[2]
    lead, other = ((out / f"launch{r}.txt").read_text() for r in range(2))
    assert f"done: {LAUNCH_STEPS} steps" in lead and other == ""
    LT.main(["--arch", "smollm-135m", "--reduced", "--batch", "4", "--seq",
             "16", "--device", "cpu", "--steps", str(LAUNCH_STEPS)])
    single = _losses(capsys.readouterr().out)
    tp = _losses(lead)
    assert len(tp) == len(single) == LAUNCH_STEPS
    assert max(abs(a - b) for a, b in zip(tp, single)) <= CE_ATOL


@pytest.mark.parametrize("arch", ["smollm-135m", "minicpm3-4b",
                                  "pixtral-12b", "hubert-xlarge",
                                  "mamba2-2.7b", "recurrentgemma-9b"])
def test_dense_mla_and_frontends_accept_model_axis(arch):
    TTS.make_train_step(tget(arch).reduced(), policy=ShardingPolicy(
        {"pod": 2, "data": 2, "model": 4}, fsdp=True), grad_compress=True)


@pytest.mark.parametrize("name", RECURRENT)
def test_tp_recurrent_partial_leaves(worlds, name):
    """The leaves summed over ``model``: none of Mamba-2's (its replicated
    leaves get whole gradients); in the hybrid the local attention's
    ``wk`` / ``wv`` (case ``kv``) and the recurrent blocks' sliced
    per-channel leaves."""
    world, case, _ = CASES[name]
    want = set()
    if case["arch"] == "recurrentgemma-9b":
        want = {f"triples/attn/block/{w}" for w in ("wk", "wv")} | {
            f"{stack}/block/{leaf}" for stack in ("triples/rec", "extra")
            for leaf in ("conv_w", "conv_b", "b_a", "b_x", "lam")}
    for r in worlds(world)[0]:
        assert set(r[name]["partial"]) == want


def test_tp_hybrid_fsdp_on_and_off_bitwise(worlds):
    runs = worlds(4)[0]
    assert {r["rgemma5-122-fsdp"]["sha"] for r in runs} == \
        {r["rgemma5-122"]["sha"] for r in runs}
    for r in runs:
        assert r["rgemma5-122-fsdp"]["held"] < r["rgemma5-122"]["held"]


def test_launcher_mamba2_model_axis_matches_single_process(worlds, capsys):
    out = worlds(2)[2]
    lead, other = ((out / torch_ranks.launch_name("mamba2-2.7b", r)).read_text()
                   for r in range(2))
    assert f"done: {LAUNCH_STEPS} steps" in lead and other == ""
    LT.main(["--arch", "mamba2-2.7b", "--reduced", "--batch", "4", "--seq",
             "16", "--device", "cpu", "--steps", str(LAUNCH_STEPS)])
    single = _losses(capsys.readouterr().out)
    tp = _losses(lead)
    assert len(tp) == len(single) == LAUNCH_STEPS
    assert max(abs(a - b) for a, b in zip(tp, single)) <= CE_ATOL
