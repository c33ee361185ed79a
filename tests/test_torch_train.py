"""The port's training plane against the JAX package's, on the CPU.

Both packages get the same parameters (the JAX package's seeded init,
handed over as numpy through ``params_from_jax`` / ``train_state_from_jax``,
bitwise) and the same numpy batches.  Reduced configs, batch 2 x 16 for the
loss of each family, 4 x 32 for the train steps.

Tolerances, and why:

* ``loss_fn``: bf16 rounds at other places in XLA and PyTorch (see
  ``test_torch_model.py``), so the cross-entropy agrees within
  ``CE_ATOL`` = 2e-3 (seen: at most 3e-4 over the seven families).  The
  MoE balance loss counts each token's top-1 expert: a near-tied top-1
  that bf16 round-off flips moves it by about E |dp| / T, so ``aux``
  agrees within rtol ``AUX_RTOL`` = 2e-2 (seen: 1.0e-2 on qwen3-moe, as in
  the forward of ``test_torch_moe.py``).  Each gradient leaf agrees
  within a relative L2 norm of ``GRAD_RTOL`` = 5e-2 (seen: at most 2.7e-2,
  the hybrid's recurrent blocks; a wrong mask, rotation or scatter moves a
  leaf by O(1)).  ``remat`` on and off give bitwise the same gradients:
  the recomputed forward is the same arithmetic.
* ``OPT.update`` on the same gradients: the global norm sums in another
  order (rtol 1e-5; seen 1.7e-6); ``lr`` is exact; m, v and the parameters
  within one bf16 ulp of the clipped gradient (rtol 2**-7; seen bitwise).
* Three train steps against ``jax.jit(make_train_step(...))``: loss within
  ``CE_ATOL``, grad norm rtol 5e-3 (seen 1.3e-3), lr exact, each parameter
  leaf within a relative L2 norm of 5e-3 (seen 1.8e-3: an element whose
  first AdamW update, about lr times the gradient's sign, goes the other
  way or rounds to the other bf16 neighbour), the moments within
  ``GRAD_RTOL``.
* Two train steps at reduced mamba2-2.7b: gradients within
  ``GRAD_RTOL`` at each step (seen 4.8e-2, the SSM's ``D``), loss, grad
  norm and lr as above, and each parameter leaf within 5e-3 except at
  the elements whose JAX gradient at some step was within one bf16 ulp of
  0 (the ulp at the leaf's largest |gradient|).  AdamW's first update is
  about lr times the gradient's sign, so where bf16 round-off can flip
  that sign the two packages move 2 lr apart: the zero-initialised
  ``conv_b`` lands at a relative L2 of 0.20 on six such elements.  At
  those elements the parameters are held within the two updates' distance
  (2 lr summed over the steps) plus one rounding.  The moments are not
  held: ``D``'s gradient at 4.8e-2 squares to about twice that in ``v``.
* The 2-rank ``grad_compress`` step against the JAX pieces (a subprocess
  on 2 host devices: ``vmap(value_and_grad(loss_fn))`` over the pod-split
  batch, ``compressed_cross_pod_mean`` with the ring program jitted, then
  ``OPT.update``; the JAX step under a ``ShardingPolicy`` fails on this
  jax, ROADMAP queue 3): each rank's averaged gradients are bitwise the f32
  mean of the two half-batch gradients the port computes in one process,
  cast to bf16, and the two ranks' parameters are bitwise equal; against
  JAX the same bounds as the train steps.  The step hands the ring its
  own gradients (``compressed_cross_pod_mean_own``); each rank's result
  and ``TransferStats`` equal, bitwise, those of the JAX-shaped entry on
  a stacked tree holding its row.

The data stream is a deliberate difference (ROADMAP queue 3): the port
draws from numpy generators seeded by ``(seed, step)``, not threefry, so
only its keys, shapes, dtypes and ranges are held to JAX's.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
from typing import NamedTuple

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_ranks  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.plan import leaf_key as jleaf_key  # noqa: E402
from repro.training import data as JD  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models.weights import params_from_jax, train_state_from_jax  # noqa: E402
from repro_torch.training import data as TD  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402

CE_ATOL, AUX_RTOL, GRAD_RTOL = 2e-3, 2e-2, 5e-2
FAMILIES = ("smollm-135m", "minicpm3-4b", "qwen3-moe-30b-a3b", "mamba2-2.7b",
            "recurrentgemma-9b", "pixtral-12b", "hubert-xlarge")


def np_batch(cfg, b, s, seed):
    """A numpy batch with the JAX stream's keys, shapes and dtypes (f32
    for the frontend inputs, cast to bf16 by each package)."""
    rng = np.random.default_rng(seed)

    def ids(n):
        return rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)

    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32),
                "labels": ids(s)}
    out = {"tokens": ids(s), "labels": ids(s)}
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return out


def jax_batch(nb):
    return {k: jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32 else jnp.asarray(v)
            for k, v in nb.items()}


def torch_batch(nb):
    return {k: torch.from_numpy(v).to(torch.bfloat16) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in nb.items()}


def f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def rel(a, b) -> float:
    a, b = f32(a), f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def assert_trees_close(jtree, ttree, rtol, what):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = TR.flatten_with_path(ttree)[0]
    assert [jleaf_key(p) for p, _ in jl] == [TR.leaf_key(p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), jleaf_key(p)
        assert rel(a, b) <= rtol, (what, jleaf_key(p), rel(a, b))


# ---------------------------------------------------------------------------
# core/tree.py: NamedTuple nodes
# ---------------------------------------------------------------------------

class Inner(NamedTuple):
    a: object
    z: object


class Outer(NamedTuple):
    w: object
    inner: object


def _np_state():
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(size=(3, 2)).astype(np.float32),
         "b": rng.normal(size=(2,)).astype(np.float32)}
    return p, np.int32(4)


def test_namedtuple_leaf_keys_equal_jax():
    p, step = _np_state()
    jstate = JTS.TrainState(params=p, opt=JO.AdamWState(step=step, m=p, v=p))
    tstate = TTS.TrainState(params=p, opt=TO.AdamWState(step=step, m=p, v=p))
    jkeys = [jleaf_key(k) for k, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    tkeys = [TR.leaf_key(k) for k, _ in TR.flatten_with_path(tstate)[0]]
    assert tkeys == jkeys
    assert tkeys[:3] == [".params/b", ".params/w", ".opt/.step"]
    nested = Outer(w=[p["w"], (p["b"], {"k": p["w"]})], inner=Inner(a=p, z=step))
    assert [TR.leaf_key(k) for k, _ in TR.flatten_with_path(nested)[0]] == [
        jleaf_key(k) for k, _ in jax.tree_util.tree_flatten_with_path(nested)[0]]


def test_namedtuple_type_survives_unflatten():
    p, step = _np_state()
    state = TTS.TrainState(params=p, opt=TO.AdamWState(step=step, m=p, v=p))
    flat, treedef = TR.flatten_with_path(state)
    back = TR.unflatten(treedef, [x for _, x in flat])
    assert type(back) is TTS.TrainState and type(back.opt) is TO.AdamWState
    assert back.opt.step is step and back.params["w"] is p["w"]
    nested = Outer(w=1, inner=Inner(a=[2, 3], z=(4,)))
    again = TR.unflatten(TR.flatten_with_path(nested)[1], TR.leaves(nested))
    assert again == nested and type(again.inner) is Inner
    assert type(again.inner.a) is list and type(again.inner.z) is tuple


def test_dict_list_tuple_keys_unchanged():
    tree = {"z": [1, (2, 3)], "a": {"y": 4, "b": (5,)}}
    assert [TR.leaf_key(k) for k, _ in TR.flatten_with_path(tree)[0]] == [
        "a/b/[0]", "a/y", "z/[0]", "z/[1]/[0]", "z/[1]/[1]"]
    assert [jleaf_key(k) for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]] == [
        "a/b/[0]", "a/y", "z/[0]", "z/[1]/[0]", "z/[1]/[1]"]
    back = TR.unflatten(TR.flatten_with_path(tree)[1], TR.leaves(tree))
    assert back == tree and type(back["z"][1]) is tuple


# ---------------------------------------------------------------------------
# loss_fn and its gradients, every family
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def family(arch):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    nb = np_batch(jc, 2, 16, seed=1)
    (jl, (jce, jaux)), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jax_batch(nb), jc, kv_block=8), has_aux=True))(jp)
    return tc, params_from_jax(jax.tree.map(np.asarray, jp)), nb, \
        (float(jl), float(jce), float(jaux)), jg


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    tc, tp, nb, (jl, jce, jaux), jg = family(arch)
    grads = {}
    for remat in (True, False):
        (tl, (tce, taux)), tg = TTS.value_and_grad(tp, torch_batch(nb), tc,
                                                   kv_block=8, remat=remat)
        assert abs(float(tce) - jce) <= CE_ATOL, (remat, float(tce), jce)
        np.testing.assert_allclose(float(taux), jaux, rtol=AUX_RTOL)
        assert abs(float(tl) - jl) <= CE_ATOL + 0.01 * AUX_RTOL * abs(jaux)
        assert_trees_close(jg, tg, GRAD_RTOL, "grad")
        for (_, g), (_, p) in zip(TR.flatten_with_path(tg)[0],
                                  TR.flatten_with_path(tp)[0]):
            assert g.dtype == p.dtype
        grads[remat] = tg
    for a, b in zip(TR.leaves(grads[True]), TR.leaves(grads[False])):
        assert torch.equal(a, b), "remat changed a gradient"


def test_vision_loss_scores_text_positions_only():
    tc, tp, nb, _, _ = family("pixtral-12b")
    from repro_torch.models import model as TM
    with torch.no_grad():
        logits, _, _ = TM.forward(tp, torch_batch(nb), tc, kv_block=8,
                                  attention=TM.L.chunked_attention)
        total, (ce, _) = TM.loss_fn(tp, torch_batch(nb), tc, kv_block=8)
    labels = torch.from_numpy(nb["labels"]).long()
    assert logits.shape[1] == tc.frontend_len + labels.shape[1]
    lp = torch.log_softmax(logits[:, tc.frontend_len:].float(), -1)
    want = -lp.gather(-1, labels[..., None]).mean()
    assert abs(float(ce) - float(want)) < 1e-6


def test_flash_attention_raises_under_grad():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k, v = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q, k, v)
    with torch.no_grad():
        assert FA.flash_attention(q, k, v).shape == (1, 8, 2, 16)
    assert FA.flash_attention(q.detach(), k, v).shape == (1, 8, 2, 16)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def test_update_matches_jax_across_warmup():
    jc = jget("smollm-135m").reduced()
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    jcfg = JO.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=8)
    tcfg = TO.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=8)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    js, ts = JO.init(jp), TO.init(tp)
    assert int(ts.step) == 0 and ts.step.dtype == torch.int32
    rng = np.random.default_rng(1)
    for k in range(6):
        # large (clipped) and small (unclipped) gradients in turns
        scale = 3.0 if k % 2 == 0 else 0.05
        jg = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape) * scale, jnp.float32).astype(p.dtype), jp)
        tg = params_from_jax(jax.tree.map(np.asarray, jg))
        jp, js, jm = JO.update(jcfg, jg, js, jp)
        tp, ts, tm = TO.update(tcfg, tg, ts, tp)
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5)
        assert int(ts.step) == int(js.step) == k + 1
        for jt, tt in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            for a, b in zip(jax.tree.leaves(jt), TR.leaves(tt)):
                assert b.dtype == (torch.bfloat16 if a.dtype == jnp.bfloat16
                                   else torch.float32)
                np.testing.assert_allclose(f32(b), f32(a), rtol=2 ** -7, atol=0)


def test_update_in_place_is_bitwise_and_holds_one_state():
    """``update(inplace=True)`` (a donated state) writes the bits the
    out-of-place update returns into the state's and the parameters'
    own tensors, across clipped and unclipped steps."""
    from repro_torch.models import model as TM
    tc = tget("smollm-135m").reduced()
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=8)
    p0 = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    a_p, a_s = p0, TO.init(p0)
    b_p = TR.unflatten(TR.flatten_with_path(p0)[1],
                       [x.clone() for x in TR.leaves(p0)])
    b_s = TO.init(b_p)
    own = [x.data_ptr() for x in TR.leaves(b_p) + TR.leaves(b_s.m)
           + TR.leaves(b_s.v)]
    rng = np.random.default_rng(1)
    for k in range(4):
        scale = 3.0 if k % 2 == 0 else 0.05
        g = TR.unflatten(TR.flatten_with_path(p0)[1], [
            torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)
                             * scale).to(x.dtype) for x in TR.leaves(p0)])
        a_p, a_s, am = TO.update(cfg, g, a_s, a_p)
        b_p, b_s, bm = TO.update(cfg, g, b_s, b_p, inplace=True)
        assert float(am["grad_norm"]) == float(bm["grad_norm"])
        for x, y in zip(TR.leaves((a_p, a_s)), TR.leaves((b_p, b_s))):
            assert np.array_equal(torch_ranks.as_bits(x), torch_ranks.as_bits(y))
    assert [x.data_ptr() for x in TR.leaves(b_p) + TR.leaves(b_s.m)
            + TR.leaves(b_s.v)] == own


@pytest.mark.parametrize("arch", FAMILIES)
def test_decay_mask_matches_jax(arch):
    jp = jax.eval_shape(lambda: JM.init_params(jget(arch).reduced(),
                                               jax.random.PRNGKey(0)))
    tp = TTS.init_state(tget(arch).reduced(), torch.Generator().manual_seed(0),
                        "meta").params
    jpaths = [p for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    tpaths = [p for p, _ in TR.flatten_with_path(tp)[0]]
    assert [jleaf_key(p) for p in jpaths] == [TR.leaf_key(p) for p in tpaths]
    assert [TO._decay_mask(p) for p in tpaths] == [JO._decay_mask(p) for p in jpaths]


def test_schedule_matches_jax():
    cfg = dict(lr=1e-3, warmup_steps=4, total_steps=20, min_lr_frac=0.1)
    for step in range(0, 24):
        j = JO.schedule(JO.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32))
        t = TO.schedule(TO.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        assert t.dtype == torch.float32
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def test_three_train_steps_match_jax():
    jc, tc = jget("smollm-135m").reduced(), tget("smollm-135m").reduced()
    jst = JTS.init_state(jc, jax.random.PRNGKey(0))
    tst = train_state_from_jax(jax.tree.map(np.asarray, jst))
    assert type(tst) is TTS.TrainState and type(tst.opt) is TO.AdamWState
    kw = dict(lr=3e-4, total_steps=3, warmup_steps=1)
    jstep = jax.jit(JTS.make_train_step(jc, JO.AdamWConfig(**kw), None, kv_block=32))
    tstep = TTS.make_train_step(tc, TO.AdamWConfig(**kw), None, kv_block=32)
    before = FA.flash_attention.launches
    for k in range(3):
        nb = np_batch(jc, 4, 32, seed=10 + k)
        jst, jm = jstep(jst, jax_batch(nb))
        tst, tm = tstep(tst, torch_batch(nb))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= CE_ATOL
        assert abs(float(tm["ce"]) - float(jm["ce"])) <= CE_ATOL
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=5e-3)
        assert float(tm["lr"]) == float(jm["lr"])
        assert int(tst.opt.step) == k + 1
        assert_trees_close(jst.params, tst.params, 5e-3, "params")
        assert_trees_close(jst.opt.m, tst.opt.m, GRAD_RTOL, "m")
        assert_trees_close(jst.opt.v, tst.opt.v, GRAD_RTOL, "v")
    assert FA.flash_attention.launches == before


def test_mamba2_steps_match_jax_but_sign_flips():
    """Two steps at reduced mamba2-2.7b (the module docstring's exception:
    parameters held off the elements whose JAX gradient was within one
    bf16 ulp of 0, where the update may take the other sign)."""
    jc, tc = jget("mamba2-2.7b").reduced(), tget("mamba2-2.7b").reduced()
    jst = JTS.init_state(jc, jax.random.PRNGKey(0))
    tst = train_state_from_jax(jax.tree.map(np.asarray, jst))
    kw = dict(lr=3e-4, total_steps=2, warmup_steps=1)
    jstep = jax.jit(JTS.make_train_step(jc, JO.AdamWConfig(**kw), None, kv_block=32))
    tstep = TTS.make_train_step(tc, TO.AdamWConfig(**kw), None, kv_block=32)
    jgrad = jax.jit(jax.grad(lambda p, b: JM.loss_fn(p, b, jc, kv_block=32)[0]))
    near, lrs, flipped = None, [], 0
    for k in range(2):
        nb = np_batch(jc, 4, 32, seed=10 + k)
        jg = jgrad(jst.params, jax_batch(nb))
        _, tg = TTS.value_and_grad(tst.params, torch_batch(nb), tc, kv_block=32)
        assert_trees_close(jg, tg, GRAD_RTOL, "grad")
        zero = [np.abs(g) <= _bf16_ulp(np.abs(g).max()) for g in map(f32, jax.tree.leaves(jg))]
        near = zero if near is None else [a | b for a, b in zip(near, zero)]
        jst, jm = jstep(jst, jax_batch(nb))
        tst, tm = tstep(tst, torch_batch(nb))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= CE_ATOL
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=5e-3)
        assert float(tm["lr"]) == float(jm["lr"])
        lrs.append(float(jm["lr"]))
        for (p, a), b, m in zip(jax.tree_util.tree_flatten_with_path(jst.params)[0],
                                TR.leaves(tst.params), near):
            a, b = f32(a), f32(b)
            assert rel(a[~m], b[~m]) <= 5e-3, (jleaf_key(p), k)
            # where the sign may flip, at most the two updates' distance
            # apart, plus one rounding
            gap = np.abs(a - b)[m]
            assert np.all(gap <= 2 * sum(lrs) + 2 ** -7 * np.maximum(
                np.abs(a), np.abs(b))[m]), (jleaf_key(p), k)
            flipped += int(np.sum(gap > 2 ** -7 * np.abs(a)[m]))
    assert flipped > 0   # the exception is needed: conv_b starts at 0


def _bf16_ulp(x: float) -> float:
    """The bf16 spacing at ``x`` (0 for 0)."""
    return 0.0 if x == 0 else 2.0 ** (np.floor(np.log2(x)) - 7)


# ---------------------------------------------------------------------------
# the 2-rank grad_compress step against the JAX pieces
# ---------------------------------------------------------------------------

JAX_GC_SCRIPT = textwrap.dedent(r"""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_config
    from repro.launch.mesh import make_mesh
    from repro.models import model as M
    from repro.serving import session as JS
    from repro.training import grad_compress as GC
    from repro.training import optimizer as OPT
    from repro.training import train_step as TS

    _build = JS.TransferSession._build_ring_fn
    JS.TransferSession._build_ring_fn = lambda self, *a: jax.jit(_build(self, *a))
    out_dir = sys.argv[1]
    cfg = get_config("smollm-135m").reduced()
    mesh = make_mesh((2,), ("pod",))
    state = TS.init_state(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    split = jax.tree.map(lambda x: x.reshape(2, 2, *x.shape[1:]), batch)
    vg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: M.loss_fn(p, b, cfg, kv_block=32), has_aux=True),
        in_axes=(None, 0)))
    (totals, _), stacked = vg(state.params, split)
    grads = GC.compressed_cross_pod_mean(stacked, mesh)
    opt_cfg = OPT.AdamWConfig(lr=3e-4, total_steps=2, warmup_steps=1)
    params, opt, om = OPT.update(opt_cfg, grads, state.opt, state.params)
    def f(x):
        return np.asarray(x, np.float32)
    res = {"tokens": toks}
    for (p, x) in jax.tree_util.tree_flatten_with_path(state)[0]:
        res["state/" + jax.tree_util.keystr(p)] = np.asarray(x).view(np.uint16) \
            if x.dtype == jnp.bfloat16 else np.asarray(x)
    for (p, x) in jax.tree_util.tree_flatten_with_path(grads)[0]:
        res["grads/" + jax.tree_util.keystr(p)] = f(x)
    for (p, x) in jax.tree_util.tree_flatten_with_path(params)[0]:
        res["params/" + jax.tree_util.keystr(p)] = f(x)
    np.savez(os.path.join(out_dir, "gc.npz"), **res)
    meta = {"loss": float(jnp.mean(totals)), "pod_loss": [float(t) for t in totals],
            "grad_norm": float(om["grad_norm"]), "lr": float(om["lr"]),
            "leaf_ok": GC.last_stats.leaf_ok}
    with open(os.path.join(out_dir, "gc.json"), "w") as fh:
        json.dump(meta, fh)
    print("GC-JAX-OK")
""")


def _subprocess_env():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_grad_compress_step_two_ranks_against_jax(tmp_path):
    ref = tmp_path / "jax"
    ref.mkdir()
    out = subprocess.run([sys.executable, "-c", JAX_GC_SCRIPT, str(ref)],
                         capture_output=True, text=True, env=_subprocess_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res, meta = np.load(ref / "gc.npz"), json.loads((ref / "gc.json").read_text())
    ranks = tmp_path / "ranks"
    ranks.mkdir()
    torch_ranks.run_world(torch_ranks.train_world, 2, tmp_path, str(ref),
                          str(ranks), timeout=240)
    got = [json.loads((ranks / f"rank{r}.json").read_text()) for r in range(2)]
    assert got[0]["params_sha"] == got[1]["params_sha"], "ranks diverged"
    for g in got:
        assert g["mean_bitwise"] and g["grads_bf16"]
        assert g["own_matches_stacked"]
        assert abs(g["loss"] - meta["loss"]) <= CE_ATOL
        np.testing.assert_allclose(g["grad_norm"], meta["grad_norm"], rtol=5e-3)
        assert g["lr"] == meta["lr"]
        assert g["leaf_ok"] == meta["leaf_ok"] and any(g["leaf_ok"].values())
    tg = np.load(ranks / "rank0.npz")
    for k in res.files:
        if k.startswith(("grads/", "params/")):
            bound = GRAD_RTOL if k.startswith("grads/") else 5e-3
            assert rel(res[k], tg[k]) <= bound, (k, rel(res[k], tg[k]))


def test_own_row_ring_refusals_and_single_pod(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import grad_compress as GC
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s1",
                            rank=0, world_size=1)
    try:
        g = {"a": torch.arange(64, dtype=torch.float32).to(torch.bfloat16),
             "b": torch.ones(3, dtype=torch.float32)}
        data = make_mesh((1,), ("data",))
        assert GC.compressed_cross_pod_mean_own(g, data) is g   # no 'pod'
        pod = make_mesh((1,), ("pod",))
        out = GC.compressed_cross_pod_mean_own(g, pod)
        ref = GC.compressed_cross_pod_mean(
            {k: v[None] for k, v in g.items()}, pod)
        for k in g:
            assert out[k].dtype == g[k].dtype and torch.equal(out[k], ref[k])
        sess = next(iter(GC._SESSIONS.values()))
        with pytest.raises(ValueError, match="one participant's row"):
            sess.ring_reduce_own({"a": g["a"], "b": g["b"][:2]})
        with pytest.raises(ValueError, match="one participant's row"):
            sess.ring_reduce_own({"a": g["a"]})
    finally:
        GC._SESSIONS.clear()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the data stream (a deliberate difference: numpy generators, not threefry)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("smollm-135m", "pixtral-12b", "hubert-xlarge"))
def test_stream_keys_shapes_dtypes_match_jax(arch):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    seq = 24 + (jc.frontend_len if jc.frontend == "vision_patches" else 0)
    jb = JD.SyntheticTokenStream(jc, JShape("t", seq, 3, "train")).batch_at(2)
    stream = TD.SyntheticTokenStream(tc, TShape("t", seq, 3, "train"),
                                     device="cpu")
    tb = stream.batch_at(2)
    assert sorted(tb) == sorted(jb)
    for k in jb:
        assert tuple(tb[k].shape) == tuple(jb[k].shape), k
        want = torch.bfloat16 if jb[k].dtype == jnp.bfloat16 else torch.int32
        assert tb[k].dtype == want, k
    for k in ("tokens", "labels"):
        if k in tb:
            assert 0 <= int(tb[k].min()) and int(tb[k].max()) < tc.vocab_size
    if "tokens" in tb:
        assert torch.equal(tb["tokens"][:, 1:], tb["labels"][:, :-1])


def test_stream_is_pure_in_seed_and_step():
    tc = tget("smollm-135m").reduced()
    shape = TShape("t", 64, 4, "train")
    a = TD.SyntheticTokenStream(tc, shape, TD.DataConfig(seed=3), device="cpu")
    b = TD.SyntheticTokenStream(tc, shape, TD.DataConfig(seed=3), device="cpu")
    c = TD.SyntheticTokenStream(tc, shape, TD.DataConfig(seed=4), device="cpu")
    x5, x6 = a.batch_at(5), a.batch_at(6)
    assert torch.equal(b.batch_at(5)["tokens"], x5["tokens"])
    assert torch.equal(a.batch_at(5)["labels"], x5["labels"])
    assert not torch.equal(x6["tokens"], x5["tokens"])
    assert not torch.equal(c.batch_at(5)["tokens"], x5["tokens"])
    first = next(iter(a))
    assert torch.equal(first["tokens"], a.batch_at(0)["tokens"])
    # Zipf: the most frequent token is the first rank
    toks = torch.cat([a.batch_at(i)["tokens"].reshape(-1) for i in range(4)])
    assert int(torch.bincount(toks).argmax()) == 0


def test_stream_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.SyntheticTokenStream(tget("smollm-135m").reduced(),
                                TShape("t", 8, 1, "train"))
