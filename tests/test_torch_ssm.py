"""The port's Mamba-2 (SSM) family against the JAX package's.

Same inputs (numpy from fixed seeds; parameters from the JAX package's
seeded init through ``params_from_jax``), both packages, reduced sizes:

* ``ssd_scan``: S a multiple of the chunk and not (zero-dt padding), with
  and without an initial state.  Both round at the same points (``x * dt``
  in f32, ``C B^T ∘ L``, the decays and the carried states to bf16), so
  only the order of f32 sums differs: the f32 final state within 1e-5
  absolute (values near 0.1), ``y`` within one bf16 ulp (its one rounding).
* ``mamba2_forward`` / ``mamba2_decode`` on one block's parameters: the
  conv state within one bf16 ulp (rtol 8e-3, atol 2e-3); the f32 SSM state
  (a sum of products of SiLU outputs the two round to bf16 an ulp apart)
  within atol 2e-3 / rtol 2e-2 on values up to about 0.05; the block's
  output (a sum over d_inner of bf16 values an ulp apart) within the
  model's tolerance below.
* the reduced model's prefill and teacher-forced ``decode_step``: caches
  and logits within the dense model tests' ATOL 4e-2 / RTOL 2e-2 (the same
  bf16 roundings in another order, two layers deep).
* the served transfer: the port's session (``cuda``, plain versions on the
  CPU) delivers the same bits as the JAX session (``pallas``) with equal
  accounting, ``compress_fp32`` on (the f32 state's hi halves join the
  codec stream, its lo halves ship raw) and off (the state ships raw).
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import codebook as jcb  # noqa: E402
from repro.models import kvcache as JK  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serving import plan as JPL  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import kvcache as TK  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving import plan as TPL  # noqa: E402
from repro_torch.serving.engine import DisaggregatedEngine  # noqa: E402

ARCH = "mamba2-2.7b"
ATOL, RTOL = 4e-2, 2e-2            # the dense model tests' (test_torch_model)
B, S = 2, 20                       # 20 = 2.5 SSD chunks of 8


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S + 4))
    return jcfg, tcfg, jp, tp, toks.astype(np.int32)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def close(a, b, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(f32(a), f32(b), atol=atol, rtol=rtol, err_msg=what)


def both(x: np.ndarray, bf16: bool):
    """One numpy array as a JAX array and a tensor (bf16 or f32)."""
    if bf16:
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# the scan and the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [16, 13, 5])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_jax(s, with_state):
    cfg = jget(ARCH).reduced().ssm
    tcfg = tget(ARCH).reduced().ssm
    rng = np.random.default_rng(s + 10 * with_state)
    h, p_, g, n = 4, cfg.head_dim, 1, cfg.d_state
    jx, tx = both(rng.standard_normal((B, s, h, p_)).astype(np.float32), True)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, h)))).astype(np.float32)
    jdt, tdt = both(dt, False)
    ja, ta = both(np.log(np.linspace(1.0, 16.0, h)).astype(np.float32), False)
    jb, tb = both(rng.standard_normal((B, s, g, n)).astype(np.float32), True)
    jc, tc = both(rng.standard_normal((B, s, g, n)).astype(np.float32), True)
    js0 = ts0 = None
    if with_state:
        js0, ts0 = both(0.1 * rng.standard_normal((B, h, p_, n)).astype(np.float32),
                        False)
    jy, jfin = JS.ssd_scan(jx, jdt, ja, jb, jc, cfg, initial_state=js0)
    ty, tfin = TS.ssd_scan(tx, tdt, ta, tb, tc, tcfg, initial_state=ts0)
    assert ty.dtype == torch.bfloat16 and tfin.dtype == torch.float32
    assert tuple(ty.shape) == tuple(jy.shape) and tuple(tfin.shape) == tuple(jfin.shape)
    close(jfin, tfin, "final state", atol=1e-5, rtol=1e-5)
    close(jy, ty, "y", atol=2e-3, rtol=8e-3)


def test_segsum_exp_matches_jax():
    d = np.cumsum(-np.abs(np.random.default_rng(3).standard_normal((2, 8, 3))),
                  axis=1).astype(np.float32)
    want = JS.segsum_exp(jnp.asarray(d))
    got = TS.segsum_exp(torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    assert not got.isnan().any() and (got.numpy()[:, 0, 1:] == 0).all()


def test_mamba2_forward_and_decode_match_jax(models):
    jcfg, tcfg, jp, tp, _ = models
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mixer"])
    tl = TM.layer_params(tp["layers"]["mixer"], 0)
    x = np.random.default_rng(4).standard_normal((B, 11, jcfg.d_model)).astype(np.float32)
    jx, tx = both(x, True)
    jo, jst = JS.mamba2_forward(jl, jx, jcfg.ssm, jcfg.d_model)
    to, tst = TS.mamba2_forward(tl, tx, tcfg.ssm, tcfg.d_model)
    # out sums d_inner products of bf16 values an ulp apart: the model's
    # tolerance
    close(jo, to, "forward out")
    # the state sums products of SiLU(conv) outputs, which the two packages
    # round to bf16 an ulp apart (SiLU in one rounding or per op)
    close(jst.ssm, tst.ssm, "forward ssm state", atol=2e-3, rtol=2e-2)
    close(jst.conv, tst.conv, "forward conv state", atol=2e-3, rtol=8e-3)
    # one step from the JAX state, in both
    st = TS.SSMState(torch.from_numpy(np.array(jst.ssm)),
                     torch.from_numpy(f32(jst.conv)).bfloat16())
    y = np.random.default_rng(5).standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    jy, ty = both(y, True)
    jo, jst2 = JS.mamba2_decode(jl, jy, jst, jcfg.ssm, jcfg.d_model)
    to, tst2 = TS.mamba2_decode(tl, ty, st, tcfg.ssm, tcfg.d_model)
    close(jo, to, "decode out")
    close(jst2.ssm, tst2.ssm, "decode ssm state", atol=2e-3, rtol=2e-2)
    close(jst2.conv, tst2.conv, "decode conv state", atol=2e-3, rtol=8e-3)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_config_and_cache_layout_match():
    j, t = jget(ARCH), tget(ARCH)
    assert (t.family, t.num_layers, t.d_model, t.vocab_size) == \
        (j.family, j.num_layers, j.d_model, j.vocab_size)
    assert dataclasses.asdict(t.ssm) == dataclasses.asdict(j.ssm)
    assert dataclasses.asdict(t.reduced().ssm) == dataclasses.asdict(j.reduced().ssm)
    assert t.param_count() == j.param_count()
    for cfg_j, cfg_t, b, s in ((j.reduced(), t.reduced(), 3, 7), (j, t, 4, 2065)):
        jc = jax.eval_shape(lambda: JK.init_cache(cfg_j, b, s))
        tc = TK.init_cache(cfg_t, b, s, device="meta")
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()} == \
            {k: (tuple(v.shape), C.dtype_name(v.dtype)) for k, v in tc.items()}
        assert JK.cache_bytes(jc) == TK.cache_bytes(tc)
    # the full-width SSM state: 64 layers x 4 rows x 80 heads x 64 x 128 f32
    assert TK.cache_bytes({"ssm": tc["ssm"]}) == 671_088_640
    jcomp, jraw = JK.transferable_leaves(JK.init_cache(j.reduced(), 2, 4))
    tcomp, traw = TK.transferable_leaves(TK.init_cache(t.reduced(), 2, 4))
    assert [JPL.leaf_key(p) for p, _ in jcomp] == [TR.leaf_key(p) for p, _ in tcomp]
    assert [JPL.leaf_key(p) for p, _ in jraw] == [TR.leaf_key(p) for p, _ in traw]


def test_init_params_tree_matches(models):
    jcfg, tcfg, jp, _, _ = models
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = TR.flatten_with_path(mine)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        ["".join(f"[{k!r}]" for k in p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), p
        assert str(a.dtype) == C.dtype_name(b.dtype), p
    np.testing.assert_allclose(mine["layers"]["mixer"]["A_log"].numpy(),
                               np.asarray(jp["layers"]["mixer"]["A_log"]), rtol=1e-6)


def test_prefill_and_decode_match_jax(models):
    jcfg, tcfg, jp, tp, toks = models
    jl, js = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg, max_seq=S + 8)
    tl, ts = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])}, tcfg,
                        max_seq=S + 8)
    assert sorted(ts.cache) == ["conv", "ssm"]
    assert ts.cache["ssm"].dtype == torch.float32
    for k in js.cache:                       # recurrent state: never padded
        assert tuple(js.cache[k].shape) == tuple(ts.cache[k].shape)
        close(js.cache[k], ts.cache[k], f"cache {k}")
    close(jl, tl, "last logits")
    for i in range(S, S + 4):
        jl, js = JM.decode_step(jp, jnp.asarray(toks[:, i:i + 1]), js, jcfg)
        tl, ts = TM.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]), ts, tcfg)
        close(jl, tl, f"decode logits at {i}")
    for k in js.cache:
        close(js.cache[k], ts.cache[k], f"decoded cache {k}")
    np.testing.assert_array_equal(np.asarray(js.cache_len), ts.cache_len.numpy())


def test_ragged_prefill_is_rejected(models):
    _, tcfg, _, tp, toks = models
    with pytest.raises(ValueError, match="ragged"):
        TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S]),
                        "lengths": torch.tensor([S, 3])}, tcfg)


# ---------------------------------------------------------------------------
# the served transfer
# ---------------------------------------------------------------------------

def raw_bytes_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("compress_fp32", [True, False])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_served_transfer_matches_jax_session(models, compress_fp32, n_chunks):
    """The port's prefill cache through both packages' sessions: the same
    bits delivered, the same wire bytes, per-leaf bytes, lo-half bytes and
    retries; the codebook from the launcher's calibration (bf16 leaves: the
    conv state only), so the hi halves escape and walk the schedule."""
    _, tcfg, _, tp, toks = models
    _, st = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])}, tcfg)
    tcb_ = serve.calibrate_on_model(tcfg, tp, device="cpu", seed=1)
    jcb_ = jcb.Codebook.from_json(tcb_.to_json())
    jcache = {"ssm": jnp.asarray(st.cache["ssm"].numpy()),
              "conv": jnp.asarray(f32(st.cache["conv"])).astype(jnp.bfloat16)}
    kw = dict(n_chunks=n_chunks, compress_fp32=compress_fp32)
    jp = JPL.TransferPlan.build(jcache, JPL.TransferConfig(
        codebook=jcb_, backend="pallas", **kw))
    tpl = TPL.TransferPlan.build(st.cache, TPL.TransferConfig(
        codebook=tcb_, backend="cuda", **kw))
    assert [r.route for r in tpl.routes] == [r.route for r in jp.routes] == \
        ["splitzip", "fp32_hilo" if compress_fp32 else "raw"]
    js, ts = jp.session(), tpl.session()
    jo, to = js.transfer(jcache), ts.transfer(st.cache)
    for k in ("conv", "ssm"):
        np.testing.assert_array_equal(raw_bytes_of(to[k]), raw_bytes_of(st.cache[k]))
        np.testing.assert_array_equal(raw_bytes_of(jo[k]), raw_bytes_of(to[k]))
    a, b = js.last_stats, ts.last_stats
    assert (b.wire_bytes, b.fp32_lo_wire_bytes, b.leaf_wire_bytes,
            b.chunk_wire_bytes, b.chunk_retry_steps, b.raw_passthrough_bytes) == \
        (a.wire_bytes, a.fp32_lo_wire_bytes, a.leaf_wire_bytes,
         a.chunk_wire_bytes, a.chunk_retry_steps, a.raw_passthrough_bytes)
    assert b.all_ok == a.all_ok


@pytest.mark.parametrize("compress_fp32", [True, False])
def test_compressed_tokens_equal_uncompressed(models, compress_fp32):
    _, tcfg, _, tp, toks = models
    prompt = {"tokens": torch.from_numpy(toks[:, :S])}
    cb = serve.calibrate_on_model(tcfg, tp, device="cpu", seed=1)
    eng_c = DisaggregatedEngine(tcfg, tp, cb, backend="cuda",
                                compress_fp32=compress_fp32, device="cpu")
    eng_n = DisaggregatedEngine(tcfg, tp, cb, compress=False, device="cpu")
    res_c = serve.serve_once(eng_c, prompt, 4)
    res_n = serve.serve_once(eng_n, prompt, 4)
    assert torch.equal(res_c.tokens, res_n.tokens) and res_c.tokens.shape == (B, 5)
    assert all(C.bits_equal(a, b) for a, b in zip(
        TR.leaves(res_c.delivered.cache), TR.leaves(res_c.prefill.state.cache)))
    # the f32 state takes the hi/lo route; its hi halves escape under a
    # book calibrated on the conv state, and may walk the capacity schedule
    assert [r.route for r in eng_c.plan.routes] == \
        ["splitzip", "fp32_hilo" if compress_fp32 else "raw"]
    assert eng_c.stats.encoded_units == 1 + compress_fp32
    assert eng_c.stats.wire_bytes < eng_c.stats.raw_cache_bytes


def test_launcher_runs_with_compress_fp32_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--new-tokens", "3", "--prompt-len", "12",
                      "--compress-fp32"])
    assert res.tokens.shape == (2, 4)
    assert all(C.bits_equal(a, b) for a, b in zip(
        TR.leaves(res.delivered.cache), TR.leaves(res.prefill.state.cache)))
    out = capsys.readouterr().out
    assert "fp32_hilo" in out and "on cpu" in out


def test_resident_compressed_demotes_like_jax(models):
    """No compressed residency for recurrent state: the JAX engine's pool
    refuses the cache at admission (``ResidencyError``) and demotes; so
    does the port's, with the raw engine's tokens."""
    from repro.serving.engine import DisaggregatedEngine as JEngine
    jcfg, tcfg, jp, tp, toks = models
    cb = tcb.DEFAULT_BF16_CODEBOOK
    jeng = JEngine(jcfg, jp, jcb.DEFAULT_BF16_CODEBOOK, resident="compressed",
                   backend="xla")
    jeng.generate({"tokens": jnp.asarray(toks[:, :12])}, num_steps=3)
    eng = DisaggregatedEngine(tcfg, tp, cb, resident="compressed", device="cpu")
    raw = DisaggregatedEngine(tcfg, tp, cb, device="cpu")
    prompt = {"tokens": torch.from_numpy(toks[:, :12])}
    out, want = eng.generate(prompt, 3), raw.generate(prompt, 3)
    assert (eng.stats.resident_admits, eng.stats.resident_demotions) == \
        (jeng.stats.resident_admits, jeng.stats.resident_demotions) == (0, 1)
    assert torch.equal(out, want)
    assert eng.resident_tokens_per_page() == jeng.resident_tokens_per_page()
