"""The frontend families and the qwen3-moe-235b-a22b config against the
JAX package.

pixtral-12b puts ``frontend_len`` projected patch embeddings in front of its
text tokens; hubert-xlarge is encoder-only: projected audio frames, attention
without the causal mask, every frame's logits, no cache and no decode step.
Both packages get the same parameters (the JAX package's seeded init, handed
over through ``params_from_jax``) and the same inputs (numpy from a seed), at
the reduced configs (2 layers, d_model 128).

Tolerances are those of ``tests/test_torch_model.py`` and for the same
reason: the two frameworks round their bf16 matmul outputs at different
places, so a cached K/V element or an embedding may differ by one bf16 ulp,
and a projection whose terms nearly cancel inherits their absolute rounding
(up to one ulp at magnitude 8, 0.031).  Logits, K/V and embeddings are held
to ``ATOL, RTOL = 4e-2, 2e-2``; at these seeds logits differ by at most
0.008 and K/V by at most 0.032.  Pixtral's decode step is also held against
the port's own forward at the same position, within the JAX package's own
bound for that check (``tests/test_arch_smoke.py``: 0.08).

The JAX engine's compressed-resident default ``max_seq`` counts text tokens
only, so a pixtral batch whose text, first token and steps end on a page
boundary below its patch-extended length demotes (and its raw decode writes
past the cache, clamped to the last slot).  The port keeps the JAX engine's
default; both sides of that fault are pinned below, and a caller passes
``max_seq`` explicitly.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import kvcache as JK  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import plan as JPL  # noqa: E402
from repro.serving.engine import DisaggregatedEngine as JEngine  # noqa: E402
from repro.serving.prefill import prefill_step as jprefill_step  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import kvcache as TK  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving import plan as TPL  # noqa: E402
from repro_torch.serving.engine import DisaggregatedEngine  # noqa: E402
from repro_torch.serving.prefill import prefill_step  # noqa: E402

ATOL, RTOL = 4e-2, 2e-2
DECODE_VS_FORWARD = 8e-2
NEW_ARCHS = ("pixtral-12b", "hubert-xlarge", "qwen3-moe-235b-a22b")
B, S_TEXT, S_AUDIO = 2, 16, 16


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def close(a, b, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(f32(a), f32(b), atol=atol, rtol=rtol,
                               err_msg=what)


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return C.signed_view(x).contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.asarray(x).view(np.uint8).reshape(-1)


def inputs(cfg, seed: int = 0, s_text: int = S_TEXT):
    """The same batch for both packages: tokens, and the frontend's
    patches or frames (bf16 of a seeded normal)."""
    rng = np.random.default_rng(seed)
    jb, tb = {}, {}
    if cfg.frontend == "audio_frames":
        fr = rng.standard_normal((B, S_AUDIO, cfg.frontend_dim)).astype(np.float32)
        jb["frames"] = jnp.asarray(fr, jnp.bfloat16)
        tb["frames"] = torch.from_numpy(fr).to(torch.bfloat16)
        return jb, tb
    toks = rng.integers(0, cfg.vocab_size, (B, s_text)).astype(np.int32)
    jb["tokens"], tb["tokens"] = jnp.asarray(toks), torch.from_numpy(toks)
    if cfg.frontend == "vision_patches":
        pa = rng.standard_normal((B, cfg.frontend_len, cfg.frontend_dim)
                                 ).astype(np.float32)
        jb["patches"] = jnp.asarray(pa, jnp.bfloat16)
        tb["patches"] = torch.from_numpy(pa).to(torch.bfloat16)
    return jb, tb


@pytest.fixture(scope="module", params=NEW_ARCHS)
def family(request):
    jcfg, tcfg = jget(request.param).reduced(), tget(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def pixtral():
    jcfg, tcfg = jget("pixtral-12b").reduced(), tget("pixtral-12b").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def pixtral_cb(pixtral):
    """The JAX launcher's codebook calibration on the reduced pixtral."""
    jcfg, _, jp, _ = pixtral
    cb = jserve.calibrate_on_model(jcfg, jp)
    return cb, tcb.Codebook.from_json(cb.to_json())


@pytest.fixture(scope="module")
def hubert():
    jcfg, tcfg = jget("hubert-xlarge").reduced(), tget("hubert-xlarge").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(2))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_field_for_field(arch):
    j, t = jget(arch), tget(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert j.param_count() == t.param_count()
    assert j.active_param_count() == t.active_param_count()


def test_reduced_keeps_the_frontend():
    for arch, dim in (("pixtral-12b", 64), ("hubert-xlarge", 64)):
        r = tget(arch).reduced()
        assert (r.frontend, r.frontend_dim, r.frontend_len) == \
            (tget(arch).frontend, dim, 8)
    assert tget("hubert-xlarge").reduced().encoder_only


# ---------------------------------------------------------------------------
# parameters, embeddings, forward, prefill
# ---------------------------------------------------------------------------

def test_init_params_tree_matches(family):
    jcfg, tcfg, jp, tp = family
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = TR.flatten_with_path(mine)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        ["".join(f"[{k!r}]" for k in p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), p
        assert str(a.dtype) == C.dtype_name(b.dtype), p
    # params_from_jax carries every leaf bit for bit, frontend_proj included
    for (p, a), (_, b) in zip(jl, TR.flatten_with_path(tp)[0]):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=str(p))
    assert ("frontend_proj" in mine) == (tcfg.frontend is not None)


def test_embed_inputs_match(family):
    jcfg, tcfg, jp, tp = family
    jb, tb = inputs(jcfg)
    je, te = JM.embed_inputs(jp, jb, jcfg), TM.embed_inputs(tp, tb, tcfg)
    assert tuple(je.shape) == tuple(te.shape) and te.dtype == torch.bfloat16
    close(je, te, "embeddings")
    if tcfg.frontend == "vision_patches":
        # the text positions are a gather: bitwise, after the patches
        n = tcfg.frontend_len
        np.testing.assert_array_equal(bits(je[:, n:]), bits(te[:, n:]))


def test_forward_logits_match(family):
    jcfg, tcfg, jp, tp = family
    jb, tb = inputs(jcfg, seed=1)
    jl, _, _ = JM.forward(jp, jb, jcfg)
    tl, _, _ = TM.forward(tp, tb, tcfg)
    assert tuple(jl.shape) == tuple(tl.shape)
    close(jl, tl, "logits")


def test_prefill_matches(family):
    jcfg, tcfg, jp, tp = family
    jb, tb = inputs(jcfg, seed=2)
    max_seq = None if jcfg.encoder_only else S_TEXT + jcfg.frontend_len + 8
    jl, js = JM.prefill(jp, jb, jcfg, max_seq=max_seq)
    tl, ts = TM.prefill(tp, tb, tcfg, max_seq=max_seq)
    assert tuple(jl.shape) == tuple(tl.shape)
    close(jl, tl, "prefill logits")
    np.testing.assert_array_equal(np.asarray(js.cache_len), ts.cache_len.numpy())
    assert sorted(js.cache) == sorted(ts.cache)
    for k in js.cache:
        assert tuple(js.cache[k].shape) == tuple(ts.cache[k].shape)
        close(js.cache[k], ts.cache[k], f"cache {k}")


# ---------------------------------------------------------------------------
# pixtral: patches before tokens, decode after them
# ---------------------------------------------------------------------------

def test_pixtral_prefill_counts_the_patches(pixtral):
    jcfg, tcfg, jp, tp = pixtral
    _, tb = inputs(tcfg, seed=3)
    _, st = TM.prefill(tp, tb, tcfg, max_seq=40)
    n = tcfg.frontend_len + S_TEXT
    assert st.cache_len.tolist() == [n] * B
    assert st.cache["k"].shape[2] == 40 and not st.cache["k"][:, :, n:].any()
    assert TK.init_cache(tcfg, B, 40, device="cpu")["k"].shape == st.cache["k"].shape
    with pytest.raises(ValueError, match="token-decoder only"):
        TM.prefill(tp, dict(tb, lengths=torch.tensor([S_TEXT, 5])), tcfg)


def test_pixtral_decode_matches_jax_and_forward(pixtral):
    jcfg, tcfg, jp, tp = pixtral
    jb, tb = inputs(tcfg, seed=4, s_text=S_TEXT + 1)
    jprompt = dict(jb, tokens=jb["tokens"][:, :-1])
    tprompt = dict(tb, tokens=tb["tokens"][:, :-1])
    total = tcfg.frontend_len + S_TEXT
    _, js = JM.prefill(jp, jprompt, jcfg, max_seq=total + 8)
    _, ts = TM.prefill(tp, tprompt, tcfg, max_seq=total + 8)
    jd, js2 = JM.decode_step(jp, jb["tokens"][:, -1:], js, jcfg)
    td, ts2 = TM.decode_step(tp, tb["tokens"][:, -1:], ts, tcfg)
    close(jd, td, "decode logits")
    assert ts2.cache_len.tolist() == [total + 1] * B
    np.testing.assert_array_equal(np.asarray(js2.cache_len), ts2.cache_len.numpy())
    full, _, _ = TM.forward(tp, tb, tcfg)
    close(full[:, -1], td, "decode vs forward", DECODE_VS_FORWARD,
          DECODE_VS_FORWARD)


def test_pixtral_make_inputs_shapes():
    cfg = tget("pixtral-12b").reduced()
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig("t", seq_len=24, global_batch=3, kind="prefill")
    got = TM.make_inputs(cfg, shape, torch.Generator().manual_seed(0))
    want = JM.make_inputs(jget("pixtral-12b").reduced(), shape)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert got["patches"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="frontend positions"):
        TM.make_inputs(cfg, shape, torch.Generator(), seq=4)
    prompt = serve.make_prompt(cfg, 2, 24, device="cpu", seed=0)
    assert sorted(prompt) == ["patches", "tokens"]
    assert serve.prompt_positions(cfg, prompt) == 24


def test_pixtral_cache_through_a_session_matches_jax(pixtral, pixtral_cb):
    jcfg, tcfg, jp, tp = pixtral
    cb, tbook = pixtral_cb
    jb, _ = inputs(jcfg, seed=5)
    _, js = JM.prefill(jp, jb, jcfg, max_seq=32)
    jc = js.cache
    tc = {k: torch.from_numpy(np.asarray(v).view(np.int16).copy()
                              ).view(torch.bfloat16) for k, v in jc.items()}
    jplan = JPL.TransferPlan.build(jc, JPL.TransferConfig(codebook=cb, backend="xla"))
    tplan = TPL.TransferPlan.build(tc, TPL.TransferConfig(codebook=tbook,
                                                         backend="torch"))
    assert tplan.describe() == jplan.describe().replace("backend=xla",
                                                        "backend=torch")
    jsess, tsess = jplan.session(), tplan.session()
    jout, tout = jsess.transfer(jc), tsess.transfer(tc)
    for k in jc:
        np.testing.assert_array_equal(bits(jout[k]), bits(tout[k]))
        np.testing.assert_array_equal(bits(tout[k]), bits(tc[k]))
    assert dataclasses.asdict(jsess.last_stats) == dataclasses.asdict(tsess.last_stats)


def test_launcher_serves_pixtral_on_cpu():
    res = serve.main(["--arch", "pixtral-12b", "--reduced", "--device", "cpu",
                      "--prompt-len", "20", "--new-tokens", "3"])
    assert tuple(res.tokens.shape) == (2, 4)
    # 8 patches + 12 tokens, the first token and 3 steps: the JAX launcher's
    # max_seq of prompt_len + new_tokens + 1
    assert res.delivered.cache["k"].shape[2] == 24
    assert res.delivered.cache_len.tolist() == [20, 20]


def test_resident_default_max_seq_is_the_jax_engines(pixtral, pixtral_cb):
    """Both engines round a text-only default up to the page (16 tokens at
    2 KB pages here): 11 tokens + 1 + 4 steps = 16 slots for a 19-position
    prompt, so both demote; an explicit max_seq admits in both."""
    jcfg, tcfg, jp, tp = pixtral
    cb, tbook = pixtral_cb
    for max_seq, demoted in ((None, 1), (jcfg.frontend_len + 11 + 1 + 4, 0)):
        jb, tb = inputs(jcfg, seed=6, s_text=11)
        je = JEngine(jcfg, jp, cb, resident="compressed", page_bytes=2048)
        te = DisaggregatedEngine(tcfg, tp, tbook, resident="compressed",
                                 page_bytes=2048, device="cpu")
        assert je.resident_tokens_per_page() == te.resident_tokens_per_page() == 16
        jt = je.generate(jb, num_steps=4, max_seq=max_seq)
        tt = te.generate(tb, num_steps=4, max_seq=max_seq)
        for e in (je, te):
            assert (e.stats.resident_demotions, e.stats.resident_admits) == \
                (demoted, 1 - demoted), max_seq
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())


# ---------------------------------------------------------------------------
# hubert: encoder-only
# ---------------------------------------------------------------------------

def test_hubert_attention_is_not_causal(hubert):
    _, tcfg, _, tp = hubert
    _, tb = inputs(tcfg, seed=7)
    base, _, _ = TM.forward(tp, tb, tcfg)
    late = dict(tb, frames=tb["frames"].clone())
    late["frames"][:, -1] += 1.0
    moved, _, _ = TM.forward(tp, late, tcfg)
    # a change to the last frame reaches the first frame's logits
    assert float((base[:, 0] - moved[:, 0]).abs().max()) > 1e-2


def test_hubert_prefill_step_matches_jax(hubert):
    jcfg, tcfg, jp, tp = hubert
    jb, tb = inputs(jcfg, seed=8)
    jo = jprefill_step(jp, jb, jcfg)
    to = prefill_step(tp, tb, tcfg)
    close(jo.last_logits, to.last_logits, "last frame's logits")
    # the first unit: the first frame's argmax, well clear of a tie here
    jl0 = np.sort(f32(JM.prefill(jp, jb, jcfg)[0][:, 0]), axis=-1)
    assert (jl0[:, -1] - jl0[:, -2]).min() > 2 * ATOL
    np.testing.assert_array_equal(np.asarray(jo.first_token), to.first_token.numpy())
    assert to.state.cache == {} and jo.state.cache == {}
    assert to.state.cache_len.tolist() == [S_AUDIO] * B


def test_hubert_has_no_cache_and_no_decode(hubert):
    jcfg, tcfg, jp, tp = hubert
    assert TK.init_cache(tcfg, B, 8) == {} == JK.init_cache(jcfg, B, 8)
    _, st = TM.prefill(tp, inputs(tcfg)[1], tcfg)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="encoder-only: no decode step"):
        TM.decode_step(tp, tok, st, tcfg)
    with pytest.raises(ValueError, match="encoder-only: no decode step"):
        TM.resident_decode_step(tp, tok, st, tcfg)
    with pytest.raises(ValueError, match="encoder-only: no decode step"):
        JM.decode_step(jp, jnp.zeros((B, 1), jnp.int32), st, jcfg)


def test_launchers_refuse_hubert():
    for main in (serve.main, jserve.main):
        with pytest.raises(SystemExit, match="encoder-only"):
            main(["--arch", "hubert-xlarge", "--reduced"])
