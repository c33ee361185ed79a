"""The port's MoE family (qwen3-moe-30b-a3b) against the JAX package's.

``moe_ffn`` gets the JAX package's seeded MoE parameters (through
``params_from_jax``, bitwise) and the same bf16 tokens.  The dispatch must
be the JAX one exactly: top-k indices, the sorted order, every slot and
every drop.  The outputs may differ by bf16 round-off only: both sides
accumulate the expert products in f32 and round them to bf16, but XLA and
PyTorch sum in another order and round ``silu`` at other places, so an
element may differ by one bf16 ulp at each of its two products and at each
of the k - 1 adds of the combine.  At these sizes (|y| up to about 2) that
is at most a few hundredths: ``FFN_ATOL``/``FFN_RTOL`` = 2e-2, while a
wrong slot, gate or drop moves an output by O(1).

The model (``.reduced()``: 2 layers, 8 experts, top-2) is held to JAX's
prefill caches and logits, teacher-forced decode logits and aux loss within
the ``ATOL``/``RTOL`` that ``test_torch_model.py`` justifies, for every
token whose routing is not on a near-tie (``robust``: a top-k margin under
``MARGIN`` lets bf16 round-off pick another expert, which moves that
token's logits by O(0.1) and, through attention, its row's later ones),
and the aux loss within rtol 1e-2 (a near-tied top-1 choice moves it by
about 1e-3 relative);
``resident_decode_step`` for this family is a case of
``test_torch_mla.py::test_resident_decode_step_matches_jax``.  Within the
port, tokens served through the compressed transfer must equal tokens
served without it, and the launcher must serve the family on the CPU.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jb  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving.engine import DisaggregatedEngine  # noqa: E402

ATOL, RTOL = 4e-2, 2e-2          # as test_torch_model.py, for the same reason
FFN_ATOL, FFN_RTOL = 2e-2, 2e-2
MARGIN = 1e-2
ARCH = "qwen3-moe-30b-a3b"
B, S, MAX_SEQ = 2, 16, 24


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def close(a, b, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(f32(a), f32(b), atol=atol, rtol=rtol,
                               err_msg=what)


def moe_cfgs(capacity_factor=None):
    """(JAX, port) MoE configs of the reduced model, optionally with another
    capacity factor."""
    j, t = jb.get_config(ARCH).reduced().moe, tget(ARCH).reduced().moe
    if capacity_factor is not None:
        j = dataclasses.replace(j, capacity_factor=capacity_factor)
        t = dataclasses.replace(t, capacity_factor=capacity_factor)
    return j, t


@pytest.fixture(scope="module")
def ffn_params():
    jcfg, _ = moe_cfgs()
    jp = JMOE.init_moe(jax.random.PRNGKey(3), 128, jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jb.get_config(ARCH).reduced(), tget(ARCH).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S))
    return jcfg, tcfg, jp, tp, toks.astype(np.int32)


def tokens_x(seed, b=2, s=32, d=128):
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def jax_route(router, x, cfg):
    """The dispatch steps of ``repro.models.moe.moe_ffn``, as numpy."""
    t = x.shape[0] * x.shape[1]
    cap = JMOE.capacity(t, cfg)
    xf = x.reshape(t, -1)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf.astype(jnp.float32),
                                      router), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e)
    e_sorted = flat_e[order]
    counts = jnp.zeros((cfg.num_experts,), jnp.int32).at[flat_e].add(1)
    rank = jnp.arange(t * cfg.top_k) - (jnp.cumsum(counts) - counts)[e_sorted]
    slot = jnp.where(rank < cap, e_sorted * cap + rank, cfg.num_experts * cap)
    return {k: np.asarray(v) for k, v in dict(
        expert_idx=idx, order=order, slot=slot, token_of=order // cfg.top_k).items()}


def test_config_matches():
    j, t = jb.get_config(ARCH), tget(ARCH)
    kw = dataclasses.asdict(t)
    kw["moe"] = jb.MoEConfig(**kw["moe"])
    assert j == jb.ArchConfig(**kw)
    assert j.param_count() == t.param_count() == 30_531_911_680
    assert (t.num_layers, t.d_model, t.num_heads, t.num_kv_heads, t.head_dim,
            t.moe.num_experts, t.moe.top_k, t.moe.d_ff_expert) == \
        (48, 2048, 32, 4, 128, 128, 8, 768)
    assert moe_cfgs()[0] == jb.MoEConfig(**dataclasses.asdict(moe_cfgs()[1]))


@pytest.mark.parametrize("t", [1, 4, 8192, 100])
def test_capacity_matches(t):
    full_j, full_t = jb.get_config(ARCH).moe, tget(ARCH).moe
    assert TMOE.capacity(t, full_t) == JMOE.capacity(t, full_j)
    assert TMOE.capacity(4 * 2048, full_t) == 640 and TMOE.capacity(4, full_t) == 8


@pytest.mark.parametrize("capacity_factor,drops", [(None, False), (0.25, True)])
def test_moe_ffn_matches_jax(ffn_params, capacity_factor, drops):
    jcfg, tcfg = moe_cfgs(capacity_factor)
    jp, tp = ffn_params
    jx, tx = tokens_x(4)
    cap = TMOE.capacity(64, tcfg)
    want = jax_route(jp["router"], jx, jcfg)
    got = TMOE.route(tp["router"], tx.reshape(64, -1), tcfg, cap)
    for key in ("expert_idx", "order", "slot", "token_of"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    n_drop = int((got["slot"] == tcfg.num_experts * cap).sum())
    assert (n_drop > 0) == drops
    jy, jaux = JMOE.moe_ffn(jp, jx, jcfg)
    ty, taux = TMOE.moe_ffn(tp, tx, tcfg)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == tuple(jy.shape)
    close(jy, ty, "moe_ffn", FFN_ATOL, FFN_RTOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_moe_ffn_dropless_matches_dense_ref(ffn_params):
    jcfg, tcfg = moe_cfgs()
    jp, tp = ffn_params
    jx, tx = tokens_x(5)
    got = TMOE.moe_ffn_dense_ref(tp, tx, tcfg)
    close(JMOE.moe_ffn_dense_ref(jp, jx, jcfg), got, "dense ref", FFN_ATOL, FFN_RTOL)
    close(got, TMOE.moe_ffn(tp, tx, tcfg)[0], "sorted vs dense", FFN_ATOL, FFN_RTOL)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.1], [0.25, 0.25, 0.25, 0.25, 0.0]])
    vals, idx = TMOE.top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_params_from_jax_carries_the_moe_tree(models):
    _, tcfg, jp, tp, _ = models
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = TR.flatten_with_path(tp)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        ["".join(f"[{k!r}]" for k in p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        a = np.asarray(a)
        if a.dtype == np.float32:
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(a, b.numpy(), err_msg=str(p))
        else:
            np.testing.assert_array_equal(a.view(np.uint16),
                                          b.view(torch.int16).numpy().view(np.uint16),
                                          err_msg=str(p))
    ffn = tp["layers"]["ffn"]
    e, f, d = tcfg.moe.num_experts, tcfg.moe.d_ff_expert, tcfg.d_model
    assert ffn["router"].dtype == torch.float32
    assert tuple(ffn["router"].shape) == (2, d, e)
    assert tuple(ffn["w_gate_up"].shape) == (2, e, d, 2 * f)
    assert tuple(ffn["w_down"].shape) == (2, e, f, d)
    # the port's own init: same tree, shapes, dtypes and scales
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ml = TR.flatten_with_path(mine)[0]
    assert [p for p, _ in ml] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, ml):
        assert tuple(a.shape) == tuple(b.shape), p
        assert (b.dtype == torch.float32) == (np.asarray(a).dtype == np.float32), p
        sa, sb = float(np.std(f32(a))), float(b.float().std())
        assert abs(sa - sb) <= 0.15 * max(sa, 1e-3), (p, sa, sb)


@pytest.fixture
def margins(monkeypatch):
    """Every call of the port's ``route`` records each token's top-k margin:
    its k-th routing probability less its (k+1)-th."""
    seen = []
    route = TMOE.route

    def recording(router, xf, cfg, cap, ep=None):
        out = route(router, xf, cfg, cap, ep)
        top = torch.sort(out["probs"], dim=-1, descending=True).values
        seen.append(top[:, cfg.top_k - 1] - top[:, cfg.top_k])
        return out

    monkeypatch.setattr(TMOE, "route", recording)
    return seen


def robust(seen, b, s, ok_rows=None):
    """Which (b, s) logits can be held to JAX's: a token whose margin in
    some layer is under ``MARGIN`` may route to another expert there (the
    two frameworks' hidden states differ by bf16 round-off, which moves a
    routing probability by about 1e-3), and a token of an earlier layer
    that may have routed otherwise reaches every later position of its row
    through attention.  Returns (logits comparable (B, S), row still
    comparable (B,)); ``seen`` holds one entry per layer of one call."""
    m = torch.stack(seen).reshape(len(seen), b, s)
    early = (m[:-1] >= MARGIN).all(dim=0).int().cumprod(dim=1).bool()
    if ok_rows is not None:
        early &= ok_rows[:, None]
    seen.clear()
    return early & (m[-1] >= MARGIN), early[:, -1]


def test_moe_prefill_decode_and_aux_match_jax(models, margins):
    jcfg, tcfg, jp, tp, toks = models
    jlog, _, jaux = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tlog, _, taux = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    ok, _ = robust(margins, B, S)
    assert int(ok.sum()) >= B * S // 2
    close(np.asarray(jlog)[ok.numpy()], tlog[ok], "forward logits")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-2)
    assert float(taux) > 0

    jl, js = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :10])}, jcfg,
                        max_seq=MAX_SEQ)
    tl, ts = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :10])}, tcfg,
                        max_seq=MAX_SEQ)
    ok, rows = robust(margins, B, 10)
    assert sorted(ts.cache) == ["k", "v"]
    for k in js.cache:
        assert tuple(js.cache[k].shape) == tuple(ts.cache[k].shape)
        close(np.asarray(js.cache[k])[:, rows.numpy()], ts.cache[k][:, rows],
              f"prefill cache {k}")
    close(np.asarray(jl)[ok[:, -1].numpy()], tl[ok[:, -1]], "prefill logits")
    compared = 0
    for i in range(10, 14):
        jl, js = JM.decode_step(jp, jnp.asarray(toks[:, i:i + 1]), js, jcfg)
        tl, ts = TM.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]), ts, tcfg)
        ok, rows = robust(margins, B, 1, rows)
        close(np.asarray(jl)[ok[:, 0].numpy()], tl[ok[:, 0]], f"decode logits at {i}")
        compared += int(ok.sum())
    assert compared >= B * 4 // 2
    for k in js.cache:
        close(np.asarray(js.cache[k])[:, rows.numpy()], ts.cache[k][:, rows],
              f"decoded cache {k}")


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_moe_compressed_tokens_equal_uncompressed(models, n_chunks):
    _, tcfg, _, tp, toks = models
    prompt = {"tokens": torch.from_numpy(toks)}
    _, st = TM.prefill(tp, prompt, tcfg)
    leaves = [C.to_bits(x, "bf16").view(torch.int16).numpy().view(np.uint16)
              for x in TR.leaves(st.cache)]
    cb = tcb.calibrate(leaves, k=16)
    eng_c = DisaggregatedEngine(tcfg, tp, cb, n_chunks=n_chunks, device="cpu")
    eng_n = DisaggregatedEngine(tcfg, tp, cb, compress=False, device="cpu")
    out_c = eng_c.generate(prompt, num_steps=4, max_seq=MAX_SEQ)
    out_n = eng_n.generate(prompt, num_steps=4, max_seq=MAX_SEQ)
    assert torch.equal(out_c, out_n) and out_c.shape == (B, 5)
    assert eng_c.stats.codec_ok
    assert eng_c.stats.wire_bytes < eng_c.stats.raw_cache_bytes


def test_moe_resident_engine_serves_on_cpu(models):
    _, tcfg, _, tp, toks = models
    prompt = {"tokens": torch.from_numpy(toks)}
    _, st = TM.prefill(tp, prompt, tcfg)
    leaves = [C.to_bits(x, "bf16").view(torch.int16).numpy().view(np.uint16)
              for x in TR.leaves(st.cache)]
    cb = tcb.calibrate(leaves, k=16)
    eng = DisaggregatedEngine(tcfg, tp, cb, resident="compressed",
                              page_bytes=2048, device="cpu")
    res = serve.serve_once(eng, prompt, 20)
    assert (eng.stats.resident_admits, eng.stats.resident_demotions) == (1, 0)
    assert res.tokens.shape == (B, 21)
    pool = eng._pool
    assert pool.geom.tokens_per_page == 16
    # the 16-token prompt fills one page; the tail flushes once, at 32
    assert pool.allocated_pages("k") == pool.allocated_pages("v") == 2 * B * 2


def test_launcher_serves_moe_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--new-tokens", "3", "--prompt-len", "12"])
    assert res.tokens.shape == (2, 4)
    assert sorted(res.delivered.cache) == ["k", "v"]
    assert all(C.bits_equal(a, b) for a, b in zip(
        TR.leaves(res.delivered.cache), TR.leaves(res.prefill.state.cache)))
    out = capsys.readouterr().out
    assert "transfer ratio" in out and "on cpu" in out
