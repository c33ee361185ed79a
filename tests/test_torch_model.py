"""The port's dense model and serving path against the JAX package's.

Both packages get the same parameters (the JAX package's seeded init,
handed over as numpy through ``params_from_jax``) and the same prompt
tokens.  Prefill caches, last-position logits and teacher-forced
``decode_step`` logits must agree in float32 within ``ATOL``/``RTOL``.

Why a tolerance: bf16 rounds at different places in the two frameworks.
XLA and PyTorch's CPU matmuls accumulate in another order and round their
bf16 outputs separately, so an element of the cache may differ by one bf16
ulp (a relative 2**-8 = 0.0039), and two layers carry such differences
forward into the residual stream.  Starting from atol = rtol = 2e-2, every
element passed but one in 6144 of the second layer's ``v``: 0.023 apart on
a value near 0.09.  That element is a projection whose terms (magnitude ~1)
nearly cancel, so it inherits their absolute rounding, up to one bf16 ulp at
magnitude 4 to 8 (0.016 to 0.031), not a share of its own small value.  So
RTOL stays 2e-2 and ATOL is 4e-2, just above one ulp at magnitude 8.  A
wrong layout, mask or rotation moves values by O(1), far outside both.
Logits differ by at most 0.009 at this size.

Within the port, tokens served through the compressed transfer must be
bitwise equal to tokens served without it, and the launcher must run on the
CPU when asked to.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import kvcache as JK  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import kvcache as TK  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving.engine import DisaggregatedEngine  # noqa: E402

ATOL, RTOL = 4e-2, 2e-2
ARCH = "smollm-135m"
B, S, MAX_SEQ = 2, 16, 24


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S))
    return jcfg, tcfg, jp, tp, toks.astype(np.int32)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def close(a, b, what):
    np.testing.assert_allclose(f32(a), f32(b), atol=ATOL, rtol=RTOL,
                               err_msg=what)


def test_configs_match():
    for arch in ("smollm-135m", "llama3.2-3b", "qwen3-32b", "minitron-4b"):
        j, t = jget(arch), tget(arch)
        for f in ("name", "num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "rope_theta", "norm_eps",
                  "tie_embeddings"):
            assert getattr(j, f) == getattr(t, f), (arch, f)
            assert getattr(j.reduced(), f) == getattr(t.reduced(), f), (arch, f)
        assert j.param_count() == t.param_count()
    full = tget(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.vocab_size) == (30, 576, 9, 3, 64, 49152)


def test_init_params_shapes_and_scales_match(models):
    jcfg, tcfg, jp, _, _ = models
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = TR.flatten_with_path(mine)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        ["".join(f"[{k!r}]" for k in p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.bfloat16, p
        sa, sb = float(np.std(f32(a))), float(b.float().std())
        assert abs(sa - sb) <= 0.15 * max(sa, 1e-3), (p, sa, sb)


def test_prefill_matches_jax(models):
    jcfg, tcfg, jp, tp, toks = models
    jl, js = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, max_seq=MAX_SEQ)
    tl, ts = TM.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                        max_seq=MAX_SEQ)
    assert sorted(js.cache) == sorted(ts.cache)
    for k in js.cache:
        assert tuple(js.cache[k].shape) == tuple(ts.cache[k].shape)
        assert ts.cache[k].dtype == torch.bfloat16
        close(js.cache[k], ts.cache[k], f"cache {k}")
        assert not ts.cache[k][:, :, S:].any()          # max_seq padding
    close(jl, tl, "last logits")
    np.testing.assert_array_equal(np.asarray(js.cache_len), ts.cache_len.numpy())


def test_ragged_prefill_matches_jax(models):
    jcfg, tcfg, jp, tp, toks = models
    lens = np.array([S, 9], np.int32)
    jl, js = JM.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, jcfg, max_seq=MAX_SEQ)
    tl, ts = TM.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "lengths": torch.from_numpy(lens)}, tcfg,
                        max_seq=MAX_SEQ)
    close(jl, tl, "ragged last logits")
    np.testing.assert_array_equal(ts.cache_len.numpy(), lens)
    np.testing.assert_array_equal(np.asarray(js.valid_mask()),
                                  ts.valid_mask().numpy())


def test_teacher_forced_decode_matches_jax(models):
    jcfg, tcfg, jp, tp, toks = models
    _, js = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :10])}, jcfg,
                       max_seq=MAX_SEQ)
    _, ts = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :10])}, tcfg,
                       max_seq=MAX_SEQ)
    for i in range(10, 14):
        jl, js = JM.decode_step(jp, jnp.asarray(toks[:, i:i + 1]), js, jcfg)
        tl, ts = TM.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]), ts, tcfg)
        close(jl, tl, f"decode logits at {i}")
    for k in js.cache:
        close(js.cache[k], ts.cache[k], f"decoded cache {k}")
    np.testing.assert_array_equal(np.asarray(js.cache_len), ts.cache_len.numpy())


def test_init_cache_and_bytes_match():
    jcfg, tcfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    jc, tc = JK.init_cache(jcfg, 3, 7), TK.init_cache(tcfg, 3, 7, device="cpu")
    assert {k: tuple(v.shape) for k, v in jc.items()} == \
        {k: tuple(v.shape) for k, v in tc.items()}
    assert JK.cache_bytes(jc) == TK.cache_bytes(tc)


@pytest.mark.parametrize("backend,n_chunks", [("cuda", 1), ("cuda", 3),
                                              ("torch", 1)])
def test_compressed_tokens_equal_uncompressed(models, backend, n_chunks):
    _, tcfg, _, tp, toks = models
    prompt = {"tokens": torch.from_numpy(toks)}
    _, st = TM.prefill(tp, prompt, tcfg)
    leaves = [C.to_bits(x, "bf16").view(torch.int16).numpy().view(np.uint16)
              for x in TR.leaves(st.cache)]
    cb = tcb.calibrate(leaves, k=16)
    eng_c = DisaggregatedEngine(tcfg, tp, cb, backend=backend,
                                n_chunks=n_chunks, device="cpu")
    eng_n = DisaggregatedEngine(tcfg, tp, cb, compress=False, device="cpu")
    out_c = eng_c.generate(prompt, num_steps=5, max_seq=MAX_SEQ)
    out_n = eng_n.generate(prompt, num_steps=5, max_seq=MAX_SEQ)
    assert torch.equal(out_c, out_n) and out_c.shape == (B, 6)
    assert eng_c.stats.codec_ok
    assert eng_c.stats.wire_bytes < eng_c.stats.raw_cache_bytes
    assert eng_n.stats.wire_bytes == eng_n.stats.raw_cache_bytes
    assert eng_c.describe_plan().startswith("TransferPlan[")
    pre = eng_c.prefill(prompt, max_seq=MAX_SEQ)
    got = eng_c.transfer(pre.state)
    assert all(C.bits_equal(a, b) for a, b in zip(TR.leaves(got.cache),
                                                  TR.leaves(pre.state.cache)))


@pytest.mark.parametrize("extra", [[], ["--n-chunks", "2"],
                                   ["--codec-backend", "torch", "--no-compress"]])
def test_launcher_runs_on_cpu_when_asked(extra, capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--new-tokens", "3", "--prompt-len", "12", *extra])
    assert res.tokens.shape == (2, 4)
    assert all(C.bits_equal(a, b) for a, b in zip(
        TR.leaves(res.delivered.cache), TR.leaves(res.prefill.state.cache)))
    out = capsys.readouterr().out
    assert "transfer ratio" in out and "on cpu" in out


def test_minitron_prefill_and_decode_match_jax():
    """minitron-4b (dense GQA, 24 query heads over 8 KV heads at full width)
    at its reduced size: prefill cache and logits, then teacher-forced
    decode steps, as for smollm-135m above."""
    jcfg, tcfg = jget("minitron-4b").reduced(), tget("minitron-4b").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, 14))
    toks = toks.astype(np.int32)
    jl, js = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :10])}, jcfg,
                        max_seq=MAX_SEQ)
    tl, ts = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :10])}, tcfg,
                        max_seq=MAX_SEQ)
    for k in js.cache:
        close(js.cache[k], ts.cache[k], f"cache {k}")
    close(jl, tl, "last logits")
    for i in range(10, 14):
        jl, js = JM.decode_step(jp, jnp.asarray(toks[:, i:i + 1]), js, jcfg)
        tl, ts = TM.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]), ts, tcfg)
        close(jl, tl, f"decode logits at {i}")
