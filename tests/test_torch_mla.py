"""The port's MLA family and resident decode step against the JAX package's.

minicpm3-4b (MLA: latent ``ckv``/``krope`` cache, absorbed-form decode)
comes to the port here.  Both packages get the same parameters (the JAX
package's seeded init through ``params_from_jax``) and the same tokens.
Prefill caches and logits, and teacher-forced ``decode_step`` logits, must
agree within the ``ATOL``/``RTOL`` that ``test_torch_model.py`` justifies
(bf16 rounds at other places in the two frameworks: one bf16 ulp at
magnitude up to 8).

``resident_decode_step`` is then held against the JAX package's, for all three
families, from pools built over the SAME cache bits: the page streams are
identical, so the logits differ only by the model's own rounding, within the
same tolerance, and the tails grow with the same tokens.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import codebook as jcb  # noqa: E402
from repro.core.backend import resolve_backend  # noqa: E402
from repro.models import kvcache as JK  # noqa: E402
from repro.models import kvpool as JP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.plan import TransferConfig as JTC, TransferPlan as JPlan  # noqa: E402
from repro.serving.session import encode_leaves as jencode  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.core.backend import get_backend  # noqa: E402
from repro_torch.kernels import splitzip_attention as SA  # noqa: E402
from repro_torch.models import kvcache as TK  # noqa: E402
from repro_torch.models import kvpool as TP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402
from repro_torch.serving.plan import TransferConfig as TTC, TransferPlan as TPlan  # noqa: E402
from repro_torch.serving.session import encode_leaves as tencode  # noqa: E402

ATOL, RTOL = 4e-2, 2e-2          # as test_torch_model.py, for the same reason
ARCH = "minicpm3-4b"
B, S, MAX_SEQ = 2, 16, 24
CHUNK = 1024


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def close(a, b, what):
    np.testing.assert_allclose(f32(a), f32(b), atol=ATOL, rtol=RTOL,
                               err_msg=what)


def t_of(a) -> torch.Tensor:
    return params_from_jax({"x": np.asarray(a)})["x"]


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
    return jcfg, tcfg, jp, tp, toks.astype(np.int32)


def test_mla_config_matches():
    j, t = jget(ARCH), tget(ARCH)
    assert j == dataclass_copy(t, type(j))
    assert j.reduced() == dataclass_copy(t.reduced(), type(j))
    assert j.param_count() == t.param_count()
    assert (t.num_layers, t.d_model, t.num_heads, t.vocab_size,
            t.mla.kv_lora_rank, t.mla.qk_rope_head_dim) == (62, 2560, 40, 73448,
                                                             256, 32)


def dataclass_copy(cfg, jtype):
    """The port's config rebuilt as the JAX package's dataclasses."""
    import dataclasses
    from repro.configs import base as jb
    kw = dataclasses.asdict(cfg)
    kw["mla"] = jb.MLAConfig(**kw["mla"]) if kw["mla"] else None
    return jtype(**kw)


def test_params_from_jax_carries_the_mla_tree(models):
    jcfg, tcfg, jp, tp, _ = models
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = TR.flatten_with_path(tp)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        ["".join(f"[{k!r}]" for k in p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                      b.view(torch.int16).numpy().view(np.uint16),
                                      err_msg=str(p))
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ml = TR.flatten_with_path(mine)[0]
    assert [p for p, _ in ml] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, ml):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.bfloat16, p
        sa, sb = float(np.std(f32(a))), float(b.float().std())
        assert abs(sa - sb) <= 0.15 * max(sa, 1e-3), (p, sa, sb)


def test_mla_init_cache_matches():
    jcfg, tcfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    jc, tc = JK.init_cache(jcfg, 3, 7), TK.init_cache(tcfg, 3, 7, device="cpu")
    assert {k: tuple(v.shape) for k, v in jc.items()} == \
        {k: tuple(v.shape) for k, v in tc.items()}
    assert JK.cache_bytes(jc) == TK.cache_bytes(tc)
    for arch in ("mamba2-2.7b", "recurrentgemma-9b", "hubert-xlarge"):
        with pytest.raises(NotImplementedError, match="GQA and MLA"):
            TK.require_dense(jget(arch))
    # a vision frontend decodes text tokens over a dense GQA cache
    TK.require_dense(jget("pixtral-12b"))


def test_mla_prefill_and_decode_match_jax(models):
    jcfg, tcfg, jp, tp, toks = models
    jl, js = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :10])}, jcfg,
                        max_seq=MAX_SEQ)
    tl, ts = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :10])}, tcfg,
                        max_seq=MAX_SEQ)
    assert sorted(ts.cache) == ["ckv", "krope"]
    for k in js.cache:
        assert tuple(js.cache[k].shape) == tuple(ts.cache[k].shape)
        close(js.cache[k], ts.cache[k], f"prefill cache {k}")
        assert not ts.cache[k][:, :, 10:].any()
    close(jl, tl, "prefill logits")
    for i in range(10, 14):
        jl, js = JM.decode_step(jp, jnp.asarray(toks[:, i:i + 1]), js, jcfg)
        tl, ts = TM.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]), ts, tcfg)
        close(jl, tl, f"decode logits at {i}")
    for k in js.cache:
        close(js.cache[k], ts.cache[k], f"decoded cache {k}")


@pytest.mark.parametrize("arch,seed,prompt,max_seq,page_bytes", [
    ("smollm-135m", 0, 20, 64, 2048),
    ("minicpm3-4b", 1, 130, 256, 4096),
    ("qwen3-moe-30b-a3b", 2, 20, 64, 2048),
])
def test_resident_decode_step_matches_jax(arch, seed, prompt, max_seq, page_bytes):
    """Two resident steps from pools over the same cache bits: one full
    page per row is attended by the kernel, the rest by the tail merge."""
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, prompt)).astype(np.int32)
    _, jst = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, max_seq=max_seq)
    flat = np.concatenate([np.asarray(jax.lax.bitcast_convert_type(
        v, jnp.uint16)).ravel() for v in jst.cache.values()])
    jbook = jcb.calibrate(flat, k=16, fmt="bf16")
    tbook = tcb.Codebook(fmt="bf16", exponents=tuple(jbook.exponents))
    tcache = {k: t_of(v) for k, v in jst.cache.items()}
    jpool = JP.KVPool.for_cache(jst.cache, jbook,
                                resolve_backend("xla", require_jittable=True),
                                chunk=CHUNK, page_bytes=page_bytes)
    tpool = TP.KVPool.for_cache(tcache, tbook, get_backend("torch"),
                                chunk=CHUNK, page_bytes=page_bytes)
    jcomp, _ = jencode(JPlan.build(jst.cache, JTC(codebook=jbook, chunk=CHUNK)),
                       jst.cache)
    tcomp, _ = tencode(TPlan.build(tcache, TTC(codebook=tbook, chunk=CHUNK,
                                               backend="torch")), tcache)
    lens = np.full((B,), prompt, np.int32)
    js = jpool.admit_from_wire(jcomp, jnp.asarray(lens))
    ts = tpool.admit_from_wire(tcomp, torch.from_numpy(lens))
    assert prompt // jpool.geom.tokens_per_page >= 1      # the kernel has work
    before = SA.paged_gqa_attention.launches + SA.paged_mla_attention.launches
    for step in range(2):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, js = JM.resident_decode_step(jp, jnp.asarray(tok), js, jcfg,
                                         interpret=True)
        tl, ts = TM.resident_decode_step(tparams, torch.from_numpy(tok), ts, tcfg)
        close(jl, tl, f"resident logits at step {step}")
        for k in js.leaves:
            close(js.leaves[k].tail, ts.leaves[k].tail, f"tail {k}")
    np.testing.assert_array_equal(np.asarray(js.cache_len), ts.cache_len.numpy())
    # plain versions on the CPU: the kernel counters do not move
    assert SA.paged_gqa_attention.launches + SA.paged_mla_attention.launches == before


def test_launcher_serves_mla_on_cpu(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--new-tokens", "3", "--prompt-len", "12", "--n-chunks", "2"])
    assert res.tokens.shape == (2, 4)
    assert sorted(res.delivered.cache) == ["ckv", "krope"]
    assert "transfer ratio" in capsys.readouterr().out
