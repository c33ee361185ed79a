"""The port's prefill flash attention against the JAX package's.

On the CPU ``flash_attention`` runs its plain version,
``flash_attention_ref``, which must match the JAX package's Pallas kernel
run with ``interpret=True`` on the same inputs (numpy from a seed), with the
same 64-row blocks: f32 within the JAX test's own 2e-5 (both sides sum in
f32, in another order), bf16 within one bf16 ulp (the f32 values agree to
about 1e-6 and are each rounded once), scores scaled x30 within the JAX
test's own 2e-3.  Interpret mode is slow, so the sequences stay at 128 or
less.  The plain version must also agree with the port's
``chunked_attention`` (which rounds ``p`` to bf16) within 3e-2, the bound
the JAX package holds its own two implementations to.

The ``cuda`` test holds the CUDA kernel against its plain version on every
seeded edge case of ``kernels/attention_cases.py`` and skips here.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import attention_cases as AC
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L

#: the edge-case kinds, at sizes the interpreter runs quickly
JAX_CASES = ("mha_causal_f32", "mha_full_bf16", "gqa3_ragged_bf16",
             "gqa3_ragged_f32", "gqa8_d128_bf16", "mla_96_64_bf16",
             "cross_kv_longer_f32", "single_query_bf16", "scores_x30_f32")


@pytest.fixture(scope="module")
def jfa():
    """The JAX package's flash-attention module (Pallas, interpret mode)."""
    pytest.importorskip("jax")
    from repro.kernels import flash_attention
    return flash_attention


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def case_by_name(name, seed=0):
    i = [row[0] for row in AC.FLASH_EDGE].index(name)
    return AC.flash_case(*AC.FLASH_EDGE[i], seed=seed + i)


def to_jax(t: torch.Tensor):
    import jax.numpy as jnp
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("name", JAX_CASES)
def test_ref_matches_jax_flash_attention(jfa, name):
    c = case_by_name(name)
    want = jfa.flash_attention(to_jax(c["q"]), to_jax(c["k"]), to_jax(c["v"]),
                               causal=c["causal"], blk_q=64, blk_k=64,
                               interpret=True)
    got = FA.flash_attention_ref(c["q"], c["k"], c["v"], causal=c["causal"],
                                 blk_k=64)
    assert got.dtype == c["q"].dtype and tuple(got.shape) == tuple(want.shape)
    atol, rtol = c["tol"]
    np.testing.assert_allclose(f32(got), f32(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("blk_k", [64, 512])
def test_ref_blocks_do_not_change_the_function(blk_k):
    """The plain version's KV block is a loop length, not a semantics: f32
    results agree across block sizes within f32 rounding."""
    c = case_by_name("gqa8_d128_f32")
    a = FA.flash_attention_ref(c["q"], c["k"], c["v"], causal=True, blk_k=blk_k)
    b = FA.flash_attention_ref(c["q"], c["k"], c["v"], causal=True, blk_k=32)
    np.testing.assert_allclose(f32(a), f32(b), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", ["mha_causal_f32", "gqa3_ragged_bf16",
                                  "mla_96_64_bf16", "cross_kv_longer_f32"])
def test_ref_matches_chunked_attention(name):
    c = case_by_name(name)
    want = L.chunked_attention(c["q"], c["k"], c["v"], causal=c["causal"],
                               kv_block=64)
    got = FA.flash_attention_ref(c["q"], c["k"], c["v"], causal=c["causal"])
    tol = AC.FLASH_VS_CHUNKED
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def test_cpu_wrapper_runs_the_plain_version():
    before = FA.flash_attention.launches
    for c in AC.flash_cases(seed=3):
        got = FA.flash_attention(c["q"], c["k"], c["v"], causal=c["causal"])
        want = FA.flash_attention_ref(c["q"], c["k"], c["v"], causal=c["causal"])
        assert torch.equal(got, want), c["name"]
    assert FA.flash_attention.launches == before


def test_prefill_attention_on_cpu_is_chunked_attention():
    c = case_by_name("gqa3_ragged_bf16")
    got = L.prefill_attention(c["q"], c["k"], c["v"], causal=True)
    want = L.chunked_attention(c["q"], c["k"], c["v"], causal=True)
    assert torch.equal(got, want)
    # a sliding window stays available on the CPU
    L.prefill_attention(c["q"], c["k"], c["v"], causal=True, window=16)


def test_wrapper_rejects_bad_operands():
    c = case_by_name("mha_causal_f32")
    with pytest.raises(ValueError, match="multiple of Hkv"):
        FA.flash_attention(c["q"], c["k"][:, :, :3], c["v"][:, :, :3])
    with pytest.raises(TypeError, match="dtypes differ"):
        FA.flash_attention(c["q"], c["k"].bfloat16(), c["v"])
    with pytest.raises(ValueError, match="inconsistent shapes"):
        FA.flash_attention(c["q"], c["k"][:, :-1], c["v"])
    with pytest.raises(ValueError, match="expected all"):
        FA.flash_attention(c["q"], c["k"].to("meta"), c["v"])


@pytest.mark.parametrize("args", [
    (8, 2048, 2048, 9, 3, 64, 64), (4, 1000, 1000, 40, 40, 96, 64),
    (4, 2048, 2048, 32, 4, 128, 128), (1, 37, 150, 4, 2, 64, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_work_counts_match_jax(jfa, args, causal):
    b, sq, skv, h, hkv, d, dv = args
    assert FA.hbm_bytes(*args) == jfa.hbm_bytes(*args)
    assert FA.hbm_bytes(*args, bytes_per_el=4) == jfa.hbm_bytes(*args, bytes_per_el=4)
    assert FA.flops(b, sq, skv, h, d, dv, causal) == \
        jfa.flops(b, sq, skv, h, d, dv, causal)


def test_served_bounds():
    """The served prefill geometries' work: qwen3-moe-30b-a3b's is 137.4
    GFLOP a layer, bound by the operations at 989 TFLOP/s."""
    ops = FA.flops(4, 2048, 2048, 32, 128, 128)
    assert ops == 2.0 * 4 * 32 * 2048 * 2048 * 0.5 * 256
    assert abs(ops / 989e12 * 1e3 - 0.1390) < 1e-4
    assert FA.hbm_bytes(4, 2048, 2048, 32, 4, 128, 128) / 3.35e12 < ops / 989e12


# ---------------------------------------------------------------------------
# on a card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card(cuda_device):
    before = FA.flash_attention.launches
    for c in AC.flash_cases(seed=1):
        dev = [t.to(cuda_device) for t in (c["q"], c["k"], c["v"])]
        got = FA.flash_attention(*dev, causal=c["causal"])
        torch.cuda.synchronize()
        want = FA.flash_attention_ref(*dev, causal=c["causal"])
        AC.check_close(got, want, *c["tol"])
        again = FA.flash_attention(*dev, causal=c["causal"])
        assert torch.equal(got, again), f"{c['name']}: not deterministic"
    assert FA.flash_attention.launches == before + 2 * len(AC.FLASH_EDGE)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_operands(cuda_device):
    """A head slice of a wider tensor (the MLA ``v``) and an expanded head
    axis are read through their strides."""
    c = case_by_name("mla_96_64_bf16")
    q, k = (t.to(cuda_device) for t in (c["q"], c["k"]))
    wide = torch.randn(2, 77, 4, 160, device=cuda_device).to(torch.bfloat16)
    v = wide[..., 96:]
    got = FA.flash_attention(q, k, v)
    AC.check_close(got, FA.flash_attention_ref(q, k, v.contiguous()), 1e-3, 8e-3)
    k1 = k[:, :, :1].expand(-1, -1, 4, -1)
    got = FA.flash_attention(q, k1, v)
    AC.check_close(got, FA.flash_attention_ref(q, k1.contiguous(), v.contiguous()),
                   1e-3, 8e-3)
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention(q[..., :1].expand(-1, -1, -1, 300),
                           k[..., :1].expand(-1, -1, -1, 300), v)
