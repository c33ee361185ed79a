"""Parity of the port's codebook and reference codec with the JAX package.

Same bits in, same streams out: every ``CompressedTensor`` field must match
``repro.core.codec.encode`` BITWISE (dtype, shape and value) for bf16,
fp8_e5m2 and fp8_e4m3, on special values, on overflowing chunks
(``ok=False`` with the true count above ``cap``) and in both layouts.
Inputs come from numpy with fixed seeds.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import codebook as jcb  # noqa: E402
from repro.core import codec as JC  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import codec as TC  # noqa: E402
from repro_torch.kernels import cases as K  # noqa: E402

NP_FLOAT = {"bf16": jnp.bfloat16, "fp8_e5m2": jnp.float8_e5m2,
            "fp8_e4m3": jnp.float8_e4m3fn}
TORCH_FLOAT = {"bf16": torch.bfloat16, "fp8_e5m2": torch.float8_e5m2,
               "fp8_e4m3": torch.float8_e4m3fn}


def to_torch_bits(bits: np.ndarray) -> torch.Tensor:
    if bits.dtype == np.uint16:
        return torch.from_numpy(bits.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(bits)


def both(bits: np.ndarray, fmt: str):
    """The same bits as a JAX float array and a torch float tensor."""
    jx = jax.lax.bitcast_convert_type(jnp.asarray(bits), NP_FLOAT[fmt])
    tx = to_torch_bits(bits).view(TORCH_FLOAT[fmt])
    return jx, tx


def tnp(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def assert_streams_equal(jct, tct):
    names = ("sign_mantissa", "packed", "esc_pos", "esc_val", "esc_count", "ok")
    for name, a, b in zip(names, jax.tree.leaves(jct), tct.tensors()):
        a, b = np.asarray(a), tnp(b)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)
    for f in ("shape", "dtype", "fmt", "exponents", "chunk", "cap", "layout"):
        assert getattr(jct, f) == getattr(tct, f), f


def tcb_of(cb):
    return tcb.Codebook.from_json(cb.to_json())


# ---------------------------------------------------------------------------
# codebook
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["bf16", "fp8_e5m2", "fp8_e4m3"])
def test_calibration_and_tables_match(fmt):
    rng = np.random.default_rng(3)
    npd = jcb.FORMATS[fmt]["npdtype"]
    bits = [rng.integers(0, np.iinfo(npd).max + 1, 5000).astype(npd),
            (rng.standard_normal(3000) * 40).astype(np.int64).astype(npd)]
    j = jcb.calibrate(bits, k=16, fmt=fmt)
    t = tcb.calibrate(bits, k=16, fmt=fmt)
    assert j.exponents == t.exponents and j.fmt == t.fmt
    for table in ("encode_table", "member_table", "decode_table"):
        np.testing.assert_array_equal(getattr(j, table)(), getattr(t, table)())
    assert t.to_json() == j.to_json()
    assert jcb.Codebook.from_json(t.to_json()) == j
    assert tcb.Codebook.from_json(j.to_json()) == t
    hist = jcb.exponent_histogram(bits[0], fmt)
    assert (jcb.codebook_from_histogram(hist, k=8, fmt=fmt).exponents
            == tcb.codebook_from_histogram(hist, k=8, fmt=fmt).exponents)
    per_j = jcb.calibrate_per_axis(bits[0].reshape(50, 100), axis=0, k=4, fmt=fmt)
    per_t = tcb.calibrate_per_axis(bits[0].reshape(50, 100), axis=0, k=4, fmt=fmt)
    assert [c.exponents for c in per_j] == [c.exponents for c in per_t]


def test_field_split_and_join_match():
    rng = np.random.default_rng(4)
    for fmt in ("bf16", "fp8_e5m2", "fp8_e4m3"):
        npd = jcb.FORMATS[fmt]["npdtype"]
        bits = rng.integers(0, np.iinfo(npd).max + 1, 4096).astype(npd)
        je, ja = JC.split_fields(jnp.asarray(bits), fmt)
        te, ta = TC.split_fields(to_torch_bits(bits), fmt)
        np.testing.assert_array_equal(np.asarray(je), tnp(te))
        np.testing.assert_array_equal(np.asarray(ja), tnp(ta))
        np.testing.assert_array_equal(np.asarray(JC.join_fields(je, ja, fmt)),
                                      tnp(TC.join_fields(te, ta, fmt)))
        np.testing.assert_array_equal(tnp(TC.join_fields(te, ta, fmt)), bits)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

CASES = [(fmt, name, cap) for fmt in ("bf16", "fp8_e5m2", "fp8_e4m3")
         for name, _, cap in K.kernel_cases(fmt)
         if name in ("specials_ragged", "random_bits", "all_escape_cap64",
                     "count65_cap64", "count1_cap1")]


@pytest.mark.parametrize("layout", ["chunked", "global"])
@pytest.mark.parametrize("fmt,name,cap", CASES)
def test_encode_streams_bitwise(fmt, name, cap, layout):
    bits = dict((n, b) for n, b, _ in K.kernel_cases(fmt))[name]
    jcbk = K.CODEBOOKS[fmt]
    jbook = jcb.Codebook(fmt=fmt, exponents=jcbk.exponents)
    jx, tx = both(bits, fmt)
    gcap = JC.DEFAULT_CAP if layout == "global" else cap
    jct = JC.encode(jx, jbook, cap=gcap, layout=layout)
    tct = TC.encode(tx, jcbk, cap=gcap, layout=layout)
    assert_streams_equal(jct, tct)
    assert float(JC.compressed_bytes(jct)) == TC.compressed_bytes(tct)
    assert JC.static_stream_bytes(jct) == TC.static_stream_bytes(tct)
    assert JC.raw_bytes(jct) == TC.raw_bytes(tct)
    if bool(tct.ok):
        np.testing.assert_array_equal(tnp(TC.to_bits(TC.decode(tct), fmt)), bits)
        np.testing.assert_array_equal(
            np.asarray(JC.decode_to_bits(jct)), tnp(TC.decode_to_bits(tct)))


def test_overflow_keeps_true_count():
    bits = K._row_with_escapes(K.CODEBOOKS["bf16"], 100, 1024,
                               np.random.default_rng(0))
    _, tx = both(bits, "bf16")
    tct = TC.encode(tx, K.CODEBOOKS["bf16"], cap=64)
    assert not bool(tct.ok)
    assert int(tct.esc_count[0]) == 100
    assert (tnp(tct.esc_pos) < 1024).all()          # all 64 slots filled


def test_pad_value_is_top_exponent():
    cb = tcb.Codebook(fmt="bf16", exponents=(127, 126, 0))
    flat = torch.zeros(10, dtype=torch.int16).view(torch.uint16)
    padded = TC._pad_to_chunk(flat, 16, TC.pad_bits_for(cb))
    assert padded.shape == (16,)
    assert (tnp(padded)[10:] == 127 << 7).all()
    j = JC._pad_to_chunk(jnp.zeros(10, jnp.uint16), 16, jnp.uint16(127 << 7))
    np.testing.assert_array_equal(np.asarray(j), tnp(padded))


def test_global_compaction_matches():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 65536, 8 * 1024).astype(np.uint16)
    cb = K.CODEBOOKS["bf16"]
    je, _ = JC.split_fields(jnp.asarray(bits), "bf16")
    _, jm = JC.assign_codes(je, cb.exponents)
    te, _ = TC.split_fields(to_torch_bits(bits), "bf16")
    _, tm = TC.assign_codes(te, cb.exponents)
    for total_cap in (128, 4096, 8192):
        for a, b in zip(JC.collect_escapes_global(je, jm, total_cap),
                        TC.collect_escapes_global(te, tm, total_cap)):
            np.testing.assert_array_equal(np.asarray(a), tnp(b))
        jp, jv, jc, _ = JC.collect_escapes(je, jm, 1024, 128)
        tp, tv, tcnt, _ = TC.collect_escapes(te, tm, 1024, 128)
        for a, b in zip(JC.compact_chunked_to_global(jp, jv, jc, 1024, total_cap, 8192),
                        TC.compact_chunked_to_global(tp, tv, tcnt, 1024, total_cap, 8192)):
            np.testing.assert_array_equal(np.asarray(a), tnp(b))
    assert JC.default_global_cap(123457) == TC.default_global_cap(123457)
