"""The port's fp8 module and codec variants against the JAX package's.

Same bits in (numpy from fixed seeds), both packages:

* ``fp8.*``: the recommended settings, the size model and calibration,
  equal;
* the top-15 + sentinel variant: streams, ``sentinel_bytes`` and the decode
  bitwise, also with more escapes in a chunk than ``cap`` (the decode then
  clips the rank to ``cap - 1`` in both, and is not the input);
* the dynamic-codebook variant: the per-call top-k equal under tied
  histogram counts (the lower exponent first, as ``jax.lax.top_k``), its
  streams and decode bitwise;
* ``theoretical_ratio`` / ``compression_ratio`` / ``roundtrip_ok`` equal;
* the transfer plan's ``fp8`` route with codebooks from ``calibrate_fp8``
  at k 8 and k 16, e5m2 and e4m3: delivery bitwise and equal accounting
  between the JAX session (``pallas``) and the port's (``cuda``, its plain
  versions on the CPU).
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import codebook as jcb  # noqa: E402
from repro.core import codec as JC  # noqa: E402
from repro.core import fp8 as JF  # noqa: E402
from repro.serving import plan as JPL  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core import fp8 as TF  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.serving import plan as TPL  # noqa: E402

#: numpy container dtype, JAX dtype and torch dtype of each format
FMTS = {
    "bf16": (np.uint16, jnp.bfloat16, torch.bfloat16),
    "fp8_e5m2": (np.uint8, jnp.float8_e5m2, torch.float8_e5m2),
    "fp8_e4m3": (np.uint8, jnp.float8_e4m3fn, torch.float8_e4m3fn),
}


def as_jax(bits: np.ndarray, fmt: str):
    return jnp.asarray(bits).view(FMTS[fmt][1])


def as_torch(bits: np.ndarray, fmt: str) -> torch.Tensor:
    if bits.dtype == np.uint16:
        return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(bits.copy()).view(FMTS[fmt][2])


def raw_bytes_of(x) -> np.ndarray:
    """Any stream or tensor (JAX or torch) as its bytes."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def same_stream(a, b, what=""):
    assert tuple(np.shape(a)) == tuple(b.shape), what
    np.testing.assert_array_equal(raw_bytes_of(a), raw_bytes_of(b), err_msg=what)


def normal_bits(fmt: str, n: int, seed: int) -> np.ndarray:
    """Seeded normal values in ``fmt``, as container bits."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(FMTS[fmt][1])).view(FMTS[fmt][0])


def books(fmt: str, bits: np.ndarray, k: int):
    jb = jcb.calibrate([bits], k=k, fmt=fmt)
    return jb, tcb.Codebook.from_json(jb.to_json())


def with_escapes(fmt: str, bits: np.ndarray, cb, per_chunk: int,
                 chunk: int = 1024) -> np.ndarray:
    """``bits`` with ``per_chunk`` elements of every chunk moved to
    exponents outside ``cb`` (cycling through all of them)."""
    s = tcb.FORMATS[fmt]
    out = bits.copy()
    escs = np.array([e for e in range(1 << s["ebits"]) if e not in cb.exponents],
                    np.uint32)
    for start in range(0, out.size, chunk):
        pos = start + np.arange(0, min(chunk, out.size - start), 7)[:per_chunk]
        esc = escs[np.arange(pos.size) % escs.size]         # varying values
        keep = out[pos].astype(np.uint32) & (((1 << s["bits"]) - 1)
                                             ^ (((1 << s["ebits"]) - 1) << s["mbits"]))
        out[pos] = (keep | (esc << s["mbits"])).astype(out.dtype)
    return out


# ---------------------------------------------------------------------------
# fp8 module
# ---------------------------------------------------------------------------

def test_fp8_settings_and_size_model_match():
    assert TF.RECOMMENDED == JF.RECOMMENDED
    assert [(v.fmt, v.k, v.code_bits) for v in TF.VARIANTS] == \
        [(v.fmt, v.k, v.code_bits) for v in JF.VARIANTS]
    for fmt in FMTS:
        assert TF.recommended_k(fmt) == JF.recommended_k(fmt)
        for k in (4, 8, 15, 16, 32):
            assert TF.Fp8Variant(fmt, k).code_bits == JF.Fp8Variant(fmt, k).code_bits
            for eps in (0.0, 0.0016, 0.05):
                assert TF.ratio_vs_native(fmt, k, eps) == JF.ratio_vs_native(fmt, k, eps)
                assert TF.ratio_vs_bf16(fmt, k, eps) == JF.ratio_vs_bf16(fmt, k, eps)
                assert C.theoretical_ratio(fmt, k, eps) == \
                    JC.theoretical_ratio(fmt, k, eps)
    # the paper's Appendix B figure: top-16 E5M2 without escapes is 8/7
    assert TF.ratio_vs_native("fp8_e5m2", 16, 0.0) == pytest.approx(8 / 7)


@pytest.mark.parametrize("fmt,k", [("fp8_e5m2", None), ("fp8_e5m2", 8),
                                   ("fp8_e4m3", None), ("fp8_e4m3", 16)])
def test_calibrate_fp8_matches(fmt, k):
    bits = [normal_bits(fmt, 3000, seed) for seed in (1, 2)]
    jb, tb = JF.calibrate_fp8(bits, fmt, k), TF.calibrate_fp8(bits, fmt, k)
    assert (tb.fmt, tb.exponents) == (jb.fmt, jb.exponents)
    assert tb.k == (k or TF.recommended_k(fmt))


# ---------------------------------------------------------------------------
# top-15 + sentinel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["bf16", "fp8_e5m2"])
@pytest.mark.parametrize("per_chunk,cap", [(0, 64), (5, 64), (40, 16)])
def test_sentinel_streams_and_decode_match(fmt, per_chunk, cap):
    bits = normal_bits(fmt, 5000, seed=3)            # a ragged last chunk
    jb, tb = books(fmt, bits, 16)
    bits = with_escapes(fmt, bits, tb, per_chunk)
    shape = (10, 500)
    jx, tx = as_jax(bits, fmt).reshape(shape), as_torch(bits, fmt).reshape(shape)
    jct, tct = JC.encode_sentinel(jx, jb, cap=cap), C.encode_sentinel(tx, tb, cap=cap)
    for f in ("sign_mantissa", "packed", "esc_val", "esc_count", "ok"):
        same_stream(getattr(jct, f), getattr(tct, f), f)
    assert (tct.exponents, tct.cap, tct.chunk, tct.shape) == \
        (jct.exponents, jct.cap, jct.chunk, jct.shape)
    assert C.sentinel_bytes(tct) == float(JC.sentinel_bytes(jct))
    jd, td = JC.decode_sentinel(jct), C.decode_sentinel(tct)
    same_stream(jd, td, "decode")
    # past cap the rank is clipped: the decode is not the input, in both
    assert C.bits_equal(td, tx) == (per_chunk <= cap)


# ---------------------------------------------------------------------------
# dynamic codebook
# ---------------------------------------------------------------------------

def tied_bits(fmt: str) -> np.ndarray:
    """Container bits whose exponent histogram ties in blocks: exponents
    taken in a shuffled order, each tie group sharing one count, so only
    the tie-break decides the top-k's order."""
    s = tcb.FORMATS[fmt]
    rng = np.random.default_rng(4)
    m = min(24, 1 << s["ebits"])                   # e4m3 has 16 exponents
    exps = rng.permutation(1 << s["ebits"])[:m]
    counts = np.repeat([90, 90, 90, 60, 60, 60, 60, 30], 3)[:m]
    e = np.repeat(exps, counts)
    mant = rng.integers(0, 1 << (s["mbits"] + 1), e.size)     # sign + mantissa
    bits = ((mant >> s["mbits"]) << (s["bits"] - 1)) | (e << s["mbits"]) \
        | (mant & ((1 << s["mbits"]) - 1))
    return rng.permutation(bits).astype(FMTS[fmt][0])


@pytest.mark.parametrize("fmt,k", [("bf16", 16), ("fp8_e5m2", 16),
                                   ("fp8_e5m2", 8), ("fp8_e4m3", 8)])
def test_dynamic_topk_breaks_ties_like_jax(fmt, k):
    bits = tied_bits(fmt)
    want = np.asarray(JC.dynamic_topk_exponents(jnp.asarray(bits), fmt, k))
    got = C.dynamic_topk_exponents(as_torch(bits, fmt), fmt, k)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt,k", [("bf16", 16), ("fp8_e5m2", 8)])
def test_dynamic_codebook_streams_and_decode_match(fmt, k):
    bits = tied_bits(fmt)
    shape = (bits.size,)
    jx, tx = as_jax(bits, fmt), as_torch(bits, fmt)
    (js, jcb_) = JC.encode_with_dynamic_codebook(jx, fmt, k, cap=128)
    (ts, tcb_) = C.encode_with_dynamic_codebook(tx, fmt, k, cap=128)
    np.testing.assert_array_equal(tcb_.numpy(), np.asarray(jcb_))
    for i, (a, b) in enumerate(zip(js, ts)):
        same_stream(a, b, f"stream {i}")
    jd = JC.decode_with_dynamic_codebook(js, jcb_, shape, FMTS[fmt][1], fmt)
    td = C.decode_with_dynamic_codebook(ts, tcb_, shape, FMTS[fmt][2], fmt)
    same_stream(jd, td, "decode")
    assert C.bits_equal(td, tx) == bool(ts[-1])


# ---------------------------------------------------------------------------
# ratios and the round-trip check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,k", [("bf16", 16), ("fp8_e5m2", 16), ("fp8_e4m3", 8)])
@pytest.mark.parametrize("cap", [64, 2])
def test_ratios_and_roundtrip_ok_match(fmt, k, cap):
    bits = normal_bits(fmt, 4096, seed=5)
    jb, tb = books(fmt, bits, k)
    bits = with_escapes(fmt, bits, tb, 3)
    jx, tx = as_jax(bits, fmt), as_torch(bits, fmt)
    jct, tct = JC.encode(jx, jb, cap=cap), C.encode(tx, tb, cap=cap)
    # the JAX package sums the bytes in float32, the port in float64
    assert C.compression_ratio(tct) == pytest.approx(
        float(JC.compression_ratio(jct)), rel=1e-6)
    assert bool(C.roundtrip_ok(tx, tct)) == bool(JC.roundtrip_ok(jx, jct)) \
        == (cap >= 3)


# ---------------------------------------------------------------------------
# the transfer plan's fp8 route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,k", [("fp8_e5m2", 16), ("fp8_e5m2", 8),
                                   ("fp8_e4m3", 8), ("fp8_e4m3", 16)])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_plan_fp8_route_matches_pallas(fmt, k, n_chunks):
    """A cache of two float8 leaves (one over a bf16 leaf), codebook from
    ``calibrate_fp8`` on the leaves themselves: the JAX session and the
    port's deliver the same bits at the same wire bytes."""
    kb = normal_bits(fmt, 2 * 3 * 40 * 16, seed=6).reshape(2, 3, 40, 16)
    vb = normal_bits(fmt, 2 * 3 * 40 * 16, seed=7).reshape(2, 3, 40, 16)
    hb = normal_bits("bf16", 4000, seed=8)
    jf, tf = JF.calibrate_fp8([kb, vb], fmt, k), TF.calibrate_fp8([kb, vb], fmt, k)
    assert tf.exponents == jf.exponents
    jbf, tbf = books("bf16", hb, 16)
    jc = {"k": as_jax(kb, fmt), "v": as_jax(vb, fmt), "h": as_jax(hb, "bf16")}
    tc = {"k": as_torch(kb, fmt), "v": as_torch(vb, fmt), "h": as_torch(hb, "bf16")}
    jp = JPL.TransferPlan.build(jc, JPL.TransferConfig(
        codebook=jbf, fp8_codebook=jf, backend="pallas", n_chunks=n_chunks))
    tp = TPL.TransferPlan.build(tc, TPL.TransferConfig(
        codebook=tbf, fp8_codebook=tf, backend="cuda", n_chunks=n_chunks))
    assert [r.route for r in tp.routes] == [r.route for r in jp.routes] == \
        ["splitzip", "fp8", "fp8"]
    js, ts = jp.session(), tp.session()
    jo, to = js.transfer(jc), ts.transfer(tc)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jo)[0],
                              TR.flatten_with_path(to)[0]):
        same_stream(a, b, str(p))
    for key, bits in (("k", kb), ("v", vb)):
        same_stream(bits, to[key], key)
    sj, st = js.last_stats, ts.last_stats
    assert (st.wire_bytes, st.fp8_wire_bytes, st.leaf_wire_bytes) == \
        (sj.wire_bytes, sj.fp8_wire_bytes, sj.leaf_wire_bytes)
    # a 4-bit code for a 4-bit exponent saves nothing: e4m3 at k 16 is 1.0x
    assert st.all_ok and (st.fp8_wire_bytes < kb.size + vb.size
                          or (fmt, k) == ("fp8_e4m3", 16))
