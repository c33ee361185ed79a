"""The port's transfer plan and session against the JAX package's.

Same cache bits in: the plan must route every leaf the same way
(``describe()`` identical up to the backend's name), and
``TransferSession.transfer`` on the port's ``cuda`` backend (its plain
versions, on the CPU) must deliver bitwise the same cache as the JAX session
on ``backend="pallas"``, with equal wire bytes, per-chunk wire bytes, per-leaf
accounting and capacity-schedule retry counts: whole-tensor and chunked
(n_chunks 1/3/8), with a heavy-tailed chunk that walks the schedule to the
``global`` layout.  Inputs come from numpy with fixed seeds.
"""

import types

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import backend as JB  # noqa: E402
from repro.core import codebook as jcb  # noqa: E402
from repro.core import pipeline as JP  # noqa: E402
from repro.serving import plan as JPL  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import backend as TB  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core import pipeline as TP  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.serving import plan as TPL  # noqa: E402
from repro_torch.serving.engine import DisaggregatedEngine  # noqa: E402

NAMES = {"pallas": "cuda", "xla": "torch"}


def bf16_bits(rng, shape):
    return rng.standard_normal(shape).astype(jnp.bfloat16).view(np.uint16)


def make_caches(heavy: bool = True, seed: int = 0):
    """One cache as a JAX pytree and as the port's dict, from the same bits:
    two bf16 KV leaves (inserted out of sorted order), an fp32 leaf, a
    float8 leaf and a small int leaf.  ``heavy`` puts a run of +-Inf/NaN
    exponents into ``v``: that chunk overflows every per-chunk capacity."""
    rng = np.random.default_rng(seed)
    kb = bf16_bits(rng, (2, 2, 40, 2, 16))
    vb = bf16_bits(rng, (2, 2, 40, 2, 16))
    if heavy:
        vb.reshape(-1)[:300] = 0x7F80 + (np.arange(300) % 100)
    f32 = rng.standard_normal((3, 50)).astype(np.float32)
    f8 = rng.integers(0, 256, 700).astype(np.uint8)
    ids = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    jc = {"v": jnp.asarray(vb).view(jnp.bfloat16),
          "k": jnp.asarray(kb).view(jnp.bfloat16), "f": jnp.asarray(f32),
          "e": jnp.asarray(f8).view(jnp.float8_e5m2),
          "meta": {"ids": jnp.asarray(ids)}}
    tc = {"v": torch.from_numpy(vb.view(np.int16)).view(torch.bfloat16),
          "k": torch.from_numpy(kb.view(np.int16)).view(torch.bfloat16),
          "f": torch.from_numpy(f32),
          "e": torch.from_numpy(f8).view(torch.float8_e5m2),
          "meta": {"ids": torch.from_numpy(ids)}}
    cb = jcb.calibrate([kb], k=16)
    return jc, tc, cb, tcb.Codebook.from_json(cb.to_json())


def raw_bytes_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.asarray(x).view(np.uint8).reshape(-1)


def assert_same_cache(jtree, ttree):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = TR.flatten_with_path(ttree)[0]
    assert [JPL.leaf_key(p) for p, _ in jl] == [TR.leaf_key(p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert str(np.asarray(a).dtype) == C.dtype_name(b.dtype), p
        np.testing.assert_array_equal(raw_bytes_of(a), raw_bytes_of(b),
                                      err_msg=str(p))


def assert_same_stats(sj, st):
    assert sj.wire_bytes == st.wire_bytes
    assert sj.chunk_wire_bytes == st.chunk_wire_bytes
    assert sj.chunk_ok == st.chunk_ok
    assert sj.chunk_retried == st.chunk_retried
    assert sj.chunk_retry_steps == st.chunk_retry_steps
    assert sj.leaf_wire_bytes == st.leaf_wire_bytes
    assert sj.leaf_ok == st.leaf_ok
    assert sj.raw_passthrough_bytes == st.raw_passthrough_bytes
    assert sj.fp32_lo_wire_bytes == st.fp32_lo_wire_bytes
    assert sj.fp8_wire_bytes == st.fp8_wire_bytes
    assert sj.n_elements == st.n_elements


def plans(jc, tc, cb, tcb_, backend="pallas", **kw):
    jp = JPL.TransferPlan.build(jc, JPL.TransferConfig(codebook=cb,
                                                       backend=backend, **kw))
    tp = TPL.TransferPlan.build(tc, TPL.TransferConfig(
        codebook=tcb_, backend=NAMES[backend], **kw))
    return jp, tp


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

PLAN_CONFIGS = [
    dict(), dict(n_chunks=3), dict(n_chunks=8, cap=8),
    dict(compress_fp32=True, n_chunks=4), dict(layout="global"),
    dict(min_compress_elems=1000), dict(enabled=False, n_chunks=2),
]


@pytest.mark.parametrize("kw", PLAN_CONFIGS, ids=lambda kw: str(sorted(kw.items())))
def test_plan_routes_and_describe_match(kw):
    jc, tc, cb, tcb_ = make_caches()
    jp, tp = plans(jc, tc, cb, tcb_, **kw)
    assert tp.describe() == jp.describe().replace("backend=pallas",
                                                  "backend=cuda")
    assert [(r.key, r.shape, r.dtype, r.route, r.cap) for r in jp.routes] == \
        [(r.key, r.shape, r.dtype, r.route, r.cap) for r in tp.routes]
    assert [(s.start, s.stop, s.cap) for s in jp.segments] == \
        [(s.start, s.stop, s.cap) for s in tp.segments]
    assert (jp.stream_len, jp.granularity, jp.raw_bytes()) == \
        (tp.stream_len, tp.granularity, tp.raw_bytes())
    assert tp.matches(tc) and not tp.matches({"k": tc["k"]})


def test_fold_stream_matches():
    jc, tc, cb, tcb_ = make_caches()
    jp, tp = plans(jc, tc, cb, tcb_, compress_fp32=True, n_chunks=2)
    js, jlo, _, _ = jp.fold_stream(jc)
    ts, tlo, _, _ = tp.fold_stream(tc)
    np.testing.assert_array_equal(np.asarray(js), raw_bytes_of(ts).view(np.uint16))
    for k in jlo:
        np.testing.assert_array_equal(np.asarray(jlo[k]),
                                      raw_bytes_of(tlo[k]).view(np.uint16))
    out = tp.unfold_stream(ts, tlo, {"e": tc["e"]}, {"meta/ids": tc["meta"]["ids"]})
    assert_same_cache(jc, out)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_capacity_schedule_matches(backend):
    jbe, tbe = JB.get_backend(backend), TB.get_backend(NAMES[backend])
    for layout, cap, n, doublings in (("chunked", 64, 10 ** 6, 2),
                                      ("chunked", 8, 4096, 2),
                                      ("global", 512, 50_000, 1),
                                      ("chunked", 64, 4096, 0)):
        js = jbe.capacity_schedule(layout, cap, n, doublings=doublings)
        ts = tbe.capacity_schedule(layout, cap, n, doublings=doublings)
        assert [(NAMES[b.name], getattr(b, "fused", None), lay, c)
                for b, lay, c in js] == \
            [(b.name, getattr(b, "fused", None), lay, c) for b, lay, c in ts]
    assert TB.get_backend("auto").name == "cuda"
    assert not TB.get_backend("cuda").for_retry("global").fused


def test_chunk_schedule_and_pipeline_model_match():
    for n in (1, 2, 5):
        assert JP.ChunkSchedule(n).stages() == TP.ChunkSchedule(n).stages()
    kw = dict(g_enc=600e9, g_dec=2000e9, ratio=1.33, link_bw=50e9,
              fixed_overhead_s=1e-5)
    jprof, tprof = JP.CodecProfile(**kw), TP.CodecProfile(**kw)
    for s in (1e6, 3e8):
        assert JP.additive_transfer_time(s, jprof) == TP.additive_transfer_time(s, tprof)
        assert JP.pipelined_transfer_time(s, jprof, 8) == \
            TP.pipelined_transfer_time(s, tprof, 8)
        assert JP.speedup(s, jprof, True, 4) == TP.speedup(s, tprof, True, 4)
    assert JP.pipeline_makespan([1e6, 2e6, 5e5], jprof) == \
        TP.pipeline_makespan([1e6, 2e6, 5e5], tprof)


# ---------------------------------------------------------------------------
# session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_session_transfer_matches_pallas(n_chunks):
    """Bitwise delivery and equal accounting, including the heavy-tailed
    chunk's walk down the capacity schedule (cap 8 -> 16 -> 32 -> global)."""
    jc, tc, cb, tcb_ = make_caches(heavy=True)
    jp, tp = plans(jc, tc, cb, tcb_, n_chunks=n_chunks, cap=8,
                   compress_fp32=True)
    js, ts = jp.session(), tp.session()
    jo, to = js.transfer(jc), ts.transfer(tc)
    assert_same_cache(jc, to)
    assert_same_cache(jo, to)
    assert_same_stats(js.last_stats, ts.last_stats)
    st = ts.last_stats
    assert 3 in st.chunk_retry_steps       # the heavy unit reached 'global'
    assert all(st.chunk_ok) and st.leaf_ok.get("v", True)
    assert ts.last_stats.wire_bytes < tp.raw_bytes()


def test_exhausted_schedule_ships_raw_like_pallas():
    """With retries off the overflowing unit falls back to its raw bits."""
    jc, tc, cb, tcb_ = make_caches(heavy=True, seed=1)
    for n_chunks in (1, 2):
        jp, tp = plans(jc, tc, cb, tcb_, n_chunks=n_chunks, cap=8,
                       retry_doublings=0)
        js, ts = jp.session(), tp.session()
        jo, to = js.transfer(jc), ts.transfer(tc)
        assert_same_cache(jo, to)
        assert_same_stats(js.last_stats, ts.last_stats)
        assert not ts.last_stats.all_ok


def test_send_recv_and_transfer_compressed():
    jc, tc, cb, tcb_ = make_caches(heavy=False, seed=2)
    for n_chunks in (1, 4):
        _, tp = plans(jc, tc, cb, tcb_, n_chunks=n_chunks)
        sess = tp.session()
        sess.send(tc)
        with pytest.raises(RuntimeError):
            sess.send(tc)
        assert_same_cache(jc, sess.recv())
        first = sess.last_stats.wire_bytes
        assert_same_cache(jc, sess.transfer(tc))
        assert sess.calls == 2 and sess.total_wire_bytes == 2 * first
        with pytest.raises(ValueError, match="structure"):
            sess.transfer({"k": tc["k"]})
    jp, tp = plans(jc, tc, cb, tcb_, backend="xla")
    jcomp, jraw = jp.session().transfer_compressed(jc)
    tcomp, traw = tp.session().transfer_compressed(tc)
    assert sorted(jcomp) == sorted(tcomp) and sorted(jraw) == sorted(traw)
    for key in jcomp:
        for a, b in zip(jax.tree.leaves(jcomp[key]), tcomp[key].tensors()):
            np.testing.assert_array_equal(np.asarray(a).view(np.uint8).reshape(-1),
                                          raw_bytes_of(b))


def test_unported_session_features_raise():
    jc, tc, cb, tcb_ = make_caches(heavy=False)
    _, tp = plans(jc, tc, cb, tcb_)
    sess = tp.session()
    # every executor is ported: the collectives refuse a local plan, and a
    # mesh needs a 'pod' dimension
    with pytest.raises(ValueError, match="needs a mesh plan with a 'pod'"):
        sess.ring_reduce(tc)
    with pytest.raises(ValueError, match="structure"):
        sess.reshard({"k": tc["k"]}, None)
    for name in ("save", "load"):
        assert callable(getattr(sess, name))
    no_pod = types.SimpleNamespace(mesh_dim_names=("data",),
                                   mesh=torch.zeros(1))
    with pytest.raises(ValueError, match="'pod' mesh axis"):
        TPL.TransferPlan.build(tc, tp.tc, mesh=no_pod)
    # compressed residency is ported: the engine builds, and refuses the
    # chunked streams its pool cannot page, as the JAX engine does
    cfg = get_config("smollm-135m").reduced()
    assert DisaggregatedEngine(cfg, {}, tcb_, resident="compressed",
                               device="cpu").resident == "compressed"
    with pytest.raises(ValueError, match="n_chunks=1"):
        DisaggregatedEngine(cfg, {}, tcb_, resident="compressed", n_chunks=2,
                            device="cpu")
