"""The port's prefix-delta transfer and failover re-send against the JAX
package's.

Every case of the JAX package's ``tests/test_prefix_delta.py``, run on both
packages over the same seeded numpy bits (the JAX ``xla`` backend against
the port's ``torch`` backend on the CPU): a cache that takes every route
(bf16 stream, fp32 hi/lo, an fp8 sidecar, raw ints), cold and warm turns,
NaN and -0.0 payloads, fault injection, LRU eviction, the engine's
``session_id`` path and ``scheduler_config``, and the scheduler's
``on_failover`` hook driving a real engine re-send.  Delivered caches are
compared bitwise and every ``TransferStats`` field for equality; under a
fault plan whose re-fetches can reach the capacity schedule's ``global``
step, ``refetch_wire_bytes`` is left out (the chunked re-fetch and the fp8
sidecar's re-fetch bytes are known differences, pinned in
``tests/test_torch_faults.py``).
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import codebook as jcb  # noqa: E402
from repro.core.pipeline import CodecProfile as JProfile  # noqa: E402
from repro.serving import cluster as JCL  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import faults as JF  # noqa: E402
from repro.serving import plan as JPL  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro.serving import session as JSS  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core import tree as TR  # noqa: E402
from repro_torch.core.pipeline import CodecProfile  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.kvcache import DecodeState  # noqa: E402
from repro_torch.serving import cluster as TCL  # noqa: E402
from repro_torch.serving import faults as TF  # noqa: E402
from repro_torch.serving import plan as TPL  # noqa: E402
from repro_torch.serving import scheduler as TS  # noqa: E402
from repro_torch.serving.engine import DisaggregatedEngine  # noqa: E402
from repro_torch.serving.session import PrefixIndex  # noqa: E402

STAT_FIELDS = [f.name for f in dataclasses.fields(TPL.TransferStats)]
PROF = dict(g_enc=613.3e9, g_dec=2181.8e9, ratio=1.324, link_bw=25e9)


def _bf16_bits(rng, shape):
    x = rng.standard_normal(shape) * np.exp(rng.standard_normal(shape))
    return x.astype(np.float32).astype(jnp.bfloat16).view(np.uint16)


def _pair(bits):
    """``{key: numpy bits}`` -> the JAX pytree and the port's dict."""
    jdt = {"k": jnp.bfloat16, "v": jnp.bfloat16, "f32": jnp.float32,
           "f8": jnp.float8_e4m3fn, "ids": jnp.int32}
    tdt = {"k": torch.bfloat16, "v": torch.bfloat16, "f32": torch.float32,
           "f8": torch.float8_e4m3fn, "ids": torch.int32}
    jc = {k: jnp.asarray(b).view(jdt[k]) for k, b in bits.items()}
    tc = {}
    for k, b in bits.items():
        signed = b.view({1: np.int8, 2: np.int16, 4: np.int32}[b.itemsize])
        tc[k] = torch.from_numpy(signed.copy()).view(tdt[k])
    return jc, tc


def routed_bits(seed: int = 3):
    """A cache taking every route: bf16 k/v (the splitzip stream), an fp32
    leaf (hi/lo), a float8 leaf (fp8 sidecar) and int ids (raw)."""
    rng = np.random.default_rng(seed)
    f8 = rng.standard_normal((32, 32)).astype(np.float32).astype(
        jnp.float8_e4m3fn).view(np.uint8)
    return {"k": _bf16_bits(np.random.default_rng(1), (2, 64, 64)),
            "v": _bf16_bits(np.random.default_rng(2), (2, 64, 64)),
            "f32": rng.standard_normal((32, 64)).astype(np.float32).view(np.uint32),
            "f8": f8, "ids": np.arange(64, dtype=np.int32)}


def mutate_tail(bits, seed: int = 5):
    """The next turn's bits: the same prefix, a changed tail on every route."""
    rng = np.random.default_rng(seed)
    out = {k: b.copy() for k, b in bits.items()}
    out["k"][-1, -8:, :] = rng.standard_normal((8, 64)).astype(np.float32) \
        .astype(jnp.bfloat16).view(np.uint16)
    f32 = out["f32"].view(np.float32)
    f32[-1, :] += 1.0
    out["f8"][-1, :] = np.array([1.5], np.float32).astype(
        jnp.float8_e4m3fn).view(np.uint8)[0]
    out["ids"] = out["ids"] + 1
    return out


@pytest.fixture(scope="module")
def routed():
    bits = routed_bits()
    cb = jcb.calibrate([bits["k"].reshape(-1)], k=16)
    return bits, cb, tcb.Codebook.from_json(cb.to_json())


def plans(bits, cb, tcb_, n_chunks=4, **kw):
    jc, tc = _pair(bits)
    jp = JPL.TransferPlan.build(jc, JPL.TransferConfig(
        codebook=cb, n_chunks=n_chunks, compress_fp32=True, backend="xla", **kw))
    tp = TPL.TransferPlan.build(tc, TPL.TransferConfig(
        codebook=tcb_, n_chunks=n_chunks, compress_fp32=True, backend="torch",
        **kw))
    return jp, tp


def raw_bytes_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return C.signed_view(x).contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.asarray(x).view(np.uint8).reshape(-1)


def assert_same_cache(a, b):
    """Two caches (either package) bitwise equal, leaf by leaf."""
    la = jax.tree.leaves(a) if not isinstance(next(iter(a.values())), torch.Tensor) \
        else TR.leaves(a)
    lb = jax.tree.leaves(b) if not isinstance(next(iter(b.values())), torch.Tensor) \
        else TR.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(raw_bytes_of(x), raw_bytes_of(y))


def assert_same_stats(sj, st, skip=()):
    for name in STAT_FIELDS:
        if name not in skip:
            assert getattr(sj, name) == getattr(st, name), name
    if "refetch_wire_bytes" not in skip:
        assert sj.wire_bytes == st.wire_bytes


class Both:
    """A JAX session and a port session driven turn by turn in lockstep."""

    def __init__(self, jp, tp, capacity=None, **session_kw):
        jkw = {k: v[0] if isinstance(v, tuple) else v
               for k, v in session_kw.items()}
        tkw = {k: v[1] if isinstance(v, tuple) else v
               for k, v in session_kw.items()}
        self.js, self.ts = jp.session(**jkw), tp.session(**tkw)
        self.jidx = self.js.enable_prefix_cache(capacity)
        self.tidx = self.ts.enable_prefix_cache(capacity)

    def delta(self, bits, sid, skip=()):
        jc, tc = _pair(bits)
        jo = self.js.transfer_delta(jc, session_id=sid)
        to = self.ts.transfer_delta(tc, session_id=sid)
        assert_same_cache(jo, to)
        assert_same_cache(tc, to)
        assert_same_stats(self.js.last_stats, self.ts.last_stats, skip)
        return to, self.ts.last_stats


# ---------------------------------------------------------------------------
# transfer_delta
# ---------------------------------------------------------------------------

def test_plan_covers_every_route(routed):
    bits, cb, tcb_ = routed
    jp, tp = plans(bits, cb, tcb_)
    assert {r.route for r in tp.routes} == {"splitzip", "fp32_hilo", "fp8", "raw"}
    assert [(r.key, r.route, r.cap) for r in tp.routes] == \
        [(r.key, r.route, r.cap) for r in jp.routes]
    assert tp.n_chunks == jp.n_chunks == 4


def test_cold_delta_equals_full_transfer(routed):
    bits, cb, tcb_ = routed
    jp, tp = plans(bits, cb, tcb_)
    both = Both(jp, tp)
    out, st = both.delta(bits, 0)
    full = tp.session()
    assert_same_cache(full.transfer(_pair(bits)[1]), out)
    assert st.prefix_hit_bytes == 0.0
    assert st.wire_bytes == full.last_stats.wire_bytes
    assert_same_stats(full.last_stats, st)


def test_unchanged_cache_ships_zero_bytes(routed):
    bits, cb, tcb_ = routed
    both = Both(*plans(bits, cb, tcb_))
    both.delta(bits, 0)
    _, st = both.delta(bits, 0)
    assert st.wire_bytes == 0.0
    raw = sum(r.raw_bytes for r in both.ts.plan.routes)
    assert st.prefix_hit_bytes == raw > 0


def test_warm_delta_bit_identical_and_cheaper(routed):
    bits, cb, tcb_ = routed
    jp, tp = plans(bits, cb, tcb_)
    both = Both(jp, tp)
    _, cold = both.delta(bits, 0)
    cold_wire = cold.wire_bytes
    turn2 = mutate_tail(bits)
    out, st = both.delta(turn2, 0)
    assert_same_cache(tp.session().transfer(_pair(turn2)[1]), out)
    assert 0 < st.wire_bytes < cold_wire
    assert st.prefix_hit_bytes > 0
    # every route's changed piece shipped: two segments of the stream (the
    # f32 leaf's hi halves, then k's tail), the sidecars
    assert sum(w > 0 for w in st.chunk_wire_bytes) == 2
    assert st.fp32_lo_wire_bytes > 0
    assert st.fp8_wire_bytes > 0
    assert st.raw_passthrough_bytes > 0


def test_sessions_are_isolated(routed):
    bits, cb, tcb_ = routed
    both = Both(*plans(bits, cb, tcb_))
    both.delta(bits, 0)
    _, st = both.delta(bits, 1)
    assert st.prefix_hit_bytes == 0.0
    assert both.tidx.sessions() == both.jidx.sessions() == [0, 1]


def _fixed_sidecar_bytes(self, obj, is_raw):
    """The JAX session's ``_object_wire_bytes`` without its fault (a
    re-fetched compressed fp8 sidecar counted as an 8-byte object)."""
    if isinstance(obj, (jax.Array, np.ndarray)):
        a = np.asarray(obj)
        return float(a.size * a.dtype.itemsize)
    return float(JSS._backend_for(obj, self.plan.backend).wire_bytes(obj))


@pytest.mark.parametrize("plan_kw, skip", [
    # the JAX test's plan: re-fetches may reach the global step
    (dict(seed=9, corrupt_p=0.3, drop_p=0.1), ("refetch_wire_bytes",)),
    # rates that stop before the global step: every field equal
    (dict(seed=4, corrupt_p=0.3, drop_p=0.15, delay_p=0.1, delay_s=0.002,
          corrupt_chunks=(1,), drop_chunks=(5,), max_attempt=2), ()),
], ids=["reference_plan", "seeded_rates"])
def test_delta_under_fault_injection_stays_bit_identical(routed, monkeypatch,
                                                         plan_kw, skip):
    monkeypatch.setattr(JSS.TransferSession, "_object_wire_bytes",
                        _fixed_sidecar_bytes)
    bits, cb, tcb_ = routed
    both = Both(*plans(bits, cb, tcb_), verify=True,
                faults=(JF.FaultPlan(**plan_kw), TF.FaultPlan(**plan_kw)))
    _, a = both.delta(bits, 0, skip)
    _, b = both.delta(mutate_tail(bits), 0, skip)
    assert both.ts._channel.injected == both.js._channel.injected >= 1
    assert a.refetches + b.refetches >= 1
    assert b.prefix_hit_bytes > 0


def test_fp32_and_fp8_hits_are_bitwise_not_numeric(routed):
    """NaN payloads still hit and -0.0 -> +0.0 still misses: the shadows
    compare bits, not numbers."""
    bits, cb, tcb_ = routed
    b1 = {k: v.copy() for k, v in bits.items()}
    f32 = b1["f32"].view(np.float32)
    f32[0, 0] = np.nan
    f32[0, 1] = -0.0
    both = Both(*plans(b1, cb, tcb_))
    both.delta(b1, 0)
    _, st = both.delta(b1, 0)                       # NaN must still hit
    assert st.fp32_lo_wire_bytes == 0.0 and st.wire_bytes == 0.0
    b2 = {k: v.copy() for k, v in b1.items()}
    b2["f32"].view(np.float32)[0, 1] = 0.0          # the sign is in the HI
    out, st = both.delta(b2, 0)                     # half: a stream miss
    assert any(w > 0 for w in st.chunk_wire_bytes)
    assert not bool(torch.signbit(out["f32"][0, 1]))
    b3 = {k: v.copy() for k, v in b2.items()}
    b3["f32"][1, 0] ^= np.uint32(1)                 # a low-mantissa flip:
    out, st = both.delta(b3, 0)                     # only the lo sidecar
    assert st.fp32_lo_wire_bytes > 0.0 and not any(st.chunk_wire_bytes)
    np.testing.assert_array_equal(out["f32"].view(torch.int32).numpy()
                                  .view(np.uint32), b3["f32"])
    b4 = {k: v.copy() for k, v in b3.items()}
    b4["f8"][0, 0] = 0x7F                           # an fp8 NaN payload
    both.delta(b4, 0)
    _, st = both.delta(b4, 0)
    assert st.fp8_wire_bytes == 0.0 and st.wire_bytes == 0.0


def test_delta_requires_chunked_path_and_enablement(routed):
    bits, cb, tcb_ = routed
    _, tp1 = plans(bits, cb, tcb_, n_chunks=1)
    with pytest.raises(ValueError, match="chunked"):
        tp1.session().enable_prefix_cache()
    _, tp = plans(bits, cb, tcb_)
    sess = tp.session()
    with pytest.raises(RuntimeError, match="enable_prefix_cache"):
        sess.transfer_delta(_pair(bits)[1], session_id=0)
    idx = sess.enable_prefix_cache(1e9)
    assert sess.enable_prefix_cache(5.0) is idx and idx.capacity_bytes == 1e9
    with pytest.raises(ValueError, match="structure"):
        sess.transfer_delta({"k": _pair(bits)[1]["k"]}, session_id=0)


# ---------------------------------------------------------------------------
# PrefixIndex eviction
# ---------------------------------------------------------------------------

def test_lru_eviction_under_pressure(routed):
    bits, cb, tcb_ = routed
    jp, tp = plans(bits, cb, tcb_)
    probe = Both(jp, tp)
    probe.delta(bits, 0)
    entry = probe.tidx.resident_bytes
    assert entry == probe.jidx.resident_bytes > 0
    both = Both(jp, tp, capacity=2.5 * entry)
    for sid in range(4):
        both.delta(bits, sid)
    for idx in (both.tidx, both.jidx):
        assert len(idx) == 2 and idx.evictions == 2
        assert idx.sessions() == [2, 3]     # LRU: the oldest went first
    _, st = both.delta(bits, 0)             # evicted: cold again
    assert st.prefix_hit_bytes == 0.0
    _, st = both.delta(bits, 3)             # still resident: hits
    assert st.prefix_hit_bytes > 0
    assert both.tidx.sessions() == both.jidx.sessions() == [0, 3]


def test_single_entry_over_budget_never_sticks(routed):
    bits, cb, tcb_ = routed
    both = Both(*plans(bits, cb, tcb_), capacity=16.0)
    both.delta(bits, 0)
    for idx in (both.tidx, both.jidx):
        assert len(idx) == 0 and idx.evictions == 1
        assert idx.resident_bytes == 0.0


@pytest.mark.parametrize("capacity", [0.0, -1.0])
def test_capacity_validation(capacity):
    with pytest.raises(ValueError):
        PrefixIndex(capacity_bytes=capacity)
    with pytest.raises(ValueError):
        JSS.PrefixIndex(capacity_bytes=capacity)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engines(bits, cb, tcb_, **kw):
    jc, tc = _pair({k: bits[k] for k in ("k", "v")})
    lens = np.array([64, 40], np.int32)
    jstate = JE.DecodeState(cache=jc, cache_len=jnp.asarray(lens))
    tstate = DecodeState(cache=tc, cache_len=torch.from_numpy(lens))
    je = JE.DisaggregatedEngine(None, {}, cb, **kw)
    te = DisaggregatedEngine(None, {}, tcb_, backend="torch", device="cpu", **kw)
    return je, te, jstate, tstate


def test_engine_transfer_delta_with_session_id(routed):
    bits, cb, tcb_ = routed
    je, te, js, ts = _engines(bits, cb, tcb_, n_chunks=4,
                              prefix_cache_bytes=1e9)
    for sid in (7, 7, None, 8):
        jo, to = je.transfer(js, session_id=sid), te.transfer(ts, session_id=sid)
        assert_same_cache(jo.cache, to.cache)
        assert_same_cache(ts.cache, to.cache)
    a, b = je.stats, te.stats
    for name in ("raw_cache_bytes", "wire_bytes", "prefix_hit_bytes",
                 "chunk_wire_bytes", "chunk_retries", "encoded_units",
                 "overflow_obs"):
        assert getattr(a, name) == getattr(b, name), name
    # the second session-7 turn was all hits, the cold session 8 none
    raw = te.plan.raw_bytes()
    assert b.prefix_hit_bytes == raw
    assert b.raw_cache_bytes == 4 * raw
    assert len(te._session._prefix_index) == 2
    with pytest.raises(ValueError, match="n_chunks > 1"):
        DisaggregatedEngine(None, {}, tcb_, prefix_cache_bytes=1.0, device="cpu")
    with pytest.raises(ValueError, match="compress=True"):
        DisaggregatedEngine(None, {}, tcb_, prefix_cache_bytes=1.0, n_chunks=4,
                            compress=False, device="cpu")


def test_scheduler_config_of_an_engine():
    """The engine hands the scheduler its plan, policy and observed
    overflow: the same routes, ``overflow_p`` and per-bucket
    ``overflow_priors`` as the JAX engine, and equal schedules."""
    rng = np.random.default_rng(11)
    kb = rng.standard_normal((2, 1, 200, 2, 16)).astype(jnp.bfloat16).view(np.uint16)
    vb = rng.standard_normal((2, 1, 200, 2, 16)).astype(jnp.bfloat16).view(np.uint16)
    cb = jcb.calibrate([kb.reshape(-1)], k=16)
    vb.reshape(-1)[:600] = 0x7F80 + (np.arange(600) % 100)   # escape-heavy
    bits = {"k": kb, "v": vb}
    tcb_ = tcb.Codebook.from_json(cb.to_json())
    je, te, js, ts = _engines(bits, cb, tcb_, n_chunks=3)
    for _ in range(2):
        je.transfer(js)
        te.transfer(ts)
    assert te.stats.observed_overflow_p == je.stats.observed_overflow_p > 0
    assert te.overflow_priors(256) == je.overflow_priors(256)
    kw = dict(kv_bytes_per_token=2048, max_prefill_batch=2, bucket_tokens=256,
              decode_time_per_step=1e-3)
    jcfg = je.scheduler_config(JProfile(**PROF), **kw)
    tcfg = te.scheduler_config(CodecProfile(**PROF), **kw)
    assert tcfg.plan is te.plan and tcfg.transfer_config is te.tc
    assert [(r.key, r.shape, r.dtype, r.route, r.cap) for r in tcfg.plan.routes] \
        == [(r.key, r.shape, r.dtype, r.route, r.cap) for r in jcfg.plan.routes]
    assert (tcfg.overflow_p, tcfg.overflow_priors, tcfg.n_chunks, tcfg.compress) \
        == (jcfg.overflow_p, jcfg.overflow_priors, jcfg.n_chunks, jcfg.compress)
    assert set(tcfg.overflow_priors) == {256}
    pinned = te.scheduler_config(overflow_priors={1024: 0.5}, policy="sjf")
    assert pinned.overflow_priors == {1024: 0.5} and pinned.profile is None
    runs = []
    for sched_mod, cfg in ((JS, jcfg), (TS, tcfg)):
        s = sched_mod.DisaggregatedScheduler(cfg)
        for i in range(6):
            s.submit(sched_mod.Request(rid=i, arrival=i * 2e-4,
                                       prompt_len=(200, 700, 90)[i % 3],
                                       max_new_tokens=3))
        runs.append((sched_mod.summarize(s.run()), s.link_busy_s))
    (jsum, jbusy), (tsum, tbusy) = runs
    assert jsum.keys() == tsum.keys()
    for k in jsum:
        assert tsum[k] == pytest.approx(jsum[k], rel=1e-9, abs=0.0), k
    assert tbusy == pytest.approx(jbusy, rel=1e-9)


def test_scheduler_failover_triggers_engine_resend():
    """A decode-worker kill makes the port's scheduler fire ``on_failover``
    for the same requests as the JAX scheduler, and each firing drives a
    real engine re-send of reduced smollm's prefill cache, bitwise what the
    dead worker held, with no encode."""
    cfg = get_config("smollm-135m").reduced()
    device = torch.device("cpu")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device)
    prompt = serve.make_prompt(cfg, 2, 16, device=device, seed=1)
    cb = serve.calibrate_on_model(cfg, params, device=device, seed=2)
    eng = DisaggregatedEngine(cfg, params, cb, backend="torch",
                              retain_for_failover=True, device=device)
    state = eng.prefill(prompt, max_seq=24).state
    baseline = eng.transfer(state)
    sess = eng._session
    encodes = []
    sess.plan.backend.encode = _counting(sess.plan.backend.encode, encodes)

    def schedule(mod, cl, faults, hook):
        s = mod.DisaggregatedScheduler(mod.SchedulerConfig(
            kv_bytes_per_token=2048, profile=prof[mod], compress=True,
            prefill_time_per_token=0.0, decode_time_per_step=1e-3,
            max_prefill_batch=4,
            cluster=cl.ClusterConfig(n_prefill=1, n_decode=2,
                                     links=(cl.LinkSpec(),),
                                     router="transfer-aware"),
            faults=faults.FaultPlan(seed=1, worker_kills=(
                faults.WorkerKill(worker=0, at=5e-3),)),
            heartbeat_timeout_s=1e-3, on_failover=hook))
        for i in range(4):
            s.submit(mod.Request(rid=i, arrival=0.0, prompt_len=1024,
                                 max_new_tokens=64))
        return s, s.run()

    prof = {JS: JProfile(**PROF), TS: CodecProfile(**PROF)}
    jrids, resent = [], []
    _, jdone = schedule(JS, JCL, JF, lambda r: jrids.append(r.rid))
    try:
        sched, done = schedule(TS, TCL, TF, lambda r: resent.append(
            (r.rid, eng.resend_cache(state))))
    finally:
        del sess.plan.backend.encode
    assert sched.failovers > 0 and resent
    assert [rid for rid, _ in resent] == jrids
    assert eng.stats.failover_resends == len(resent)
    assert not encodes
    for _, again in resent:
        assert all(C.bits_equal(a, b) for a, b in
                   zip(TR.leaves(again.cache), TR.leaves(baseline.cache)))
    assert all(r.state in ("completed", "shed", "failed-over") for r in done)
    assert sorted((r.rid, r.state, r.failovers) for r in done) == \
        sorted((r.rid, r.state, r.failovers) for r in jdone)


def _counting(fn, log):
    def wrapped(*args, **kwargs):
        log.append(1)
        return fn(*args, **kwargs)
    return wrapped
