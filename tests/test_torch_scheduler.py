"""The port's event scheduler, link policies, routers and failure detector
against the JAX package's.

Pure host arithmetic on both sides, so the comparison is exact:

* policies' ``link_key`` / ``deadline_of`` and routers' ``place`` on equal
  requests and equal scheduler views;
* ``FailureDetector`` under one injected clock: the same ``timed_out``,
  ``newly_dead``, ``dead_workers``, ``stragglers`` and revivals;
* ``SchedulerConfig.derived_decode_slots`` and its two ``ValueError``s;
* whole schedules over every policy x router x {1x1x1, 2x2x4} topology x
  {no fault, a decode kill, a prefill kill, a brownout}, both schedulers
  charging one shared duration function (the JAX scheduler's
  ``plan.estimate_time``): every request's times, state, links, worker,
  failovers and retries, the counters, ``summarize()`` and the
  ``on_failover`` firings exactly equal;
* one run on each package's own bucket plans (arch cache structures, the
  port's built from ``meta`` tensors), equal to 1e-9 relative with the same
  states (the port's ``estimate_time`` matches the JAX one to 1e-12, not
  bitwise).
"""

import dataclasses
import math

import pytest

jax = pytest.importorskip("jax")

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core.pipeline import CodecProfile as JProfile  # noqa: E402
from repro.distributed import fault_tolerance as JFT  # noqa: E402
from repro.serving import cluster as JCL  # noqa: E402
from repro.serving import faults as JF  # noqa: E402
from repro.serving import policy as JPO  # noqa: E402
from repro.serving import router as JR  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro.serving import traces as JT  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.pipeline import CodecProfile  # noqa: E402
from repro_torch.distributed import fault_tolerance as TFT  # noqa: E402
from repro_torch.serving import cluster as TCL  # noqa: E402
from repro_torch.serving import faults as TF  # noqa: E402
from repro_torch.serving import policy as TPO  # noqa: E402
from repro_torch.serving import router as TR  # noqa: E402
from repro_torch.serving import scheduler as TS  # noqa: E402
from repro_torch.serving import traces as TT  # noqa: E402

KV_BYTES_TOK = 2 * 32 * 8 * 128 * 2
PROF = dict(g_enc=613.3e9, g_dec=2181.8e9, ratio=1.324, link_bw=25e9)
# one namespace per package, so a scenario is written once
J = dict(S=JS, CL=JCL, F=JF, T=JT, prof=JProfile(**PROF))
T = dict(S=TS, CL=TCL, F=TF, T=TT, prof=CodecProfile(**PROF))

REQ_FIELDS = ("rid", "arrival", "prompt_len", "max_new_tokens", "deadline",
              "prefill_done", "link_start", "transfer_done", "admit_time",
              "first_token_time", "finish_time", "tokens_out", "state",
              "worker", "failovers", "retries", "link_history", "session",
              "prefix_len", "tenant", "pinned", "link_ids")
SCHED_COUNTERS = ("link_busy_s", "link_busy_by_link", "sheds", "failovers",
                  "retries", "prefill_failovers", "prefix_hit_bytes",
                  "transfer_bytes", "max_decode_slots")


def fields(r):
    return tuple(getattr(r, f) for f in REQ_FIELDS)


# ---------------------------------------------------------------------------
# policies and routers
# ---------------------------------------------------------------------------

def _request_pair(**kw):
    return JS.Request(**kw), TS.Request(**kw)


def test_policy_registry_matches():
    assert TPO.available_policies() == JPO.available_policies() == (
        "edf", "edf-shed", "fifo", "sjf", "spec")
    with pytest.raises(KeyError):
        TPO.get_policy("no-such-policy")


@pytest.mark.parametrize("name", JPO.available_policies())
def test_policy_keys_match(name):
    jp, tp = JPO.get_policy(name), TPO.get_policy(name)
    assert (tp.name, tp.speculative, tp.sheds) == (jp.name, jp.speculative,
                                                   jp.sheds)
    for slo in (None, 0.25):
        jcfg, tcfg = JS.SchedulerConfig(slo_s=slo), TS.SchedulerConfig(slo_s=slo)
        for rid, deadline, done, est in ((3, math.inf, 0.5, 1e-3),
                                         (1, 0.9, 0.5, 1e-3),
                                         (2, 0.9, 0.25, 4e-3),
                                         (0, math.inf, 0.125, 0.0)):
            jr, tr = _request_pair(rid=rid, arrival=0.1 * rid, prompt_len=64,
                                   max_new_tokens=2, deadline=deadline)
            jr.prefill_done = tr.prefill_done = done
            jk, tk = jp.link_key(jr, est, jcfg), tp.link_key(tr, est, tcfg)
            assert tk == jk and tk[-1] == rid
            assert tp.deadline_of(tr, tcfg) == jp.deadline_of(jr, jcfg)


class _View:
    """A scheduler view with fixed, distinct numbers: what a router reads."""

    def __init__(self, cl, alive, n_links, n_decode):
        self.cluster = cl.ClusterConfig(
            n_prefill=1, n_decode=n_decode,
            links=tuple(cl.LinkSpec() for _ in range(n_links)))
        self.cfg = TS.SchedulerConfig(decode_time_per_step=2e-3)
        self.alive = alive
        self.rr = {}

    def est_transfer_s(self, req, link, wid):
        return 1e-3 * (1 + link) + 3e-4 * ((req.rid + wid) % 3)

    def link_backlog_s(self, link):
        return (0.0, 2.5e-3, 1e-3)[link]

    def decode_load(self, wid):
        return (2, 0, 1, 0)[wid]

    def decode_alive(self, wid):
        return self.alive[wid]

    def rr_next(self, kind):
        v = self.rr.get(kind, 0)
        self.rr[kind] = v + 1
        return v


@pytest.mark.parametrize("name", JR.available_routers())
def test_router_place_matches(name):
    assert TR.available_routers() == JR.available_routers()
    jr, tr = JR.get_router(name), TR.get_router(name)
    for alive in ((True,) * 4, (False, True, True, False), (False,) * 4):
        for n_links in (1, 3):
            jv = _View(JCL, alive, n_links, 4)
            tv = _View(TCL, alive, n_links, 4)
            for rid in range(6):
                req = TS.Request(rid=rid, arrival=0.0, prompt_len=8,
                                 max_new_tokens=1)
                assert tr.place(req, tv) == jr.place(req, jv)
    with pytest.raises(KeyError):
        TR.get_router("no-such-router")


# ---------------------------------------------------------------------------
# the failure detector
# ---------------------------------------------------------------------------

def test_failure_detector_matches():
    now = [0.0]
    cfg = dict(heartbeat_timeout_s=1.0, straggler_factor=2.0)
    jd = JFT.FailureDetector(4, JFT.FaultConfig(**cfg), clock=lambda: now[0])
    td = TFT.FailureDetector(4, TFT.FaultConfig(**cfg), clock=lambda: now[0])
    script = [
        (0.5, [(0, 1.0), (1, 1.0), (2, 1.1), (3, 0.9)]),
        (1.2, [(0, 1.0), (1, 5.0), (2, 1.0)]),         # 3 lapses
        (1.9, [(0, 1.0), (1, 6.0)]),
        (2.0, [(2, None)]),
        (3.5, [(3, 1.0)]),                              # 3 revives
        (3.6, []),
        (5.0, [(1, 1.0)]),
    ]
    for t, beats in script:
        now[0] = t
        for wid, step in beats:
            jd.heartbeat(wid, step)
            td.heartbeat(wid, step)
        assert td.timed_out() == jd.timed_out()
        assert td.stragglers() == jd.stragglers()
        assert td.newly_dead() == jd.newly_dead()
        assert td.newly_dead() == jd.newly_dead() == []
        assert td.dead_workers() == jd.dead_workers()
        assert td.alive_count() == jd.alive_count()
        assert [dataclasses.astuple(w) for w in td.workers.values()] == \
            [dataclasses.astuple(w) for w in jd.workers.values()]
    assert td.dead_workers() and td.stragglers() == []


def test_derived_decode_slots_and_errors():
    for kw in (dict(), dict(max_decode_slots=7),
               dict(hbm_bytes_per_worker=10_000_000,
                    resident_bytes_per_token=100.0, slot_tokens=4096),
               dict(hbm_bytes_per_worker=10_000_000,
                    resident_bytes_per_token=33.3, slot_tokens=0,
                    n_decode_workers=3),
               dict(hbm_bytes_per_worker=5e6, resident_bytes_per_token=2.0,
                    cluster="2x5")):
        if kw.get("cluster") == "2x5":
            jkw = dict(kw, cluster=JCL.ClusterConfig(n_prefill=2, n_decode=5))
            tkw = dict(kw, cluster=TCL.ClusterConfig(n_prefill=2, n_decode=5))
        else:
            jkw = tkw = kw
        assert TS.SchedulerConfig(**tkw).derived_decode_slots() == \
            JS.SchedulerConfig(**jkw).derived_decode_slots()
    for kw, match in ((dict(hbm_bytes_per_worker=1e9), "resident_bytes_per_token"),
                      (dict(hbm_bytes_per_worker=1e9,
                            resident_bytes_per_token=0.0),
                       "resident_bytes_per_token"),
                      (dict(hbm_bytes_per_worker=1000,
                            resident_bytes_per_token=1.0), "fits no")):
        with pytest.raises(ValueError, match=match) as tv:
            TS.SchedulerConfig(**kw).derived_decode_slots()
        with pytest.raises(ValueError) as jv:
            JS.SchedulerConfig(**kw).derived_decode_slots()
        assert str(tv.value) == str(jv.value)
    with pytest.raises(ValueError, match="kv_bytes_per_token"):
        TS.DisaggregatedScheduler(TS.SchedulerConfig(
            plan=object(), profile=T["prof"]))


# ---------------------------------------------------------------------------
# whole schedules
# ---------------------------------------------------------------------------

TOPOLOGIES = ("1x1x1", "2x2x4")
FAULTS = ("none", "decode_kill", "prefill_kill", "brownout")


def _cluster(ns, topo, policy, router):
    CL = ns["CL"]
    if topo == "1x1x1":
        return CL.ClusterConfig(n_prefill=1, n_decode=1,
                                links=(CL.LinkSpec(policy=policy),),
                                router=router)
    return CL.ClusterConfig(
        n_prefill=2, n_decode=4,
        links=(CL.LinkSpec(policy=policy), CL.LinkSpec(policy=policy,
                                                       bw_scale=0.5)),
        router=router, prefix_cache_bytes=float(KV_BYTES_TOK) * 1500)


def _faults(ns, kind):
    F = ns["F"]
    if kind == "decode_kill":
        return F.FaultPlan(seed=2, worker_kills=(
            F.WorkerKill(worker=0, at=2e-3, revive_at=9e-3),))
    if kind == "prefill_kill":
        return F.FaultPlan(seed=2, worker_kills=(
            F.WorkerKill(worker=0, at=4e-4, revive_at=6e-3, role="prefill"),))
    if kind == "brownout":
        return F.FaultPlan(seed=2, brownouts=(
            F.LinkBrownout(1e-3, 5e-3, 0.25),
            F.LinkBrownout(2e-3, 3e-3, 0.5, link=1)))
    return None


def _trace(ns, seed=0, n=16):
    T_ = ns["T"]
    return T_.generate_trace(T_.TraceConfig(
        seed=seed, n_requests=n, session_p=0.5, prompt_min=16,
        prompt_max=512, mean_burst_gap_s=2e-4, burst_spread_s=2e-5,
        followup_tokens=(8, 64),
        tenants=(T_.TenantClass("interactive", 0.5, 4e-3, (1, 4)),
                 T_.TenantClass("batch", 0.5, 1.0, (2, 8)))))


def _scheduler(ns, topo, policy, router, fault, fired, **kw):
    S = ns["S"]
    cfg = S.SchedulerConfig(
        kv_bytes_per_token=KV_BYTES_TOK, profile=ns["prof"], compress=True,
        prefill_time_per_token=5e-6, decode_time_per_step=1e-4,
        max_prefill_batch=4, max_decode_slots=6, heartbeat_timeout_s=5e-4,
        retry_backoff_s=2e-4, cluster=_cluster(ns, topo, policy, router),
        faults=_faults(ns, fault), on_failover=lambda r: fired.append(r.rid),
        **kw)
    return S.DisaggregatedScheduler(cfg)


def _assert_same_run(js, ts, jdone, tdone):
    assert [fields(r) for r in tdone] == [fields(r) for r in jdone]
    for name in SCHED_COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    assert TS.summarize(tdone) == JS.summarize(jdone)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("policy", JPO.available_policies())
def test_schedules_equal_under_shared_durations(policy, fault):
    exercised = {"failovers": 0, "prefill_failovers": 0, "sheds": 0}
    for topo in TOPOLOGIES:
        for router in JR.available_routers():
            ctx = f"{topo} {router}"
            jfired, tfired = [], []
            js = _scheduler(J, topo, policy, router, fault, jfired)
            ts = _scheduler(T, topo, policy, router, fault, tfired)
            # one duration function for both: the JAX plan's estimate_time
            ts._transfer_duration = js._transfer_duration
            for jr, tr in zip(_trace(J), _trace(T)):
                js.submit(jr)
                ts.submit(tr)
            jdone, tdone = js.run(), ts.run()
            assert len(tdone) == 16, ctx
            _assert_same_run(js, ts, jdone, tdone)
            assert tfired == jfired, ctx
            assert len(tfired) == ts.retries, ctx
            for k in exercised:
                exercised[k] += getattr(ts, k)
    # the fault plans reach the failure paths they aim at
    if fault == "decode_kill":
        assert exercised["failovers"] > 0
    if fault == "prefill_kill":
        assert exercised["prefill_failovers"] > 0
    if policy == "edf-shed":
        assert exercised["sheds"] > 0


def test_schedule_on_own_plans_within_1e9():
    """Each package on its own per-bucket plans from smollm-135m's cache
    structure (the port's built from meta tensors): the same states and
    placements, every time within 1e-9 relative."""
    runs = []
    for ns, cfg in ((J, jget_config("smollm-135m")),
                    (T, get_config("smollm-135m"))):
        S = ns["S"]
        fired = []
        sched = S.DisaggregatedScheduler(S.SchedulerConfig(
            arch=cfg, profile=ns["prof"], compress=True, n_chunks=4,
            prefill_time_per_token=5e-6, decode_time_per_step=1e-4,
            max_prefill_batch=4, max_decode_slots=6, bucket_tokens=128,
            heartbeat_timeout_s=5e-4, retry_backoff_s=2e-4,
            cluster=_cluster(ns, "2x2x4", "sjf", "transfer-aware"),
            faults=_faults(ns, "decode_kill"),
            on_failover=lambda r: fired.append(r.rid)))
        for r in _trace(ns, seed=3, n=24):
            sched.submit(r)
        runs.append((sched, sched.run(), fired))
    (js, jdone, jfired), (ts, tdone, tfired) = runs
    assert tfired == jfired and ts.failovers > 0
    assert sorted(ts.plans) == sorted(js.plans)
    for b in ts.plans:
        assert ts.plans[b].raw_bytes() == js.plans[b].raw_bytes()
        assert ts.plans[b].n_chunks == js.plans[b].n_chunks == 4
    for a, b in zip(jdone, tdone):
        for name in REQ_FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            if isinstance(x, float):
                assert y == pytest.approx(x, rel=1e-9, abs=1e-15), name
            elif name == "link_history":
                assert [pytest.approx(iv, rel=1e-9) for iv in x] == y
            else:
                assert x == y, name
    jsum, tsum = JS.summarize(jdone), TS.summarize(tdone)
    assert jsum.keys() == tsum.keys()
    for k in jsum:
        assert tsum[k] == pytest.approx(jsum[k], rel=1e-9), k
    assert ts.link_busy_s == pytest.approx(js.link_busy_s, rel=1e-9)
    assert ts.prefix_hit_bytes == js.prefix_hit_bytes > 0


def test_bucket_plans_allocate_no_cache(monkeypatch):
    """A 32k-token bucket of qwen3-moe-30b-a3b (6.4 GB of KV) plans from
    meta tensors: shapes and dtypes, no storage."""
    made = []

    def spy(*args, **kwargs):
        cache = TS_init_cache(*args, **kwargs)
        made.extend(cache.values())
        return cache

    TS_init_cache = TS.init_cache
    monkeypatch.setattr(TS, "init_cache", spy)
    cfg = get_config("qwen3-moe-30b-a3b")
    sched = TS.DisaggregatedScheduler(TS.SchedulerConfig(
        arch=cfg, profile=T["prof"], n_chunks=8, bucket_tokens=32768))
    sched.submit(TS.Request(rid=0, arrival=0.0, prompt_len=30000,
                            max_new_tokens=1))
    done = sched.run()
    assert done[0].state == "completed" and made
    assert all(t.is_meta for t in made)
    plan = sched.plans[32768]
    assert plan.raw_bytes() == 2 * 48 * 32768 * 4 * 128 * 2
    jplan = JS.DisaggregatedScheduler(JS.SchedulerConfig(
        arch=jget_config("qwen3-moe-30b-a3b"), n_chunks=8,
        bucket_tokens=32768))._bucket_plan(32768)
    assert [(s.start, s.stop, s.cap) for s in plan.segments] == \
        [(s.start, s.stop, s.cap) for s in jplan.segments]
