"""The port's fleet layer against the JAX package's: multi-tenant traces,
the scheduler's prefix directory, cluster resolution, and the invariants the
JAX package's ``tests/test_fleet.py`` pins on its cluster scheduler.

* ``generate_trace`` gives the JAX package's requests bit for bit (one
  ``numpy`` ``default_rng(seed)`` on both sides) over several configs,
  sessions included;
* ``PrefixDirectory`` hits, resident bytes and evictions equal over a seeded
  stream of inserts, probes and worker drops;
* ``resolve_cluster`` on the legacy fields, and the degenerate 1x1x1
  cluster reproducing the legacy pipe field by field for every policy;
* on the port alone: termination, per-link conservation and the
  shipped + hit byte decomposition over topologies x routers x traces,
  submission-order determinism, and the routers' placement behaviour.
"""

import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.serving import cluster as JCL  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro.serving import traces as JT  # noqa: E402
from repro_torch.core.pipeline import CodecProfile  # noqa: E402
from repro_torch.serving.cluster import (ClusterConfig, LinkSpec,  # noqa: E402
                                         PrefixDirectory, resolve_cluster)
from repro_torch.serving.policy import available_policies  # noqa: E402
from repro_torch.serving.router import available_routers  # noqa: E402
from repro_torch.serving.scheduler import (DisaggregatedScheduler,  # noqa: E402
                                           Request, SchedulerConfig, summarize)
from repro_torch.serving.traces import (DEFAULT_TENANTS, TenantClass,  # noqa: E402
                                        TraceConfig, generate_trace)

KV_BYTES_TOK = 2 * 32 * 8 * 128 * 2
PROF = CodecProfile(g_enc=613.3e9, g_dec=2181.8e9, ratio=1.324, link_bw=25e9)
TERMINAL = ("completed", "shed", "failed-over")
TRACE_FIELDS = ("rid", "arrival", "prompt_len", "max_new_tokens", "deadline",
                "session", "prefix_len", "tenant")


def _cfg(**kw):
    base = dict(kv_bytes_per_token=KV_BYTES_TOK, profile=PROF, compress=True,
                prefill_time_per_token=1e-7, decode_time_per_step=1e-4,
                max_prefill_batch=4, max_decode_slots=64)
    base.update(kw)
    return SchedulerConfig(**base)


def _run(cfg, reqs):
    s = DisaggregatedScheduler(cfg)
    for r in reqs:
        s.submit(r)
    return s, s.run()


def _trace_kw(seed, n=10, session_p=0.0):
    return dict(seed=seed, n_requests=n, session_p=session_p, prompt_min=16,
                prompt_max=512, mean_burst_gap_s=2e-4, burst_spread_s=2e-5,
                followup_tokens=(8, 64))


def _trace(seed, n=10, session_p=0.0):
    return generate_trace(TraceConfig(
        **_trace_kw(seed, n, session_p),
        tenants=(TenantClass("interactive", 0.5, 0.05, (1, 4)),
                 TenantClass("batch", 0.5, 1.0, (2, 8)))))


def _fields(r):
    return (r.rid, r.state, r.worker, r.prefill_done, r.link_start,
            r.transfer_done, r.admit_time, r.first_token_time, r.finish_time,
            r.tokens_out, r.failovers, r.retries, tuple(r.link_history),
            tuple(r.link_ids))


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

TRACE_CONFIGS = {
    "defaults": dict(seed=2, n_requests=64),
    "sessions": dict(_trace_kw(9, 40, 0.5)),
    "agentic": dict(seed=11, n_requests=48, session_p=0.9, prompt_max=2048,
                    max_open_sessions=2, followup_tokens=(1, 3)),
    "fleet_phase": dict(seed=0, n_requests=64, prompt_min=256,
                        prompt_max=16384, session_p=0.3),
    "one_burst": dict(seed=5, n_requests=3, max_burst=1, burst_alpha=3.0,
                      prompt_alpha=0.5, prompt_min=1, prompt_max=1),
}


@pytest.mark.parametrize("name", sorted(TRACE_CONFIGS))
def test_generate_trace_matches_bitwise(name):
    kw = TRACE_CONFIGS[name]
    mine = generate_trace(TraceConfig(**kw))
    ref = JT.generate_trace(JT.TraceConfig(**kw))
    assert [tuple(getattr(r, f) for f in TRACE_FIELDS) for r in mine] == \
        [tuple(getattr(r, f) for f in TRACE_FIELDS) for r in ref]
    assert [r.rid for r in mine] == list(range(kw["n_requests"]))
    assert all(x.arrival <= y.arrival for x, y in zip(mine, mine[1:]))
    if kw.get("session_p", 0.0) > 0.0:
        cont = [r for r in mine if r.prefix_len > 0]
        assert cont and all(r.session >= 0 and r.prompt_len > r.prefix_len
                            for r in cont)


def test_trace_tenants_and_validation():
    reqs = generate_trace(TraceConfig(seed=2, n_requests=64))
    assert {r.tenant for r in reqs} == {t.name for t in DEFAULT_TENANTS}
    for r in reqs:
        t = next(t for t in DEFAULT_TENANTS if t.name == r.tenant)
        assert r.deadline == pytest.approx(r.arrival + t.slo_s)
        assert t.new_tokens[0] <= r.max_new_tokens <= t.new_tokens[1]
    assert DEFAULT_TENANTS == tuple(
        TenantClass(t.name, t.weight, t.slo_s, t.new_tokens)
        for t in JT.DEFAULT_TENANTS)
    for bad in (dict(n_requests=0), dict(session_p=1.5),
                dict(prompt_min=0), dict(prompt_min=9, prompt_max=8),
                dict(tenants=())):
        with pytest.raises(ValueError):
            TraceConfig(**bad)
        with pytest.raises(ValueError):
            JT.TraceConfig(**bad)
    for bad in (dict(weight=0.0, new_tokens=(1, 2)),
                dict(weight=1.0, new_tokens=(3, 2)),
                dict(weight=1.0, new_tokens=(0, 2))):
        with pytest.raises(ValueError):
            TenantClass("t", slo_s=1.0, **bad)


# ---------------------------------------------------------------------------
# the prefix directory and cluster resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [None, 900.0, 60.0])
def test_prefix_directory_matches(capacity):
    mine = PrefixDirectory(n_workers=3, capacity_bytes=capacity)
    ref = JCL.PrefixDirectory(n_workers=3, capacity_bytes=capacity)
    rng = np.random.default_rng(7)
    for _ in range(300):
        op = int(rng.integers(0, 10))
        w, sess = int(rng.integers(0, 4)), int(rng.integers(0, 6))
        if op < 6:
            tok, bpt = int(rng.integers(1, 400)), float(rng.choice([0.5, 1.0, 3.0]))
            mine.insert(w, sess, tok, bpt)
            ref.insert(w, sess, tok, bpt)
        elif op < 9:
            assert mine.hit_tokens(w, sess) == ref.hit_tokens(w, sess)
        else:
            mine.drop_worker(w)
            ref.drop_worker(w)
        assert [mine.resident_bytes(k) for k in range(4)] == \
            [ref.resident_bytes(k) for k in range(4)]
        assert mine.evictions == ref.evictions
    if capacity is not None:
        assert mine.evictions > 0


def test_prefix_directory_lru_and_workers():
    d = PrefixDirectory(n_workers=1, capacity_bytes=100.0)
    for s in (1, 2, 3):
        d.insert(0, session=s, tokens=30, bytes_per_token=1.0)
    assert d.resident_bytes(0) == 90.0
    d.hit_tokens(0, 1)                      # a pure lookup: no LRU touch
    d.insert(0, session=1, tokens=35, bytes_per_token=1.0)
    d.insert(0, session=4, tokens=30, bytes_per_token=1.0)   # evicts 2
    assert d.hit_tokens(0, 2) == 0 and d.hit_tokens(0, 1) == 35
    d.insert(0, session=9, tokens=500, bytes_per_token=1.0)  # over budget
    assert d.hit_tokens(0, 9) == 0
    p = PrefixDirectory(n_workers=2)
    p.insert(0, session=7, tokens=100, bytes_per_token=2.0)
    assert (p.hit_tokens(0, 7), p.hit_tokens(1, 7)) == (100, 0)
    p.drop_worker(0)
    assert p.hit_tokens(0, 7) == 0 and p.resident_bytes(0) == 0.0


def test_resolve_cluster_on_legacy_fields():
    for policy, n in (("edf", 3), ("fifo", 1), ("spec", 0)):
        mine = resolve_cluster(_cfg(policy=policy, n_decode_workers=n))
        ref = JCL.resolve_cluster(JS.SchedulerConfig(policy=policy,
                                                     n_decode_workers=n))
        assert (mine.n_prefill, mine.n_decode, mine.n_links, mine.router,
                mine.links[0].policy, mine.links[0].bw_scale,
                mine.prefix_cache_bytes) == \
            (ref.n_prefill, ref.n_decode, ref.n_links, ref.router,
             ref.links[0].policy, ref.links[0].bw_scale, ref.prefix_cache_bytes)
        assert mine.router == "legacy" and mine.n_decode == max(1, n)
    explicit = ClusterConfig(n_prefill=2, n_decode=2)
    assert resolve_cluster(_cfg(cluster=explicit)) is explicit
    with pytest.raises(ValueError):
        ClusterConfig(n_prefill=0, n_decode=1)
    with pytest.raises(ValueError):
        ClusterConfig(n_prefill=1, n_decode=1, links=())
    with pytest.raises(ValueError):
        LinkSpec(bw_scale=0.0)
    with pytest.raises(KeyError):
        DisaggregatedScheduler(_cfg(cluster=ClusterConfig(router="nope")))


@pytest.mark.parametrize("policy", available_policies())
def test_1x1x1_degenerates_to_legacy_bit_identical(policy):
    reqs = lambda: [Request(rid=i, arrival=i * 1e-4,
                            prompt_len=(1024, 128, 4096, 512)[i % 4],
                            max_new_tokens=4,
                            deadline=i * 1e-4 + (0.5 if i % 3 else 0.05))
                    for i in range(12)]
    _, legacy = _run(_cfg(policy=policy), reqs())
    cluster = ClusterConfig(n_prefill=1, n_decode=1,
                            links=(LinkSpec(policy=policy),),
                            router="transfer-aware")
    _, fleet = _run(_cfg(cluster=cluster), reqs())
    assert sorted(map(_fields, legacy)) == sorted(map(_fields, fleet))
    assert summarize(legacy) == summarize(fleet)


@pytest.mark.parametrize("n_workers", [2, 3])
def test_legacy_router_reproduces_multiworker_legacy(n_workers):
    reqs = lambda: [Request(rid=i, arrival=i * 1e-4,
                            prompt_len=(2048, 256)[i % 2], max_new_tokens=4)
                    for i in range(10)]
    _, legacy = _run(_cfg(policy="sjf", n_decode_workers=n_workers,
                          max_decode_slots=2 * n_workers), reqs())
    cluster = ClusterConfig(n_prefill=1, n_decode=n_workers,
                            links=(LinkSpec(policy="sjf"),), router="legacy")
    _, fleet = _run(_cfg(cluster=cluster,
                         max_decode_slots=2 * n_workers), reqs())
    assert sorted(map(_fields, legacy)) == sorted(map(_fields, fleet))


# ---------------------------------------------------------------------------
# the invariants, on the port
# ---------------------------------------------------------------------------

def _topologies():
    pols = available_policies()
    mk = lambda i, bw: LinkSpec(policy=pols[i % len(pols)], bw_scale=bw)
    return [
        ClusterConfig(n_prefill=1, n_decode=1, links=(mk(0, 1.0),)),
        ClusterConfig(n_prefill=2, n_decode=3, links=(mk(0, 1.0), mk(1, 0.5))),
        ClusterConfig(n_prefill=1, n_decode=2,
                      links=(mk(1, 1.0), mk(2, 0.25), mk(3, 2.0))),
        ClusterConfig(n_prefill=3, n_decode=1, links=(mk(4, 0.5),)),
        ClusterConfig(n_prefill=2, n_decode=2, links=(mk(2, 1.0), mk(2, 1.0)),
                      prefix_cache_bytes=float(KV_BYTES_TOK) * 4096),
    ]


def _check_run(sched, done, n, ctx):
    assert len(done) == n, f"{ctx}: {n - len(done)} requests not terminal"
    for r in done:
        assert r.state in TERMINAL, ctx
        if r.state == "completed":
            assert r.tokens_out == r.max_new_tokens, ctx
            assert r.finish_time >= r.transfer_done >= r.link_start \
                >= r.prefill_done >= r.arrival, ctx
    per = [[] for _ in sched.link_busy_by_link]
    for r in done:
        assert len(r.link_ids) == len(r.link_history), ctx
        for li, iv in zip(r.link_ids, r.link_history):
            per[li].append(iv)
    for li, ivals in enumerate(per):
        ivals.sort()
        assert abs(sched.link_busy_by_link[li]
                   - sum(b - a for a, b in ivals)) < 1e-9, ctx
        assert all(b <= a + 1e-12 for (_, b), (a, _) in zip(ivals, ivals[1:])), ctx
    assert abs(sched.link_busy_s - sum(sched.link_busy_by_link)) < 1e-9, ctx
    expected = sum(r.prompt_len * KV_BYTES_TOK * len(r.link_history)
                   for r in done)
    got = sched.transfer_bytes + sched.prefix_hit_bytes
    assert abs(got - expected) <= 1e-6 * max(expected, 1.0), ctx


@pytest.mark.parametrize("router", available_routers())
def test_invariants_over_topologies_and_traces(router):
    for ti, topo in enumerate(_topologies()):
        cluster = ClusterConfig(
            n_prefill=topo.n_prefill, n_decode=topo.n_decode, links=topo.links,
            router=router, prefix_cache_bytes=topo.prefix_cache_bytes)
        for seed in range(2):
            for session_p in (0.0, 0.5):
                ctx = f"topo={ti} router={router} seed={seed} warm={session_p}"
                reqs = _trace(seed, session_p=session_p)
                sched, done = _run(_cfg(cluster=cluster), reqs)
                _check_run(sched, done, len(reqs), ctx)
                if session_p == 0.0 or topo.prefix_cache_bytes is None:
                    assert sched.prefix_hit_bytes == 0.0, ctx


def test_submission_order_determinism():
    topo = _topologies()[1]
    cluster = ClusterConfig(n_prefill=topo.n_prefill, n_decode=topo.n_decode,
                            links=topo.links, router="transfer-aware",
                            prefix_cache_bytes=float(KV_BYTES_TOK) * 8192)
    for seed in range(3):
        _, a = _run(_cfg(cluster=cluster), _trace(seed, session_p=0.5))
        shuffled = _trace(seed, session_p=0.5)
        random.Random(seed).shuffle(shuffled)
        _, b = _run(_cfg(cluster=cluster), shuffled)
        assert sorted(map(_fields, a)) == sorted(map(_fields, b)), seed


def test_routers_place_as_designed():
    # transfer-aware: a lone request takes the fast link
    slow_fast = ClusterConfig(n_prefill=1, n_decode=1,
                              links=(LinkSpec(bw_scale=0.01), LinkSpec()))
    sched, done = _run(_cfg(cluster=slow_fast),
                       [Request(rid=0, arrival=0.0, prompt_len=4096,
                                max_new_tokens=1)])
    assert done[0].link_ids == [1] and sched.link_busy_by_link[0] == 0.0
    # transfer-aware: simultaneous requests spread over decode workers
    three = ClusterConfig(n_prefill=1, n_decode=3, links=(LinkSpec(),))
    _, done = _run(_cfg(cluster=three, decode_time_per_step=5e-2),
                   [Request(rid=i, arrival=0.0, prompt_len=1024,
                            max_new_tokens=8) for i in range(6)])
    assert len({r.worker for r in done}) > 1
    # round-robin cycles workers and links
    rr = ClusterConfig(n_prefill=1, n_decode=2, links=(LinkSpec(), LinkSpec()),
                       router="round-robin")
    sched, done = _run(_cfg(cluster=rr),
                       [Request(rid=i, arrival=i * 1e-5, prompt_len=256,
                                max_new_tokens=1) for i in range(8)])
    assert {r.worker for r in done} == {0, 1}
    assert all(b > 0 for b in sched.link_busy_by_link)


def _warm_cluster(cache_bytes):
    return ClusterConfig(n_prefill=1, n_decode=2, links=(LinkSpec(),),
                         router="transfer-aware",
                         prefix_cache_bytes=cache_bytes)


def test_prefix_hits_cut_shipped_bytes_and_evict_under_pressure():
    warm = lambda: _trace(5, n=24, session_p=0.8)
    s_on, _ = _run(_cfg(cluster=_warm_cluster(1 << 40)), warm())
    s_off, _ = _run(_cfg(cluster=_warm_cluster(None)), warm())
    s_cold, _ = _run(_cfg(cluster=_warm_cluster(1 << 40)),
                     _trace(5, n=24, session_p=0.0))
    assert s_on.prefix_hit_bytes > 0 and s_cold.prefix_hit_bytes == 0.0
    assert s_on.transfer_bytes < s_off.transfer_bytes
    assert s_on.transfer_bytes + s_on.prefix_hit_bytes == pytest.approx(
        s_off.transfer_bytes)
    tiny = float(KV_BYTES_TOK) * 600
    s_tiny, done = _run(_cfg(cluster=_warm_cluster(tiny)), warm())
    _check_run(s_tiny, done, 24, "tiny-cache")
    assert s_tiny.prefix_dir.evictions > 0
    assert s_tiny.prefix_hit_bytes <= s_on.prefix_hit_bytes
