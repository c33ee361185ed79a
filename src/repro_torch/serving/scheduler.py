"""Event-driven, plan-aware request scheduler for disaggregated serving.

The port of ``repro.serving.scheduler``: pure host arithmetic, no device.
Requests arrive with a prompt length and a max-new-tokens budget; the
scheduler batches prefills, ships the produced caches over the PD links,
admits transferred requests into decode slots and retires finished ones.
Time is simulated, with every transfer charged from a real
:class:`~repro_torch.serving.plan.TransferPlan` through
``plan.estimate_time`` on a :class:`CodecProfile` (a calibrated one, such as
``CalibratedProfile.measure``'s, prices the card's codec): the flowshop
over the plan's actual segments (chunked), additive accounting (tensor), or
the native link cost (compression off).  Plans are built once per
prompt-length bucket from the arch's cache structure as ``meta`` tensors
(nothing is allocated), or from a synthetic bf16 stream sized by
``kv_bytes_per_token``; ``SchedulerConfig.plan`` takes an engine's resolved
plan directly (``DisaggregatedEngine.scheduler_config``).

The simulation is an event queue (arrival, prefill-done, transfer-done,
decode-step) over a cluster (:class:`~repro_torch.serving.cluster.ClusterConfig`):

* **prefill workers** — each batches up to ``max_prefill_batch`` arrived
  requests, one batch in flight per worker;
* **links** — each with its own link policy
  (:mod:`repro_torch.serving.policy`) and a profile scaled by its
  ``bw_scale``; a request holds exactly one link per transfer, and busy
  time is conserved per link (``link_busy_by_link``) and in total
  (``link_busy_s``);
* **decode workers** — sharing the global slot budget (ceil-split), in
  lockstep steps of ``decode_time_per_step``; transferred requests wait in
  an admission queue until their worker has a slot.

A :class:`~repro_torch.serving.router.Router` places each prefilled request
on a (link, decode-worker) pair.  With ``cluster.prefix_cache_bytes`` set, a
per-worker :class:`~repro_torch.serving.cluster.PrefixDirectory` lets a
multi-turn request ship only its uncached suffix (``prefix_hit_bytes``).

Failures: per-tier :class:`~repro_torch.distributed.fault_tolerance.FailureDetector`
instances on the simulated clock, and a
:class:`~repro_torch.serving.faults.FaultPlan` (``SchedulerConfig.faults``)
of worker kills and link brownouts.  A dead decode worker's requests fail
over (the cache is re-sent after a capped backoff; ``on_failover`` fires per
re-send, so an attached engine can re-send the real stream with
``DisaggregatedEngine.resend_cache``); a dead prefill worker's batch is
re-queued; a brownout stretches the transfers it overlaps.  Every request
ends in exactly one state: ``'completed'``, ``'failed-over'`` or ``'shed'``.

Given the same transfer durations, a run is identical to the JAX
package's, request by request and in :func:`summarize`.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.codebook import DEFAULT_BF16_CODEBOOK
from repro_torch.core.pipeline import CodecProfile
from repro_torch.distributed.fault_tolerance import FailureDetector, FaultConfig
from repro_torch.models.kvcache import init_cache
from repro_torch.serving.cluster import ClusterConfig, PrefixDirectory, resolve_cluster
from repro_torch.serving.faults import FaultPlan, resolve_faults
from repro_torch.serving.plan import TransferConfig, TransferPlan
from repro_torch.serving.policy import LinkPolicy, get_policy
from repro_torch.serving.router import Router, get_router


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    max_new_tokens: int
    # TTFT deadline (absolute time) for deadline-aware policies; +inf means
    # no SLO — the 'edf' policy then falls back to SchedulerConfig.slo_s
    deadline: float = math.inf
    # filled in by the pipeline:
    prefill_done: float = -1.0
    link_start: float = -1.0         # single link occupancy: [link_start,
    transfer_done: float = -1.0      #                         transfer_done)
    admit_time: float = -1.0         # admitted into a decode slot
    first_token_time: float = -1.0   # TTFT
    finish_time: float = -1.0
    tokens_out: int = 0
    # --- failure semantics ---
    # terminal state, set exactly once when the request leaves the system:
    # 'completed' (served, no failover), 'failed-over' (served, but at least
    # one decode-worker death forced a cache re-fetch), 'shed' (dropped —
    # deadline provably infeasible, or failover budget exhausted)
    state: str = ""
    worker: int = -1                 # decode-worker assignment (-1: none yet)
    failovers: int = 0               # decode-worker deaths survived
    retries: int = 0                 # re-fetch transfers dispatched
    # EVERY link occupancy this request was charged, [link_start,
    # transfer_done) per element — failover re-fetches append here, so
    # conservation (link_busy_s == sum of all intervals, intervals pairwise
    # disjoint) stays checkable across failures
    link_history: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)
    # --- fleet fields ---
    # multi-turn/agentic traffic: session >= 0 groups turns; prefix_len is
    # the token prefix already shipped for this session in earlier turns
    # (the delta-transfer hit candidate); tenant labels the SLO class
    session: int = -1
    prefix_len: int = 0
    tenant: str = ""
    # decode worker this request was ROUTED to (-1: deferred to admission —
    # the legacy router); which link carried each link_history interval
    pinned: int = -1
    link_ids: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SchedulerConfig:
    max_prefill_batch: int = 8
    # flat decode-slot budget; superseded by the HBM-derived capacity below
    # whenever ``hbm_bytes_per_worker`` is set (the capacity win of
    # compressed-resident KV reaches the admission engine)
    max_decode_slots: int = 64
    prefill_time_per_token: float = 2e-6     # model-dependent sim constant
    decode_time_per_step: float = 2e-3
    kv_bytes_per_token: int = 0              # sizes synthetic bucket plans
    profile: Optional[CodecProfile] = None   # codec/link profile
    compress: bool = True
    n_chunks: int = 1                        # segments per bucket plan
    # --- plan-aware admission ---
    # a pre-resolved plan (e.g. DisaggregatedEngine.plan): charged for every
    # request, byte-scaled by prompt_len * kv_bytes_per_token
    plan: Optional[TransferPlan] = None
    # build per-bucket plans from this arch's real cache structure instead of
    # the synthetic kv_bytes_per_token stream
    arch: Optional[ArchConfig] = None
    # codec policy for bucket plans (codebook/backend/layout/caps); enabled is
    # ANDed with ``compress``, n_chunks is overridden by ``n_chunks`` above
    transfer_config: Optional[TransferConfig] = None
    bucket_tokens: int = 1024                # prompt-length bucket granularity
    # expected per-attempt escape-overflow probability: walks the plan's
    # geometric capacity schedule in expectation (extra encode attempts +
    # raw-fallback fraction at full link cost)
    overflow_p: float = 0.0
    # per-bucket overflow priors (bucket tokens -> probability), overriding
    # the scalar ``overflow_p`` for buckets they cover.  Calibrate from a
    # real engine's observed retries: DisaggregatedEngine.overflow_priors()
    overflow_priors: Optional[Dict[int, float]] = None
    # link/admission policy registry key (repro_torch.serving.policy):
    # 'fifo' (default) | 'sjf' | 'edf' | 'spec' — used for the single link
    # of the degenerate topology; an explicit ``cluster`` carries per-link
    # policies instead
    policy: str = "fifo"
    # default TTFT SLO (seconds after arrival) for deadline-aware policies
    # when a Request carries no explicit deadline
    slo_s: Optional[float] = None
    # decode-slot setup cost (KV-block allocation, buffer pinning) paid
    # between slot grant and the slot being decodable.  This is the wait a
    # speculative policy overlaps with the transfer: a slot claimed during
    # the transfer has its setup done by transfer_done, a slot granted at
    # transfer_done pays it afterwards
    admit_latency_s: float = 0.0
    # --- failure semantics ---
    # decode workers sharing max_decode_slots (ceil-split per worker); a
    # worker's death fails its resident requests over to the survivors.
    # Legacy knob: superseded by ``cluster`` (resolve_cluster is the one
    # reader); keyword construction stays supported
    n_decode_workers: int = 1
    # injected fault plan: None | registry name | FaultPlan
    # (repro_torch.serving.faults) — worker kills and link brownouts act here;
    # chunk-level faults act in the TransferSession execution path
    faults: Union[None, str, FaultPlan] = None
    # heartbeat lapse after which the FailureDetector declares a worker
    # (either tier) dead (failure DETECTION latency: requests on a killed
    # worker keep "decoding" until detection, exactly as deployed)
    heartbeat_timeout_s: float = 0.05
    # capped exponential backoff between a detected failure and the re-fetch
    # dispatch: retry k waits min(retry_backoff_s * 2**(k-1),
    # retry_backoff_max_s)
    retry_backoff_s: float = 0.01
    retry_backoff_max_s: float = 1.0
    # failover budget: a request whose worker dies more than this many times
    # is shed instead of retried forever
    max_refetches: int = 4
    # overload shedding of deadline-infeasible queued requests: None defers
    # to the policy's ``sheds`` default ('edf-shed' sheds, others don't);
    # True/False forces it either way
    shed_infeasible: Optional[bool] = None
    # --- HBM-derived decode capacity ---
    # per-decode-worker HBM budget reserved for resident KV.  None keeps the
    # flat ``max_decode_slots``; set, the global slot budget becomes
    # floor(hbm / (resident_bytes_per_token * slot_tokens)) per worker,
    # summed over the fleet — so a compressed-resident deployment's measured
    # footprint ratio (KVPool.resident_ratio) translates directly into more
    # admitted sequences at the same HBM
    hbm_bytes_per_worker: Optional[int] = None
    # measured resident KV footprint per token per sequence: for
    # resident='compressed' use the pool's accounting
    # (KVPool.hbm_bytes / tokens, or bytes_per_token_resident); for
    # resident='raw' the raw cache bytes-per-token.  Required (and > 0)
    # whenever hbm_bytes_per_worker is set.
    resident_bytes_per_token: Optional[float] = None
    # per-slot KV reservation: the max context a resident sequence may grow
    # to while holding its slot
    slot_tokens: int = 4096
    # --- fleet topology ---
    # explicit N-prefill x M-decode topology over heterogeneous links with a
    # registry router; None resolves to the degenerate legacy pipe
    # (repro_torch.serving.cluster.resolve_cluster)
    cluster: Optional[ClusterConfig] = None
    # fired once per ACTUAL failover re-send dispatch (budget not exhausted)
    # with the failing-over Request — the hook an attached engine uses to
    # re-send the real cached compressed stream (resend_cache), so the
    # modeled re-fetch charge and the execution-path bytes stay one event
    on_failover: Optional[Callable[["Request"], None]] = None

    def derived_decode_slots(self) -> int:
        """The effective global decode-slot budget: ``max_decode_slots``
        verbatim, or — when an HBM budget is configured — the number of
        ``slot_tokens``-context sequences whose resident KV fits it."""
        n_decode = resolve_cluster(self).n_decode
        if self.hbm_bytes_per_worker is None:
            return self.max_decode_slots
        bpt = self.resident_bytes_per_token
        if bpt is None or bpt <= 0:
            raise ValueError(
                "hbm_bytes_per_worker needs resident_bytes_per_token > 0 "
                "(measure it: KVPool.hbm_bytes()/tokens for "
                "resident='compressed', raw cache bytes/token otherwise)")
        per_slot = bpt * max(1, self.slot_tokens)
        per_worker = int(self.hbm_bytes_per_worker // per_slot)
        if per_worker < 1:
            # flooring to 1 here would quietly over-commit the stated HBM
            # budget; surface the misconfiguration instead
            raise ValueError(
                f"hbm_bytes_per_worker={self.hbm_bytes_per_worker} fits no "
                f"slot_tokens={self.slot_tokens} sequence at "
                f"resident_bytes_per_token={bpt:g} "
                f"(one slot needs {per_slot:.0f} bytes)")
        return per_worker * n_decode


# same-timestamp event ordering: complete work before starting new work
_PRIO_ARRIVAL, _PRIO_PREFILL, _PRIO_TRANSFER, _PRIO_STEP = range(4)


class DisaggregatedScheduler:
    """Event-driven PD scheduler with a SplitZip-compressed transfer stage."""

    def __init__(self, cfg: SchedulerConfig):
        if (cfg.plan is not None and cfg.profile is not None
                and cfg.kv_bytes_per_token <= 0):
            # scale = 1.0 here would silently charge every prompt length the
            # plan's build-time bytes — a flat, wrong transfer curve
            raise ValueError(
                "SchedulerConfig.plan needs kv_bytes_per_token > 0 to scale "
                "the plan's bytes to each request's prompt length")
        self.cfg = cfg
        self.cluster: ClusterConfig = resolve_cluster(cfg)
        # resolved once: flat max_decode_slots, or the HBM-derived capacity
        # when the config carries a per-worker HBM budget
        self.max_decode_slots = cfg.derived_decode_slots()
        self.router: Router = get_router(self.cluster.router)
        # one link policy per link; ``policy`` stays the link-0 alias for
        # the degenerate topology's single pipe
        self.link_policies: List[LinkPolicy] = [
            get_policy(spec.policy) for spec in self.cluster.links]
        self.policy: LinkPolicy = self.link_policies[0]
        # per-link codec/link profiles: the configured profile verbatim when
        # bw_scale == 1 (same OBJECT — the degenerate topology's float path
        # is bit-identical), else link_bw rescaled.  Heterogeneity is always
        # expressed against the one calibrated profile; no constants here.
        self._profiles: List[Optional[CodecProfile]] = [
            cfg.profile if (cfg.profile is None or spec.bw_scale == 1.0)
            else dataclasses.replace(
                cfg.profile, link_bw=cfg.profile.link_bw * spec.bw_scale)
            for spec in self.cluster.links]
        self.faults: Optional[FaultPlan] = resolve_faults(cfg.faults)
        # (sort-key, rid, Request) heaps: deterministic under any submission
        # interleaving — ties always break on rid.  Transfer queues are
        # plain per-link lists: each link's policy picks its minimum-key
        # member at dispatch time (policy keys end with rid, so picks stay
        # deterministic too).
        self.pending: List[Tuple[float, int, Request]] = []      # by arrival
        self.xfer_queues: List[List[Request]] = [
            [] for _ in self.cluster.links]                      # policy-ordered
        self.admit_queue: List[Tuple[float, int, Request]] = []  # by transfer_done
        self.decoding: List[Request] = []
        self.done: List[Request] = []
        self.plans: Dict[int, TransferPlan] = {}   # bucket tokens -> plan
        self.link_busy_s = 0.0                     # total charged link time
        self.link_busy_by_link: List[float] = [0.0] * self.cluster.n_links
        # failure counters (surfaced by summarize via the done list too)
        self.sheds = 0
        self.failovers = 0
        self.retries = 0
        self.prefill_failovers = 0     # requests re-queued off dead prefill
        # prefix-aware delta transfer: modeled bytes saved/spent
        self.prefix_hit_bytes = 0.0
        self.transfer_bytes = 0.0
        self.prefix_dir: Optional[PrefixDirectory] = (
            PrefixDirectory(self.cluster.n_decode,
                            self.cluster.prefix_cache_bytes)
            if self.cluster.prefix_cache_bytes is not None else None)
        self._events: List[Tuple[float, int, int, tuple]] = []
        self._seq = 0
        self._prefill_busy: List[bool] = [False] * self.cluster.n_prefill
        # the batch a prefill worker is computing (re-queued if it dies) and
        # its epoch (bumped on death: cancels the stale prefill_done event)
        self._prefill_batch: List[Optional[List[Request]]] = (
            [None] * self.cluster.n_prefill)
        self._prefill_epoch: List[int] = [0] * self.cluster.n_prefill
        self._link_busy: List[bool] = [False] * self.cluster.n_links
        self._link_req: List[Optional[Request]] = (
            [None] * self.cluster.n_links)     # in-flight transfer per link
        self._link_end: List[float] = [0.0] * self.cluster.n_links
        self._step_inflight = False
        self._rr: Dict[str, int] = {}              # round-robin router state
        self._dur_cache: Dict[Tuple[int, int], float] = {}  # (link, tokens)
        # fleet health: one FailureDetector per tier
        # (repro_torch.distributed.fault_tolerance), driven by the sim
        # clock.  Workers heartbeat at every event unless a FaultPlan kill
        # has them down; deaths surface through newly_dead() with real
        # detection latency (heartbeat_timeout_s)
        self._now = 0.0
        self.detector = FailureDetector(
            self.cluster.n_decode,
            FaultConfig(heartbeat_timeout_s=cfg.heartbeat_timeout_s),
            clock=lambda: self._now)
        self.prefill_detector = FailureDetector(
            self.cluster.n_prefill,
            FaultConfig(heartbeat_timeout_s=cfg.heartbeat_timeout_s),
            clock=lambda: self._now)
        if self.faults is not None:
            eps = max(1e-9, cfg.heartbeat_timeout_s * 1e-6)
            for k in self.faults.worker_kills:
                bound = (self.cluster.n_decode if k.role == "decode"
                         else self.cluster.n_prefill)
                if k.worker >= bound:
                    continue
                # wake events guarantee the death is detected (and the
                # revival observed) even across an otherwise-idle heap
                self._push(k.at + cfg.heartbeat_timeout_s + eps,
                           _PRIO_ARRIVAL, ("wake",))
                if k.revive_at is not None:
                    self._push(k.revive_at, _PRIO_ARRIVAL, ("wake",))

    def submit(self, req: Request):
        # TTFT is defined by the first decoded token, so every served request
        # decodes at least one step; a non-positive budget is clamped rather
        # than looping forever in the drain
        if req.max_new_tokens < 1:
            req.max_new_tokens = 1
        self._push(req.arrival, _PRIO_ARRIVAL, ("arrival", req))

    # -- plan-aware transfer charging ---------------------------------------
    def _bucket(self, prompt_len: int) -> int:
        b = max(1, self.cfg.bucket_tokens)
        return max(b, -(-prompt_len // b) * b)

    def _bucket_plan(self, bucket: int) -> TransferPlan:
        """Resolve the bucket's TransferPlan once, reuse for every request of
        the bucket (compile-once/run-many, as the engine does per cache
        structure)."""
        plan = self.plans.get(bucket)
        if plan is None:
            tc = self.cfg.transfer_config or TransferConfig(
                codebook=DEFAULT_BF16_CODEBOOK)
            tc = dataclasses.replace(tc, enabled=tc.enabled and self.cfg.compress,
                                     n_chunks=self.cfg.n_chunks)
            # shapes and dtypes only: meta tensors allocate nothing (a
            # long bucket of a large model would be gigabytes)
            if self.cfg.arch is not None:
                structure = init_cache(self.cfg.arch, 1, bucket, device="meta")
            else:
                n = max(1, (bucket * self.cfg.kv_bytes_per_token) // 2)
                structure = {"kv": torch.empty((n,), dtype=torch.bfloat16,
                                               device="meta")}
            plan = TransferPlan.build(structure, tc)
            self.plans[bucket] = plan
        return plan

    def _overflow_prior(self, prompt_len: int) -> float:
        """The expected per-attempt overflow probability for this request's
        bucket: the per-bucket prior when one is calibrated (engine-observed
        ``chunk_retries`` -> ``DisaggregatedEngine.overflow_priors``), else
        the scalar ``overflow_p``."""
        if self.cfg.overflow_priors:
            return self.cfg.overflow_priors.get(self._bucket(prompt_len),
                                                self.cfg.overflow_p)
        return self.cfg.overflow_p

    def _transfer_duration(self, link: int, tokens: int) -> float:
        """One occupancy of ``link`` shipping ``tokens`` tokens of KV,
        charged via ``plan.estimate_time`` on the link's profile: flowshop
        over the plan's actual segments (chunked), additive (tensor), native
        link cost (all-raw), with expected capacity-schedule retries under
        the bucket's overflow prior.  ``tokens`` is the DELTA a prefix-aware
        transfer actually ships (== prompt_len on cold paths).  Memoized per
        (link, tokens) — link policies (e.g. shortest-transfer-first) and
        the router evaluate it for every candidate at every dispatch."""
        cached = self._dur_cache.get((link, tokens))
        if cached is not None:
            return cached
        p = self._profiles[link]
        if p is None:
            return 0.0
        if self.cfg.plan is not None:
            plan = self.cfg.plan
            ref = plan.raw_bytes()
            scale = (float(tokens * self.cfg.kv_bytes_per_token) / ref
                     if ref > 0 else 1.0)
        else:
            if self.cfg.arch is None and self.cfg.kv_bytes_per_token <= 0:
                return 0.0
            bucket = self._bucket(tokens)
            plan = self._bucket_plan(bucket)
            if self.cfg.kv_bytes_per_token > 0:
                scale = (float(tokens * self.cfg.kv_bytes_per_token)
                         / plan.raw_bytes())
            else:
                scale = tokens / bucket
        dur = plan.estimate_time(p, scale=scale,
                                 overflow_p=self._overflow_prior(tokens))
        self._dur_cache[(link, tokens)] = dur
        return dur

    # -- prefix-aware delta transfer -----------------------------------------
    def _token_bytes(self, r: Request) -> float:
        """Modeled raw KV bytes per token for this request — the unit behind
        the prefix directory's capacity accounting and the hit/transfer byte
        counters (0.0 when the config carries no byte scale at all)."""
        if self.cfg.kv_bytes_per_token > 0:
            return float(self.cfg.kv_bytes_per_token)
        if self.cfg.arch is not None:
            bucket = self._bucket(r.prompt_len)
            return self._bucket_plan(bucket).raw_bytes() / bucket
        return 0.0

    def _xfer_tokens(self, r: Request, wid: int) -> int:
        """Tokens this request must actually ship to decode worker ``wid``:
        the full prompt, minus the session prefix already resident there
        (never below 1 — a turn always appends fresh tokens).  Cold paths
        (no directory, no session, no pinned worker) ship everything."""
        if self.prefix_dir is None or r.session < 0 or wid < 0:
            return r.prompt_len
        hit = min(self.prefix_dir.hit_tokens(wid, r.session),
                  r.prefix_len, r.prompt_len)
        return max(1, r.prompt_len - hit)

    def _note_resident(self, wid: int, r: Request, tokens: int) -> None:
        """The session's resident prefix on ``wid`` now spans ``tokens``."""
        if self.prefix_dir is None or r.session < 0 or wid < 0:
            return
        self.prefix_dir.insert(wid, r.session, tokens, self._token_bytes(r))

    # -- router view (duck-typed read surface for Router.place) --------------
    def est_transfer_s(self, r: Request, link: int, wid: int) -> float:
        """Plan-estimated seconds to ship this request's uncached suffix to
        ``wid`` over ``link`` — the router's transfer term."""
        return self._transfer_duration(link, self._xfer_tokens(r, wid))

    def link_backlog_s(self, link: int) -> float:
        """Estimated seconds of work ahead of a new arrival on ``link``:
        the in-flight transfer's remaining wall clock plus every queued
        request's estimated occupancy."""
        busy = max(0.0, self._link_end[link] - self._now) \
            if self._link_busy[link] else 0.0
        return busy + sum(
            self._transfer_duration(link, self._xfer_tokens(q, q.pinned))
            for q in self.xfer_queues[link])

    def decode_load(self, wid: int) -> int:
        """Resident + inbound (routed-but-not-admitted) requests on ``wid``
        — the router's queue-depth term."""
        n = sum(1 for r in self.decoding if r.worker == wid)
        n += sum(1 for _, _, r in self.admit_queue
                 if r.pinned == wid and r.worker < 0)
        for q in self.xfer_queues:
            n += sum(1 for r in q if r.pinned == wid)
        n += sum(1 for r in self._link_req
                 if r is not None and r.pinned == wid and r.worker < 0)
        return n

    def decode_alive(self, wid: int) -> bool:
        return self.detector.workers[wid].alive

    def rr_next(self, kind: str) -> int:
        """Scheduler-owned round-robin counters (router singletons are
        stateless so equal-seed runs stay deterministic)."""
        v = self._rr.get(kind, 0)
        self._rr[kind] = v + 1
        return v

    def _route(self, t: float, r: Request) -> None:
        """Place ``r`` on a (link, decode) pair and queue its transfer."""
        li, wid = self.router.place(r, self)
        r.pinned = wid
        self.xfer_queues[li].append(r)

    # -- the event loop ------------------------------------------------------
    def _push(self, t: float, prio: int, payload: tuple) -> None:
        heapq.heappush(self._events, (t, prio, self._seq, payload))
        self._seq += 1

    def run(self) -> List[Request]:
        """Drain all submitted requests; returns them with timings filled.
        Every returned request is terminal in exactly one state:
        ``'completed'``, ``'failed-over'`` (served despite a decode-worker
        death), or ``'shed'`` (dropped — infeasible deadline or exhausted
        failover budget)."""
        while self._events:
            t = self._events[0][0]
            self._now = t
            # fleet health first: live workers heartbeat at every event
            # time, so the detectors' view lags reality by at most the
            # heartbeat timeout — real detection latency, simulated
            self._heartbeat_alive(t)
            # complete EVERY event at this timestamp before dispatching new
            # work, so resource assignment never depends on heap-push order
            while self._events and self._events[0][0] == t:
                payload = heapq.heappop(self._events)[3]
                self._handle(t, payload)
            for wid in self.detector.newly_dead():
                self._on_worker_death(t, wid)
            for pw in self.prefill_detector.newly_dead():
                self._on_prefill_death(t, pw)
            self._dispatch(t)
        stranded = (len(self.pending) + sum(map(len, self.xfer_queues))
                    + len(self.admit_queue) + len(self.decoding))
        if stranded:
            # e.g. max_decode_slots == 0 or every decode worker permanently
            # dead: admission can never happen and the event heap drains
            # with requests still queued — fail loudly instead of returning
            # a silently partial done list
            raise RuntimeError(
                f"{stranded} request(s) never completed (check "
                "max_decode_slots/max_prefill_batch > 0 and that at least "
                "one worker per tier survives the fault plan)")
        return self.done

    # -- worker fleets -------------------------------------------------------
    def _worker_down(self, wid: int, t: float, role: str = "decode") -> bool:
        """Is worker ``wid`` of ``role`` kill-silenced (not heartbeating)?"""
        if self.faults is None:
            return False
        return any(k.worker == wid and k.role == role and k.at <= t
                   and (k.revive_at is None or t < k.revive_at)
                   for k in self.faults.worker_kills)

    def _heartbeat_alive(self, t: float) -> None:
        for wid in self.detector.workers:
            if not self._worker_down(wid, t, "decode"):
                self.detector.heartbeat(wid)
        for pw in self.prefill_detector.workers:
            if not self._worker_down(pw, t, "prefill"):
                self.prefill_detector.heartbeat(pw)

    def _slots_per_worker(self) -> int:
        return -(-self.max_decode_slots // self.cluster.n_decode)

    def _pick_worker(self) -> Optional[int]:
        """Least-loaded ALIVE decode worker with a free slot (ties break to
        the lowest id), respecting the global ``max_decode_slots`` budget.
        None when no worker can take a request right now."""
        if len(self.decoding) >= self.max_decode_slots:
            return None
        per = self._slots_per_worker()
        loads = {w.worker_id: 0 for w in self.detector.workers.values()
                 if w.alive}
        for r in self.decoding:
            if r.worker in loads:
                loads[r.worker] += 1
        cands = [(load, wid) for wid, load in loads.items() if load < per]
        return min(cands)[1] if cands else None

    def _grant_worker(self, r: Request) -> Optional[int]:
        """The decode worker ``r`` may occupy right now, or None.  A routed
        (pinned) request only ever lands on its pinned worker — its cache is
        being shipped THERE; an unpinned request takes the legacy
        least-loaded-alive pick."""
        if r.pinned < 0:
            return self._pick_worker()
        if len(self.decoding) >= self.max_decode_slots:
            return None
        wid = r.pinned
        if not self.detector.workers[wid].alive:
            return None
        load = sum(1 for q in self.decoding if q.worker == wid)
        return wid if load < self._slots_per_worker() else None

    def _fail_over(self, t: float, r: Request) -> None:
        """The decode-side copy of ``r``'s cache is gone (worker death after
        its transfer completed): charge a failover, and either re-send —
        capped-backoff refetch, re-routed on wake — or shed when the budget
        is exhausted.  Fires ``cfg.on_failover`` per actual re-send so an
        attached engine re-ships the real cached stream."""
        r.worker = -1
        r.failovers += 1
        self.failovers += 1
        if r.failovers > self.cfg.max_refetches:
            self._shed(t, r)
            return
        backoff = min(self.cfg.retry_backoff_s * 2.0 ** (r.failovers - 1),
                      self.cfg.retry_backoff_max_s)
        r.retries += 1
        self.retries += 1
        r.admit_time = -1.0
        r.transfer_done = -1.0
        r.link_start = -1.0
        r.pinned = -1
        if self.cfg.on_failover is not None:
            self.cfg.on_failover(r)
        self._push(t + backoff, _PRIO_ARRIVAL, ("refetch", r))

    def _on_worker_death(self, t: float, wid: int) -> None:
        """Decode worker ``wid`` declared dead: its resident decode state
        and prefix cache are gone.  Requests whose transfer had completed
        (resident, or still queued for admission) FAIL OVER — their
        compressed cache is re-sent (a fresh link occupancy at the same
        ``plan.estimate_time`` charge) after a capped exponential backoff,
        then re-routed to a surviving worker; tokens already emitted are
        kept (they were already streamed).  Requests merely ROUTED here
        whose transfer never started are silently re-routed (nothing was
        lost).  Speculative slot-holders merely lose the slot.  A request
        whose failover budget is exhausted is shed — terminal, never
        silent."""
        if self.prefix_dir is not None:
            self.prefix_dir.drop_worker(wid)
        for r in list(self.decoding):
            if r.worker != wid:
                continue
            self.decoding.remove(r)
            r.worker = -1
            if r.transfer_done < 0:          # speculative hold: no cache lost
                r.admit_time = -1.0
                continue
            self._fail_over(t, r)
        # cache landed on the dead worker but the slot grant hadn't happened
        lost = sorted(k for k in self.admit_queue if k[2].pinned == wid)
        if lost:
            self.admit_queue = [k for k in self.admit_queue
                                if k[2].pinned != wid]
            heapq.heapify(self.admit_queue)
            for _, _, r in lost:
                self._fail_over(t, r)
        # routed here but the transfer never started: the cache is still on
        # the prefill side — re-route, no failover charged
        for li in range(self.cluster.n_links):
            moved = [r for r in self.xfer_queues[li] if r.pinned == wid]
            if not moved:
                continue
            self.xfer_queues[li] = [r for r in self.xfer_queues[li]
                                    if r.pinned != wid]
            for r in moved:
                self._route(t, r)
        # in-flight transfers TO the dead worker are handled at their
        # transfer_done (the dead-destination check there)

    def _on_prefill_death(self, t: float, pw: int) -> None:
        """Prefill worker ``pw`` declared dead mid-batch: bump its epoch
        (cancels the pending ``prefill_done`` event) and re-queue the
        in-flight requests by their original arrival order for a surviving
        worker.  Nothing downstream existed yet — no link or decode state to
        clean up, tokens conserved by construction."""
        self._prefill_epoch[pw] += 1
        batch = self._prefill_batch[pw]
        self._prefill_batch[pw] = None
        self._prefill_busy[pw] = False
        if not batch:
            return
        for r in batch:
            self.prefill_failovers += 1
            heapq.heappush(self.pending, (r.arrival, r.rid, r))

    def _shed_enabled(self, link: int) -> bool:
        if self.cfg.shed_infeasible is not None:
            return self.cfg.shed_infeasible
        return self.link_policies[link].sheds

    def _shed(self, t: float, r: Request) -> None:
        r.state = "shed"
        r.finish_time = t
        self.sheds += 1
        self.done.append(r)

    def _shed_infeasible(self, t: float) -> None:
        """Drop queued requests that PROVABLY cannot meet their deadline:
        even dispatching right now — nominal transfer, then one decode step
        — lands past it.  Only guaranteed losses are shed, so the shed set
        is minimal (any work-conserving policy misses exactly these) and
        the freed link time can only help the survivors."""
        for li in range(self.cluster.n_links):
            if not self.xfer_queues[li] or not self._shed_enabled(li):
                continue
            keep = []
            for r in self.xfer_queues[li]:
                dl = self.link_policies[li].deadline_of(r, self.cfg)
                if (dl != math.inf
                        and t + self._transfer_duration(
                            li, self._xfer_tokens(r, r.pinned))
                        + self.cfg.decode_time_per_step > dl):
                    self._shed(t, r)
                else:
                    keep.append(r)
            self.xfer_queues[li] = keep

    def _handle(self, t: float, payload: tuple) -> None:
        """Complete one event: move the request to the next queue and free
        the resource it held.  Resource (re)assignment happens afterwards in
        :meth:`_dispatch`, once every same-timestamp event has drained."""
        kind = payload[0]
        if kind == "arrival":
            r = payload[1]
            heapq.heappush(self.pending, (r.arrival, r.rid, r))
        elif kind == "prefill_done":
            batch, pw, epoch = payload[1], payload[2], payload[3]
            if epoch != self._prefill_epoch[pw]:
                return   # the worker died mid-batch; requests were re-queued
            self._prefill_busy[pw] = False
            self._prefill_batch[pw] = None
            for r in batch:
                r.prefill_done = t
                self._route(t, r)
        elif kind == "transfer_done":
            r, li = payload[1], payload[2]
            r.transfer_done = t
            r.link_history.append((r.link_start, t))
            r.link_ids.append(li)
            self._link_busy[li] = False
            self._link_req[li] = None
            if r.pinned >= 0 and not self.detector.workers[r.pinned].alive:
                # the cache landed on a worker already declared dead: the
                # bytes are lost — full failover (re-send on wake)
                self._fail_over(t, r)
            elif r.admit_time < 0:
                # speculatively admitted requests (policy 'spec') already
                # hold their decode slot; everyone else queues for admission
                self._note_resident(r.pinned, r, r.prompt_len)
                heapq.heappush(self.admit_queue, (t, r.rid, r))
            else:
                self._note_resident(r.worker, r, r.prompt_len)
        elif kind == "refetch":
            # failover backoff elapsed: the compressed cache is re-routed
            # (the old placement may be dead) and re-enters a transfer
            # queue, competing under that link's normal policy
            self._route(t, payload[1])
        elif kind == "decode_step":
            self._finish_step(t, payload[1])
        # 'wake': no state change — the event exists to force a scheduler
        # pass (heartbeat sweep + death detection) at a fault-plan instant

    def _next_for_link(self, li: int) -> Request:
        """Link ``li``'s policy pick: minimum ``link_key`` over its queued
        requests (keys end with rid — deterministic under ties)."""
        pol = self.link_policies[li]
        r = min(self.xfer_queues[li],
                key=lambda q: pol.link_key(
                    q, self._transfer_duration(
                        li, self._xfer_tokens(q, q.pinned)), self.cfg))
        # remove by identity, not list.remove: Request is an eq-by-value
        # dataclass, so two field-identical requests would otherwise have one
        # dispatched twice and the other silently dropped
        for i, q in enumerate(self.xfer_queues[li]):
            if q is r:
                del self.xfer_queues[li][i]
                break
        return r

    def _dispatch(self, t: float) -> None:
        """Start whatever each idle resource can pick up at time ``t``.

        This is the policy's dispatch point: each idle link takes its
        policy-minimal queued request, the decode fleet drains the
        admission queue into free slots (completed transfers always first),
        and — only under a speculative link policy — that link's in-flight
        transfer may claim a slot that is STILL free after that drain."""
        for pw in range(self.cluster.n_prefill):
            if not self.pending:
                break
            if (self._prefill_busy[pw]
                    or not self.prefill_detector.workers[pw].alive):
                continue
            batch = []
            while self.pending and len(batch) < self.cfg.max_prefill_batch:
                batch.append(heapq.heappop(self.pending)[2])
            dur = (max(r.prompt_len for r in batch)
                   * self.cfg.prefill_time_per_token)
            self._prefill_busy[pw] = True
            self._prefill_batch[pw] = batch
            self._push(t + dur, _PRIO_PREFILL,
                       ("prefill_done", batch, pw, self._prefill_epoch[pw]))
        self._shed_infeasible(t)
        for li in range(self.cluster.n_links):
            if self._link_busy[li] or not self.xfer_queues[li]:
                continue
            r = self._next_for_link(li)
            r.link_start = t
            tokens = self._xfer_tokens(r, r.pinned)
            dur = self._transfer_duration(li, tokens)
            end = t + dur
            if self.faults is not None:
                # link brownout: the same bytes at the degraded piecewise
                # rate — the link is HELD for the full wall-clock interval,
                # so occupancy stays conserved (link_busy_s == Σ intervals)
                end = self.faults.link_wall_clock(t, dur, li)
            self.link_busy_s += end - t
            self.link_busy_by_link[li] += end - t
            bpt = self._token_bytes(r)
            self.transfer_bytes += tokens * bpt
            if tokens < r.prompt_len:
                self.prefix_hit_bytes += (r.prompt_len - tokens) * bpt
            self._link_busy[li] = True
            self._link_req[li] = r
            self._link_end[li] = end
            self._push(end, _PRIO_TRANSFER, ("transfer_done", r, li))
        overflow = []    # pinned requests whose worker is momentarily full
        while self.admit_queue:
            r = self.admit_queue[0][2]
            w = self._grant_worker(r)
            if w is None:
                if r.pinned < 0:
                    # unpinned head blocked == every alive worker is at
                    # capacity (or the global budget is) — strict
                    # head-of-line, exactly the legacy admission order
                    break
                overflow.append(heapq.heappop(self.admit_queue))
                continue
            heapq.heappop(self.admit_queue)
            r.admit_time = t
            r.worker = w
            self.decoding.append(r)
        for item in overflow:
            heapq.heappush(self.admit_queue, item)
        for li in range(self.cluster.n_links):
            r = self._link_req[li]
            if (r is None or not self.link_policies[li].speculative
                    or r.admit_time >= 0):
                continue
            # speculative admission: the transferring request pre-claims a
            # LEFTOVER slot (never outranks a completed transfer above), so
            # its decode-slot wait overlaps its transfer
            w = self._grant_worker(r)
            if w is not None:
                r.admit_time = t
                r.worker = w
                self.decoding.append(r)
        # the decode worker only ticks when some slot can actually produce a
        # token: a population of purely speculative slot-holders (transfers
        # still in flight) must not start the lockstep clock early, or a
        # misaligned step boundary would DELAY their first token
        if (not self._step_inflight
                and any(r.transfer_done >= 0 for r in self.decoding)):
            self._step_inflight = True
            self._push(t + self.cfg.decode_time_per_step, _PRIO_STEP,
                       ("decode_step", t))

    def _finish_step(self, t: float, step_start: float) -> None:
        """One lockstep decode step [step_start, t] completed: every slot
        that was READY by step_start gains a token — ready means the
        transfer completed AND the slot's setup (``admit_latency_s`` after
        the grant) finished.  Later joiners start with the next step;
        speculative slot-holders whose transfer is still pending produce
        nothing.  Finished requests retire and free their slots."""
        self._step_inflight = False
        lat = self.cfg.admit_latency_s
        for r in list(self.decoding):
            if r.admit_time > step_start or r.admit_time + lat > step_start:
                continue   # not granted / slot setup still running
            if r.transfer_done < 0 or r.transfer_done > step_start:
                continue   # speculative hold: cache not on this worker yet
            r.tokens_out += 1
            if r.first_token_time < 0:
                r.first_token_time = t
            if r.tokens_out >= r.max_new_tokens:
                r.finish_time = t
                r.state = "failed-over" if r.failovers else "completed"
                # the retiring session's KV (prompt + generation) stays
                # resident until evicted — the next turn's delta baseline
                self._note_resident(r.worker, r,
                                    r.prompt_len + r.tokens_out)
                self.decoding.remove(r)
                self.done.append(r)


def summarize(done: List[Request]) -> Dict[str, float]:
    """Aggregate a drained run.  Latency/throughput statistics cover SERVED
    requests only (``completed`` + ``failed-over``) — a shed request has no
    TTFT and averaging it in would reward shedding; the failure-plane
    outcome counts sit alongside so nothing disappears from the report."""
    if not done:
        return {}
    served = [r for r in done if r.state != "shed"]
    counts = {
        "n_shed": float(len(done) - len(served)),
        "n_failed_over": float(sum(1 for r in served
                                   if r.state == "failed-over")),
        "n_failovers": float(sum(r.failovers for r in done)),
        "n_retries": float(sum(r.retries for r in done)),
    }
    if not served:
        return {"n": 0, **counts}
    ttfts = sorted(r.first_token_time - r.arrival for r in served)
    n = len(ttfts)
    # nearest-rank (ceil) quantile: 1-based rank ceil(q*n); the old floor
    # index int(q*(n-1)) underestimated the tail for small n
    p99 = ttfts[min(n - 1, max(0, math.ceil(0.99 * n) - 1))]
    total_tokens = sum(r.tokens_out for r in served)
    makespan = (max(r.finish_time for r in served)
                - min(r.arrival for r in served))
    return {
        "n": len(served),
        "mean_ttft_s": sum(ttfts) / n,
        "p99_ttft_s": p99,
        "throughput_tok_s": total_tokens / makespan if makespan > 0 else 0.0,
        "throughput_req_s": len(served) / makespan if makespan > 0 else 0.0,
        **counts,
    }
