"""Disaggregated serving engine: prefill worker -> SplitZip transfer -> decode
worker, as one orchestrated pipeline (the port of ``repro.serving.engine``).

Both workers run in-process on one device; the transfer is a real
compress -> (in-process wire) -> decompress roundtrip through the codec
backend, so the bit-exactness of the whole serving path is checked end to
end.  The engine builds ONE :class:`~repro_torch.serving.plan.TransferPlan`
per cache structure and executes it through a cached
:class:`~repro_torch.serving.session.TransferSession` on every ``transfer``.
``n_chunks == 1`` runs the whole-tensor executor, ``n_chunks > 1`` the
chunked pipelined one.

Two residencies on the decode side:

* ``resident="raw"``: the received streams decode once and decode runs over
  the raw cache;
* ``resident="compressed"``: the received streams are admitted into a paged
  :class:`~repro_torch.models.kvpool.KVPool` without rehydration and decode
  attends over the pages directly (the paged attention kernels).  An
  inadmissible stream (raw-fallback leaf, layout or codebook drift, page
  escape overflow, a cache length that is not a page multiple) demotes the
  batch to raw residency; losslessness holds either way.

The transfer stage takes the session's wire-integrity knobs: ``verify=True``
checksum-verifies every wire hop (re-fetch on failure), ``faults=`` injects
a seeded :class:`~repro_torch.serving.faults.FaultPlan`, and
``retain_for_failover=True`` keeps the last payload so :meth:`resend_cache`
can re-ship it to a replacement decode worker without re-encoding.
``profile=`` (a :class:`~repro_torch.core.pipeline.CodecProfile`) prices
the transfers in :meth:`transfer_report`.

``prefix_cache_bytes=`` (chunked path, compression on) turns on
prefix-delta transfer: ``transfer(state, session_id=...)`` ships only the
segments that changed since that session's last turn
(``TransferSession.transfer_delta``).  :meth:`scheduler_config` hands the
engine's plan, transfer policy and observed overflow to the event
scheduler (:mod:`repro_torch.serving.scheduler`).

The engine runs on the card unless the caller passes ``device=``; without
CUDA it raises.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import WireBackend, get_backend
from repro_torch.core.codebook import Codebook
from repro_torch.core.pipeline import CodecProfile
from repro_torch.device import resolve_device
from repro_torch.models import kvcache as KC
from repro_torch.models import kvpool as KVP
from repro_torch.models.kvcache import DecodeState
from repro_torch.serving.decode import decode_loop, resident_decode_loop
from repro_torch.serving.plan import TransferConfig, TransferPlan
from repro_torch.serving.prefill import PrefillOutput, prefill_step
from repro_torch.serving.session import TransferSession, decode_leaves
from repro_torch.serving.transfer import (TransferReport, raw_wire_bytes,
                                          transfer_report)

if TYPE_CHECKING:  # the scheduler imports nothing of the engine
    from repro_torch.serving.scheduler import SchedulerConfig


@dataclasses.dataclass
class EngineStats:
    raw_cache_bytes: float = 0.0
    wire_bytes: float = 0.0
    prefill_calls: int = 0
    decode_tokens: int = 0
    codec_ok: bool = True
    # per-chunk wire bytes, one entry per pipeline chunk per transfer call
    # (chunked mode only; the whole-tensor path leaves this empty)
    chunk_wire_bytes: List[float] = dataclasses.field(default_factory=list)
    # units (chunks/tensors) re-encoded on the geometric capacity schedule
    chunk_retries: int = 0
    # total extra encode attempts across the schedule
    chunk_retry_steps: int = 0
    # fp32 hi/lo route: raw lo halves shipped alongside the stream
    fp32_lo_wire_bytes: float = 0.0
    # encoded units (chunks + leaves) that went down the capacity schedule —
    # the denominator for the observed overflow probability
    encoded_units: int = 0
    # per-prompt-length overflow observations: cache_len -> [units, retried]
    # (bucketed by DisaggregatedEngine.overflow_priors)
    overflow_obs: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    # verified delivery (verify=True / faults= engines): checksum mismatches
    # seen, re-fetches issued, re-fetches that shipped raw, faults injected
    verify_failures: int = 0
    refetches: int = 0
    raw_refetches: int = 0
    faults_injected: int = 0
    # compressed-resident KV (resident="compressed"): batches admitted into
    # the paged pool without rehydration, batches demoted to raw residency
    # (unsupported stream, escape overflow, pool exhaustion), and the pool's
    # device footprint vs what the same cache costs raw-resident
    resident_admits: int = 0
    resident_demotions: int = 0
    resident_hbm_bytes: float = 0.0
    resident_raw_bytes: float = 0.0
    # failover: retained-payload re-sends (retain_for_failover=True engines)
    failover_resends: int = 0
    # prefix-delta transfer: raw bytes the destination already held, which
    # the wire therefore never carried (not in wire_bytes)
    prefix_hit_bytes: float = 0.0

    @property
    def resident_ratio(self) -> float:
        """raw-resident / compressed-resident device bytes: the decode
        worker's capacity multiplier."""
        return self.resident_raw_bytes / max(self.resident_hbm_bytes, 1.0)

    @property
    def transfer_ratio(self) -> float:
        return self.raw_cache_bytes / max(self.wire_bytes, 1.0)

    @property
    def observed_overflow_p(self) -> float:
        """Fraction of encoded units whose FIRST attempt overflowed — the
        maximum-likelihood estimate of the per-attempt overflow probability
        the plan's capacity-schedule expectation takes."""
        if self.encoded_units <= 0:
            return 0.0
        return self.chunk_retries / self.encoded_units


class DisaggregatedEngine:
    """Local PD engine with a real compressed transfer stage."""

    def __init__(self, cfg: ArchConfig, params, codebook: Codebook,
                 *, compress: bool = True, chunk: int = 1024, cap: int = 64,
                 backend: str = "auto", n_chunks: int = 1,
                 compress_fp32: bool = False,
                 profile: Optional[CodecProfile] = None,
                 verify: bool = False, faults=None,
                 resident: str = "raw", page_bytes: Optional[int] = None,
                 retain_for_failover: bool = False,
                 prefix_cache_bytes: Optional[float] = None, device=None):
        if resident not in ("raw", "compressed"):
            raise ValueError(f"resident={resident!r}: expected 'raw' or "
                             "'compressed'")
        if resident == "compressed":
            # the pool consumes page-addressable whole-tensor streams, with
            # compression actually on
            if n_chunks != 1:
                raise ValueError("resident='compressed' requires n_chunks=1 "
                                 "(chunked streams are not page-addressable)")
            if not compress:
                raise ValueError("resident='compressed' requires compress=True")
            if isinstance(get_backend(backend), WireBackend):
                raise ValueError("resident='compressed' needs the codec's "
                                 "streams; the wire backend ships bytes")
        if retain_for_failover and n_chunks != 1:
            raise ValueError("retain_for_failover requires n_chunks=1 (only "
                             "tensor-path payloads are retained)")
        if prefix_cache_bytes is not None:
            if n_chunks <= 1:
                raise ValueError("prefix_cache_bytes requires n_chunks > 1 "
                                 "(delta granularity is the chunked "
                                 "segmentation)")
            if not compress:
                raise ValueError("prefix_cache_bytes requires compress=True")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.tc = TransferConfig(codebook=codebook, chunk=chunk, cap=cap,
                                 enabled=compress, backend=backend,
                                 n_chunks=n_chunks, compress_fp32=compress_fp32)
        self.profile = profile
        # wire-integrity knobs, passed through to every TransferSession
        self.verify = verify
        self.faults = faults
        self.retain_for_failover = retain_for_failover
        self.resident = resident
        self.page_bytes = page_bytes
        self.prefix_cache_bytes = prefix_cache_bytes
        self.stats = EngineStats()
        self._session: Optional[TransferSession] = None
        self._pool: Optional[KVP.KVPool] = None   # pool of the last admission

    # -- plan/session caching ------------------------------------------------
    def _session_for(self, cache) -> TransferSession:
        """Build the TransferPlan once per cache structure and reuse its
        session; the ``plan.matches`` walk doubles as the structure check."""
        if self._session is None or not self._session.plan.matches(cache):
            self._session = TransferPlan.build(cache, self.tc).session(
                verify=self.verify, faults=self.faults,
                retain_last=self.retain_for_failover)
            if self.prefix_cache_bytes is not None:
                self._session.enable_prefix_cache(self.prefix_cache_bytes)
        return self._session

    @property
    def plan(self) -> Optional[TransferPlan]:
        return self._session.plan if self._session is not None else None

    def describe_plan(self) -> str:
        """The resolved per-leaf routing table (empty before first transfer)."""
        return self.plan.describe() if self.plan is not None else "(no plan yet)"

    def overflow_priors(self, bucket_tokens: int = 1024) -> Dict[int, float]:
        """Per-bucket overflow priors from this engine's observed retries:
        the per-length observations of ``EngineStats.overflow_obs`` bucketed
        at ``bucket_tokens``, each bucket's fraction of encoded units that
        needed a re-encode.  Buckets with no observations are absent."""
        b = max(1, bucket_tokens)
        agg: Dict[int, List[int]] = {}
        for length, (units, retried) in self.stats.overflow_obs.items():
            bucket = max(b, -(-length // b) * b)
            acc = agg.setdefault(bucket, [0, 0])
            acc[0] += units
            acc[1] += retried
        return {bucket: retried / units
                for bucket, (units, retried) in agg.items() if units > 0}

    def scheduler_config(self, profile: Optional[CodecProfile] = None,
                         **overrides) -> "SchedulerConfig":
        """A :class:`~repro_torch.serving.scheduler.SchedulerConfig` that
        charges transfers through THIS engine's transfer policy: its resolved
        :class:`TransferPlan` when one exists (else per-bucket plans from its
        ``TransferConfig``), ``profile`` (default: the engine's), and its
        observed overflow as the expected-retry model (``overflow_p``, plus
        per-bucket ``overflow_priors`` when there are per-length
        observations).  Any other field passes through ``overrides``."""
        from repro_torch.serving.scheduler import SchedulerConfig
        kw = dict(profile=profile if profile is not None else self.profile,
                  plan=self.plan, transfer_config=self.tc,
                  compress=self.tc.enabled,
                  n_chunks=max(1, self.tc.n_chunks),
                  overflow_p=self.stats.observed_overflow_p)
        kw.update(overrides)
        if "overflow_priors" not in overrides and self.stats.overflow_obs:
            kw["overflow_priors"] = self.overflow_priors(
                kw.get("bucket_tokens", SchedulerConfig.bucket_tokens))
        return SchedulerConfig(**kw)

    # -- the three pipeline stages ------------------------------------------
    def prefill(self, batch: Dict, max_seq: Optional[int] = None) -> PrefillOutput:
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        out = prefill_step(self.params, batch, self.cfg, max_seq=max_seq)
        self.stats.prefill_calls += 1
        return out

    def transfer(self, state: DecodeState,
                 session_id: Optional[int] = None) -> DecodeState:
        """Compress -> ship -> decompress.  Bit-exact by construction.

        Escape-capacity overflow walks the plan's geometric capacity schedule
        and then falls back to raw — per tensor on the whole-tensor path, per
        chunk on the pipelined path — and the accounting charges raw bytes
        for exactly the payload that shipped raw.

        ``session_id`` (with ``prefix_cache_bytes`` set) routes the call
        through the prefix-delta path: segments the destination already
        holds for that session stay off the wire, and their raw size lands
        in ``EngineStats.prefix_hit_bytes``."""
        raw = raw_wire_bytes(state.cache)
        self.stats.raw_cache_bytes += raw
        if not self.tc.enabled or not state.cache:
            self.stats.wire_bytes += raw
            return state
        sess = self._session_for(state.cache)
        if self.resident == "compressed":
            return self._transfer_resident(sess, state)
        if session_id is not None and self.prefix_cache_bytes is not None:
            cache = sess.transfer_delta(state.cache, session_id, check=False)
        else:
            cache = sess.transfer(state.cache, check=False)
        self._absorb_transfer_stats(sess.last_stats, state)
        return DecodeState(cache=cache, cache_len=state.cache_len)

    def resend_cache(self, state: DecodeState) -> DecodeState:
        """Failover re-send: re-ship the last transfer's retained payload to
        a replacement decode worker (``retain_for_failover=True`` engines):
        one wire hop, no re-encode, and a cache bit-identical to what the
        lost worker held."""
        if not self.tc.enabled or not state.cache:
            return state
        sess = self._session_for(state.cache)
        cache = sess.resend_last()
        self.stats.failover_resends += 1
        self.stats.raw_cache_bytes += raw_wire_bytes(state.cache)
        self._absorb_transfer_stats(sess.last_stats, state)
        return DecodeState(cache=cache, cache_len=state.cache_len)

    def _absorb_transfer_stats(self, cstats, state: DecodeState) -> None:
        self.stats.wire_bytes += cstats.wire_bytes
        self.stats.codec_ok &= cstats.all_ok
        self.stats.chunk_retries += cstats.n_retries
        self.stats.chunk_retry_steps += cstats.n_retry_steps
        self.stats.fp32_lo_wire_bytes += cstats.fp32_lo_wire_bytes
        self.stats.prefix_hit_bytes += cstats.prefix_hit_bytes
        self.stats.verify_failures += cstats.verify_failures
        self.stats.refetches += cstats.refetches
        self.stats.raw_refetches += cstats.raw_refetches
        self.stats.faults_injected += cstats.faults_injected
        # overflow observations, keyed by the transferred prompt length: the
        # raw material for the per-bucket overflow priors
        units = len(cstats.chunk_retried)
        if units:
            self.stats.encoded_units += units
            lens = torch.as_tensor(state.cache_len)
            length = int(lens.max()) if lens.numel() else 0
            obs = self.stats.overflow_obs.setdefault(length, [0, 0])
            obs[0] += units
            obs[1] += cstats.n_retries
        if self.tc.n_chunks > 1:
            self.stats.chunk_wire_bytes.extend(cstats.chunk_wire_bytes)

    def resident_tokens_per_page(self, batch: int = 1) -> int:
        """Page granularity the pool uses for this arch (the cache length
        must be a multiple; ``generate`` rounds it up)."""
        cache = KC.init_cache(self.cfg, batch, 8 * self.tc.chunk, device="meta")
        return KVP.tokens_per_page_for(
            cache, self.tc.chunk, self.page_bytes or KVP.DEFAULT_PAGE_BYTES)

    def resident_max_seq(self, max_seq: int) -> int:
        """``max_seq`` rounded up to a page multiple for a compressed-resident
        engine (pages are fixed-size); unchanged for raw residency."""
        if self.resident != "compressed":
            return max_seq
        tp = self.resident_tokens_per_page()
        return -(-max_seq // tp) * tp

    def _transfer_resident(self, sess: TransferSession, state: DecodeState):
        """Admit the wire streams into a paged pool, without rehydration.

        Any inadmissible stream demotes THIS batch to raw residency: the
        received streams decode once and decode runs over the raw cache."""
        comp, raw = sess.transfer_compressed(state.cache, check=False)
        self._absorb_transfer_stats(sess.last_stats, state)
        backend = sess.plan.backend
        try:
            pool = KVP.KVPool.for_cache(
                state.cache, self.tc.codebook, backend, chunk=self.tc.chunk,
                page_bytes=self.page_bytes or KVP.DEFAULT_PAGE_BYTES)
            rst = pool.admit_from_wire(comp, state.cache_len)
        except KVP.ResidencyError:
            self.stats.resident_demotions += 1
            cache = decode_leaves(comp, raw, state.cache, backend)
            return DecodeState(cache=cache, cache_len=state.cache_len)
        self._pool = pool
        self.stats.resident_admits += 1
        self.stats.resident_hbm_bytes += pool.hbm_bytes()
        self.stats.resident_raw_bytes += pool.raw_bytes()
        return rst

    def decode(self, first_token: torch.Tensor, state, num_steps: int
               ) -> torch.Tensor:
        """Greedy decode of ``num_steps`` tokens from a raw ``DecodeState``
        or an admitted ``ResidentState``."""
        if isinstance(state, KVP.ResidentState):
            toks, _, demoted = resident_decode_loop(
                self.params, first_token, state, self._pool, self.cfg,
                num_steps)
            self.stats.resident_demotions += int(demoted)
        else:
            toks, _ = decode_loop(self.params, first_token, state, self.cfg,
                                  num_steps)
        self.stats.decode_tokens += int(toks.numel())
        return toks

    # -- end-to-end ----------------------------------------------------------
    def generate(self, batch: Dict, num_steps: int,
                 max_seq: Optional[int] = None) -> torch.Tensor:
        """prompt batch -> (B, 1 + num_steps) generated ids (greedy).

        A compressed-resident engine pads the cache to a page multiple of
        ``max_seq`` (default: prompt + first token + steps); prefill's own
        default, the raw prompt length, is almost never page-aligned."""
        if self.resident == "compressed":
            max_seq = self.resident_max_seq(
                max_seq or batch["tokens"].shape[1] + 1 + num_steps)
        pre = self.prefill(batch, max_seq=max_seq)
        state = self.transfer(pre.state)
        toks = self.decode(pre.first_token, state, num_steps)
        return torch.cat([pre.first_token[:, None], toks], dim=1)

    def transfer_report(self) -> Optional[TransferReport]:
        """The analytic transfer report of everything this engine shipped,
        priced with ``profile`` (None without one)."""
        if self.profile is None:
            return None
        return transfer_report(self.stats.raw_cache_bytes,
                               self.stats.wire_bytes, self.profile,
                               n_chunks=self.tc.n_chunks, plan=self.plan)
