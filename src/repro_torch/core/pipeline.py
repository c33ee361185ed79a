"""Pipeline-overlap model for the PD transfer path (paper Appendix A).

For one pipeline chunk of raw size S with compression ratio rho, codec
throughputs G_enc/G_dec and physical link bandwidth B:

    T_enc = S / G_enc,  T_xfer = S / (rho * B),  T_dec = S / G_dec

Steady state: T_pipe = max(T_enc, T_xfer, T_dec); codec overhead is fully
hidden iff B <= B_hide = min(G_enc, G_dec) / rho.

This module also provides the additive accounting the paper uses for the
Fig. 4 transmission breakdown, and the chunked-pipeline schedule used by the
transfer engine to overlap encode / transfer / decode.  Pure Python: a copy
of ``repro.core.pipeline``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class CodecProfile:
    """Measured or assumed codec/link characteristics (all bytes/s).

    ``source`` records provenance: ``"paper-h200"`` for the paper's datasheet
    constants, ``"measured:<backend>/<fmt>"`` for profiles calibrated from a
    real codec run, ``"assumed"`` for hand-built test fixtures.  Every scheduler/benchmark number inherits the profile it
    was charged with, so the provenance string is what makes a what-if sweep
    auditable."""

    g_enc: float          # compression throughput (vs uncompressed bytes)
    g_dec: float          # decompression throughput
    ratio: float          # compression ratio rho
    link_bw: float        # physical link bandwidth for compressed bytes
    fixed_overhead_s: float = 0.0  # per-transfer launch/setup cost
    source: str = "assumed"        # provenance (see repro.core.profile)


def stage_times(s_bytes: float, p: CodecProfile) -> Tuple[float, float, float]:
    t_enc = s_bytes / p.g_enc
    t_xfer = s_bytes / (p.ratio * p.link_bw)
    t_dec = s_bytes / p.g_dec
    return t_enc, t_xfer, t_dec


def additive_transfer_time(s_bytes: float, p: CodecProfile) -> float:
    """Paper Fig. 4 accounting: encode + compressed transfer + decode."""
    return sum(stage_times(s_bytes, p)) + p.fixed_overhead_s


def native_transfer_time(s_bytes: float, p: CodecProfile) -> float:
    return s_bytes / p.link_bw + p.fixed_overhead_s


def pipelined_transfer_time(s_bytes: float, p: CodecProfile, n_chunks: int) -> float:
    """Chunked steady-state pipeline: fill + (n-1) * bottleneck + drain."""
    if n_chunks <= 0:
        raise ValueError("n_chunks must be >= 1")
    per = s_bytes / n_chunks
    t_enc, t_xfer, t_dec = stage_times(per, p)
    bottleneck = max(t_enc, t_xfer, t_dec)
    return t_enc + t_xfer + t_dec + (n_chunks - 1) * bottleneck + p.fixed_overhead_s


def flowshop_makespan(chunk_stage_times: Sequence[Tuple[float, float, float]]
                      ) -> float:
    """3-stage flowshop recurrence over per-chunk (enc, xfer, dec) times:

        done_enc[i]  = done_enc[i-1] + T_enc[i]
        done_xfer[i] = max(done_xfer[i-1], done_enc[i])  + T_xfer[i]
        done_dec[i]  = max(done_dec[i-1], done_xfer[i]) + T_dec[i]
    """
    d_enc = d_xfer = d_dec = 0.0
    for t_enc, t_xfer, t_dec in chunk_stage_times:
        d_enc = d_enc + t_enc
        d_xfer = max(d_xfer, d_enc) + t_xfer
        d_dec = max(d_dec, d_xfer) + t_dec
    return d_dec


def pipeline_makespan(chunk_bytes: Sequence[float], p: CodecProfile) -> float:
    """Plan-aware pipeline time: the flowshop recurrence over the ACTUAL
    per-chunk raw byte sizes a :class:`~repro.serving.plan.TransferPlan`
    resolved (segments are codec-chunk aligned, so the last one is usually
    short; equal-size chunks reduce to ``pipelined_transfer_time`` exactly).
    """
    if not chunk_bytes:
        return p.fixed_overhead_s
    return flowshop_makespan([stage_times(s, p) for s in chunk_bytes]
                             ) + p.fixed_overhead_s


def expected_schedule_attempts(n_attempts: int,
                               overflow_p: float) -> Tuple[float, float]:
    """``(expected encode attempts, raw-fallback fraction)`` for a capacity
    schedule of ``n_attempts`` steps when each attempt independently overflows
    with probability ``overflow_p``.

    Attempt k+1 runs iff all k previous attempts overflowed, so the expected
    attempt count is the truncated geometric series ``sum p^k``; the schedule
    exhausts (raw fallback, full link cost) with probability ``p^K``."""
    p = min(max(overflow_p, 0.0), 1.0)
    if p <= 0.0 or n_attempts <= 0:
        return (1.0 if n_attempts > 0 else 0.0), 0.0
    return sum(p ** k for k in range(n_attempts)), p ** n_attempts


def degraded_stage_times(s_bytes: float, p: CodecProfile, *,
                         attempts: float = 1.0,
                         raw_frac: float = 0.0) -> Tuple[float, float, float]:
    """:func:`stage_times` under capacity-schedule expectations: the encoder
    re-runs ``attempts`` times on average, and a ``raw_frac`` fraction of the
    bytes exhausts the schedule — shipping raw at FULL link cost with no
    decode.  ``attempts=1, raw_frac=0`` reduces to :func:`stage_times`."""
    t_enc = attempts * s_bytes / p.g_enc
    t_xfer = s_bytes * ((1.0 - raw_frac) / (p.ratio * p.link_bw)
                        + raw_frac / p.link_bw)
    t_dec = (1.0 - raw_frac) * s_bytes / p.g_dec
    return t_enc, t_xfer, t_dec


def hiding_bandwidth(p: CodecProfile) -> float:
    """B_hide = min(G_enc, G_dec) / rho  (Appendix A)."""
    return min(p.g_enc, p.g_dec) / p.ratio


def speedup(s_bytes: float, p: CodecProfile, pipelined: bool = False,
            n_chunks: int = 8) -> float:
    base = native_transfer_time(s_bytes, p)
    ours = (pipelined_transfer_time(s_bytes, p, n_chunks)
            if pipelined else additive_transfer_time(s_bytes, p))
    return base / ours


def theoretical_opt_speedup(p: CodecProfile) -> float:
    """Zero codec overhead, zero escapes: speedup == rho (paper Fig. 3)."""
    return p.ratio


@dataclasses.dataclass(frozen=True)
class ChunkSchedule:
    """An explicit overlapped schedule for the transfer engine: at step t the
    engine encodes chunk t, transfers chunk t-1 and decodes chunk t-2.

    Driven by the local chunked executor of
    :class:`repro_torch.serving.session.TransferSession`."""

    n_chunks: int

    def stages(self) -> List[Tuple[int, int, int]]:
        out = []
        for t in range(self.n_chunks + 2):
            enc = t if t < self.n_chunks else -1
            xfer = t - 1 if 0 <= t - 1 < self.n_chunks else -1
            dec = t - 2 if 0 <= t - 2 < self.n_chunks else -1
            out.append((enc, xfer, dec))
        return out
