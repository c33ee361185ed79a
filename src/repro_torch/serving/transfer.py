"""KV-cache transfer accounting and the one-shot shims.

The port of ``repro.serving.transfer``.  The transfer API is the
compile-once / run-many pair ``TransferPlan.build(...).session()``; this
module keeps the historical one-shot entry points — ``compress_cache`` /
``decompress_cache`` (whole-tensor) and ``transfer_cache_chunked`` (local
pipelined) — as thin shims that build a one-shot plan and run it, and holds
the analytic accounting: ``transfer_report`` (paper Fig. 3 / Fig. 4),
``compressed_wire_bytes`` and ``raw_wire_bytes``.  The
:class:`~repro_torch.core.pipeline.CodecProfile` a report takes comes from
:mod:`repro_torch.core.profile` (a calibrated ``profiles.json`` or the
paper's figures).

``transfer_cache_cross_pod`` is the shim over a one-shot mesh plan; its
JAX ``return_hlo`` (the lowered XLA program) has no counterpart and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import codec as C
from repro_torch.core import tree as TR
from repro_torch.core.backend import get_backend
from repro_torch.core.pipeline import CodecProfile, flowshop_makespan
from repro_torch.serving.plan import (TransferConfig, TransferPlan,
                                      TransferStats, leaf_key)
from repro_torch.serving.session import (TransferSession, _backend_for,
                                         decode_leaves, encode_leaves)

__all__ = [
    "TransferConfig", "TransferPlan", "TransferSession", "TransferStats",
    "leaf_key", "compress_cache", "decompress_cache", "compressed_wire_bytes",
    "raw_wire_bytes", "split_cache_segments", "transfer_cache_chunked",
    "transfer_cache_cross_pod", "TransferReport", "transfer_report",
]


# ---------------------------------------------------------------------------
# whole-tensor shims
# ---------------------------------------------------------------------------

def compress_cache(cache: Dict, tc: TransferConfig) -> Tuple[Dict, Dict]:
    """One-shot plan + per-leaf encode (no retry schedule): returns
    (compressed, passthrough) in the ``encode_leaves`` key convention."""
    plan = TransferPlan.build(cache, tc)
    return encode_leaves(plan, cache, scheduled=False)


def decompress_cache(comp: Dict, raw: Dict, structure: Dict,
                     backend: str = "torch") -> Dict:
    """Inverse of :func:`compress_cache` against the original structure."""
    return decode_leaves(comp, raw, structure, get_backend(backend))


def compressed_wire_bytes(comp: Dict, raw: Dict,
                          backend: str = "torch") -> float:
    """Total wire bytes with the per-tensor raw fallback applied: a tensor
    whose escape capacity overflowed (``ok`` False) is charged raw bytes,
    because that is what the engine ships for it.  Summed in float64 (the
    JAX package sums in float32)."""
    be = get_backend(backend)
    total = 0.0
    for ct in comp.values():
        b = _backend_for(ct, be)
        total += (float(b.wire_bytes(ct)) if bool(b.ok(ct))
                  else float(b.raw_bytes(ct)))
    for leaf in raw.values():
        total += float(leaf.numel() * leaf.element_size())
    return total


def raw_wire_bytes(cache: Dict) -> float:
    return float(sum(x.numel() * x.element_size() for x in TR.leaves(cache)))


# ---------------------------------------------------------------------------
# chunked shims
# ---------------------------------------------------------------------------

def split_cache_segments(cache: Dict, n_chunks: int, align: int
                         ) -> Tuple[List[torch.Tensor], List[Tuple[str, tuple]], Dict]:
    """Flatten every bf16 leaf into one u16 bit stream and cut it into at
    most ``n_chunks`` ``align``-aligned segments (the historical bf16-only
    view; the plan owns segmentation now)."""
    bits_parts, metas, raw = [], [], {}
    for path, leaf in TR.flatten_with_path(cache)[0]:
        key = leaf_key(path)
        if leaf.dtype == torch.bfloat16:
            bits_parts.append(leaf.reshape(-1).view(torch.int16))
            metas.append((key, tuple(leaf.shape)))
        else:
            raw[key] = leaf
    if not bits_parts:
        return [], metas, raw
    stream = torch.cat(bits_parts) if len(bits_parts) > 1 else bits_parts[0]
    n = stream.shape[0]
    per = -(-n // max(1, n_chunks))             # ceil split
    per = max(align, -(-per // align) * align)  # align up to the codec chunk
    segments = [C.unsigned_view(stream[i:i + per]) for i in range(0, n, per)]
    return segments, metas, raw


def transfer_cache_chunked(cache: Dict, tc: TransferConfig
                           ) -> Tuple[Dict, TransferStats]:
    """One-shot plan through the local pipelined executor:
    ``TransferPlan.build(cache, tc, granularity="chunked").session()
    .transfer(cache)``.  Returns ``(cache, stats)``."""
    sess = TransferPlan.build(cache, tc, granularity="chunked").session()
    out = sess.transfer(cache)
    stats = sess.last_stats
    if stats is not None and not stats.chunk_wire_bytes and tc.n_chunks > 1:
        # nothing to fold (or compression disabled): report the historical
        # raw-chunk accounting for the bf16 stream
        segments, _, _ = split_cache_segments(cache, tc.n_chunks, tc.chunk)
        stats = dataclasses.replace(
            stats,
            chunk_wire_bytes=[float(s.shape[0] * 2) for s in segments],
            chunk_ok=[True] * len(segments),
            chunk_retried=[False] * len(segments),
            chunk_retry_steps=[0] * len(segments),
            raw_passthrough_bytes=stats.raw_passthrough_bytes
            - float(sum(s.shape[0] * 2 for s in segments)),
            n_elements=int(sum(s.shape[0] for s in segments)))
    return out, stats


def transfer_cache_cross_pod(cache, mesh, tc: TransferConfig,
                             src_pod: int = 0, dst_pod: int = 1,
                             return_hlo: bool = False, specs=None,
                             select_dst: bool = True, device=None):
    """One-shot mesh plan over ``torch.distributed``: ``TransferPlan.build(
    cache, tc, mesh=mesh, specs=specs, src_pod=..., dst_pod=...).session(
    device=device).transfer(cache, select_dst=select_dst)``, called on
    every rank of ``mesh``.  ``tc.n_chunks > 1`` ships per-chunk streams,
    at most two in flight; the result is bit-identical to the whole-tensor
    hop.  ``return_hlo`` is JAX-only (there is no lowered program)."""
    if return_hlo:
        raise ValueError("return_hlo reads the lowered XLA program of the "
                         "JAX mesh executor; the port runs eagerly and has "
                         "none (see session.last_comm for its bytes)")
    sess = TransferPlan.build(cache, tc, mesh=mesh, specs=specs,
                              src_pod=src_pod, dst_pod=dst_pod).session(
                                  device=device)
    return sess.transfer(cache, select_dst=select_dst)


# ---------------------------------------------------------------------------
# analytic transfer report (paper Fig. 3 / Fig. 4 accounting)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransferReport:
    raw_bytes: float
    wire_bytes: float
    t_native: float
    t_splitzip: float
    t_encode: float
    t_transfer: float
    t_decode: float

    @property
    def ratio(self) -> float:
        return self.raw_bytes / max(self.wire_bytes, 1.0)

    @property
    def speedup(self) -> float:
        return self.t_native / max(self.t_splitzip, 1e-12)


def transfer_report(raw_bytes: float, wire_bytes: float,
                    profile: CodecProfile, n_chunks: int = 1,
                    plan: Optional[TransferPlan] = None) -> TransferReport:
    """Analytic accounting from MEASURED wire bytes: additive encode +
    compressed transfer + decode (Fig. 4) when ``n_chunks == 1``, the
    chunked steady-state pipeline (Appendix A) when ``n_chunks > 1``.  With
    ``plan=`` the pipeline term splits the measured totals across chunks in
    the plan's actual segment proportions and runs the flowshop
    recurrence."""
    t_enc = raw_bytes / profile.g_enc
    t_dec = raw_bytes / profile.g_dec
    t_xfer = wire_bytes / profile.link_bw
    if plan is not None and plan.granularity == "chunked":
        seg = plan.chunk_raw_bytes()
        fracs = [s / sum(seg) for s in seg]
        t_total = flowshop_makespan(
            [(f * t_enc, f * t_xfer, f * t_dec) for f in fracs]
        ) + profile.fixed_overhead_s
    elif n_chunks > 1:
        per = [t / n_chunks for t in (t_enc, t_xfer, t_dec)]
        t_total = sum(per) + (n_chunks - 1) * max(per) + profile.fixed_overhead_s
    else:
        t_total = t_enc + t_xfer + t_dec + profile.fixed_overhead_s
    return TransferReport(
        raw_bytes=raw_bytes,
        wire_bytes=wire_bytes,
        t_native=raw_bytes / profile.link_bw + profile.fixed_overhead_s,
        t_splitzip=t_total,
        t_encode=t_enc, t_transfer=t_xfer, t_decode=t_dec,
    )
