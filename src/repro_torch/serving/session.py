"""TransferSession: executes a resolved :class:`TransferPlan` many times.

The port of ``repro.serving.session`` with its two LOCAL executors:

* **tensor** (``n_chunks == 1``): per-leaf encode -> hand-off -> decode,
  per-tensor raw fallback, geometric capacity retries.
* **chunked** (``n_chunks > 1``): the pipelined engine — ``ChunkSchedule``
  drives encode of chunk t / ship of t-1 / decode of t-2 over the plan's
  codec-chunk-aligned segments, with fp32 hi halves folded into the stream
  and per-chunk retries + raw fallback.

``send(cache)`` runs the prefill-side work (encode + the wire hop), ``recv()``
the decode-side work, ``transfer(cache)`` both; ``last_stats`` carries the
per-call accounting.  The wire is in-process: the compressed streams are
handed over as they are.

Not ported yet, and rejected with ``NotImplementedError`` rather than
ignored: checksum-verified delivery (``verify=``), fault injection
(``faults=``), failover re-send (``retain_last``), prefix-delta transfer,
the persistent executor, the ring collective, resharding and the mesh
executor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import codec as C
from repro_torch.core import tree as TR
from repro_torch.core.pipeline import ChunkSchedule
from repro_torch.serving.plan import TransferPlan, TransferStats


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; the local tensor "
        "and chunked executors are")


# ---------------------------------------------------------------------------
# per-leaf encode/decode (tensor granularity)
# ---------------------------------------------------------------------------

def _encode_scheduled(plan: TransferPlan, x, codebook, n: int, cap: int,
                      *, scheduled: bool):
    """Encode ``x`` down the plan's geometric capacity schedule.

    Returns ``(ct, ok, extra_attempts)``.  ``scheduled=False`` encodes once
    at plan capacity and leaves ``ok`` as the stream's flag."""
    tc = plan.tc
    ct = plan.backend.encode(x, codebook, chunk=tc.chunk, cap=cap,
                             layout=tc.layout)
    if not scheduled:
        return ct, plan.backend.ok(ct), 0
    if bool(plan.backend.ok(ct)):
        return ct, True, 0
    extra = 0
    for be, layout, c in plan.schedule_for(n, cap)[1:]:
        extra += 1
        ct = be.encode(x, codebook, chunk=tc.chunk, cap=c, layout=layout)
        if bool(be.ok(ct)):
            return ct, True, extra
    return ct, False, extra


def _record_unit(stats: Optional[TransferStats], key: str, ok: bool,
                 extra: int) -> None:
    if stats is None:
        return
    stats.leaf_ok[key] = ok
    stats.chunk_retried.append(extra > 0)
    stats.chunk_retry_steps.append(extra)


def _fp32_halves(leaf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    u = leaf.view(torch.int32)
    return C.narrow_u16((u >> 16) & 0xFFFF), C.narrow_u16(u & 0xFFFF)


def encode_leaves(plan: TransferPlan, cache, *, scheduled: bool = True,
                  stats: Optional[TransferStats] = None) -> Tuple[Dict, Dict]:
    """Per-leaf route execution -> (comp, raw): ``comp[key]`` holds
    splitzip/fp8 streams, ``comp[key + '#hi']`` the fp32 hi half,
    ``raw[key + '#lo']`` its raw lo half, ``raw[key]`` passthrough (including
    the raw fallback of units whose capacity schedule exhausted).

    ``scheduled=False``: single encode at plan capacity, streams kept
    regardless of the ``ok`` flag."""
    tc = plan.tc
    be = plan.backend
    comp: Dict[str, object] = {}
    raw: Dict[str, torch.Tensor] = {}
    flat = TR.flatten_with_path(cache)[0]
    for (_, leaf), r in zip(flat, plan.routes):
        key = r.key
        if r.route == "splitzip":
            ct, ok, extra = _encode_scheduled(plan, leaf, tc.codebook,
                                              r.n_elements, r.cap,
                                              scheduled=scheduled)
            if scheduled and not bool(ok):
                raw[key] = leaf
                if stats is not None:
                    stats.leaf_wire_bytes[key] = r.raw_bytes
                _record_unit(stats, key, False, extra)
            else:
                comp[key] = ct
                if stats is not None:
                    stats.leaf_wire_bytes[key] = float(be.wire_bytes(ct))
                _record_unit(stats, key, True, extra)
        elif r.route == "fp32_hilo":
            hi, lo = _fp32_halves(leaf)
            ct, ok, extra = _encode_scheduled(plan, hi, tc.codebook,
                                              r.n_elements, r.cap,
                                              scheduled=scheduled)
            if scheduled and not bool(ok):
                # an overflowed hi half means the WHOLE fp32 leaf ships raw
                raw[key] = leaf
                if stats is not None:
                    stats.leaf_wire_bytes[key] = r.raw_bytes
                _record_unit(stats, key, False, extra)
            else:
                comp[key + "#hi"] = ct
                raw[key + "#lo"] = lo
                if stats is not None:
                    stats.leaf_wire_bytes[key] = float(be.wire_bytes(ct))
                    stats.fp32_lo_wire_bytes += 2.0 * r.n_elements
                _record_unit(stats, key, True, extra)
        elif r.route == "fp8":
            ct, ok, extra = _encode_scheduled(plan, leaf, plan.fp8_codebook,
                                              r.n_elements, r.cap,
                                              scheduled=scheduled)
            if scheduled and not bool(ok):
                raw[key] = leaf
                if stats is not None:
                    stats.fp8_wire_bytes += r.raw_bytes
                _record_unit(stats, key, False, extra)
            else:
                comp[key] = ct
                if stats is not None:
                    stats.fp8_wire_bytes += float(be.wire_bytes(ct))
                _record_unit(stats, key, True, extra)
        else:
            raw[key] = leaf
            if stats is not None:
                stats.raw_passthrough_bytes += r.raw_bytes
    return comp, raw


def decode_leaves(comp: Dict, raw: Dict, structure, backend):
    """Inverse of :func:`encode_leaves` against the original structure;
    ``backend`` is a :class:`~repro_torch.core.backend.CodecBackend`."""
    flat, treedef = TR.flatten_with_path(structure)
    leaves = []
    for path, leaf in flat:
        key = TR.leaf_key(path)
        if key in comp:
            leaves.append(backend.decode(comp[key]).reshape(leaf.shape))
        elif key + "#hi" in comp:  # fp32 hi/lo split
            hi = C.widen(backend.decode(comp[key + "#hi"])).to(torch.int64)
            u = (hi << 16) | C.widen(raw[key + "#lo"]).to(torch.int64)
            leaves.append(C.narrow_u32(u).view(torch.int32).view(torch.float32)
                          .reshape(leaf.shape))
        else:
            leaves.append(raw[key])
    return TR.unflatten(treedef, leaves)


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

class TransferSession:
    """Run a :class:`TransferPlan` repeatedly: ``send``/``recv`` or the fused
    ``transfer``.  Accumulates ``calls``/``total_wire_bytes``; per-call
    accounting is in ``last_stats``."""

    def __init__(self, plan: TransferPlan, *, faults=None,
                 verify: bool = False, retain_last: bool = False):
        if faults is not None:
            raise _not_ported("fault injection (faults=)")
        if verify:
            raise _not_ported("checksum-verified delivery (verify=True)")
        if retain_last:
            raise _not_ported("failover re-send (retain_last=True)")
        self.plan = plan
        self.last_stats: Optional[TransferStats] = None
        self.calls = 0
        self.total_wire_bytes = 0.0
        self._staged = None   # in-flight payload between send() and recv()

    # -- public API ----------------------------------------------------------
    def send(self, cache, check: bool = True) -> None:
        """Prefill-side half: encode every routed leaf and put the payload on
        the wire.  Call ``recv`` to complete.  ``check=False`` skips the
        structure validation for callers that already ran ``plan.matches``."""
        if self._staged is not None:
            raise RuntimeError("send() called twice without recv()")
        if check:
            self._check_structure(cache)
        if self.plan.granularity == "chunked":
            self._staged = ("chunked", self._send_chunked(cache))
        else:
            self._staged = ("tensor", self._send_tensor(cache))

    def recv(self, verify: Optional[bool] = None):
        """Decode-side half: returns the reassembled cache pytree."""
        if verify:
            raise _not_ported("checksum-verified delivery (verify=True)")
        if self._staged is None:
            raise RuntimeError("recv() called before send()")
        kind, payload = self._staged
        self._staged = None
        if kind == "chunked":
            out = self._recv_chunked(payload)
        else:
            out = self._recv_tensor(payload)
        self._account()
        return out

    def transfer(self, cache, check: bool = True,
                 verify: Optional[bool] = None):
        """Fused send + recv.  The chunked path interleaves the stages on the
        explicit ``ChunkSchedule`` (encode t / ship t-1 / decode t-2); the
        result is bit-identical to split send()+recv()."""
        if verify:
            raise _not_ported("checksum-verified delivery (verify=True)")
        if self.plan.granularity == "chunked":
            if self._staged is not None:
                raise RuntimeError("transfer() called with a send() pending")
            if check:
                self._check_structure(cache)
            out = self._transfer_chunked_interleaved(cache)
            self._account()
            return out
        self.send(cache, check=check)
        return self.recv()

    def transfer_compressed(self, cache, check: bool = True):
        """Tensor-path transfer that STOPS at the compressed streams: returns
        ``(comp, raw)`` in the ``encode_leaves`` key convention.  Only the
        tensor path qualifies (chunked granularity re-segments leaves)."""
        if self.plan.granularity == "chunked":
            raise ValueError(
                "transfer_compressed requires the tensor path (n_chunks == 1)")
        self.send(cache, check=check)
        _, (comp, raw, _) = self._staged
        self._staged = None
        self._account()
        return comp, raw

    # -- executors that are not ported yet -------------------------------------
    def transfer_delta(self, *args, **kwargs):
        raise _not_ported("prefix-delta transfer (transfer_delta)")

    def enable_prefix_cache(self, *args, **kwargs):
        raise _not_ported("prefix-delta transfer (enable_prefix_cache)")

    def resend_last(self, *args, **kwargs):
        raise _not_ported("failover re-send (resend_last)")

    def save(self, *args, **kwargs):
        raise _not_ported("the persistent executor (save)")

    def load(self, *args, **kwargs):
        raise _not_ported("the persistent executor (load)")

    def ring_reduce(self, *args, **kwargs):
        raise _not_ported("the ring collective (ring_reduce)")

    def reshard(self, *args, **kwargs):
        raise _not_ported("resharding (reshard)")

    # -- internals -----------------------------------------------------------
    def _check_structure(self, cache) -> None:
        if not self.plan.matches(cache):
            raise ValueError(
                "cache structure does not match this TransferPlan; rebuild "
                "the plan for the new structure (TransferPlan.build)")

    def _account(self) -> None:
        self.calls += 1
        if self.last_stats is not None:
            self.total_wire_bytes += self.last_stats.wire_bytes

    # -- local / tensor ------------------------------------------------------
    def _send_tensor(self, cache):
        stats = TransferStats(chunk_wire_bytes=[], chunk_ok=[],
                              raw_passthrough_bytes=0.0, n_elements=0)
        comp, raw = encode_leaves(self.plan, cache, scheduled=True,
                                  stats=stats)
        self.last_stats = stats
        return comp, raw, cache

    def _recv_tensor(self, payload):
        comp, raw, structure = payload
        return decode_leaves(comp, raw, structure, self.plan.backend)

    # -- local / chunked -----------------------------------------------------
    def _encode_chunk(self, stream, i: int):
        """Encode segment ``i`` at base capacity (schedule step 0)."""
        seg = self.plan.segments[i]
        tc = self.plan.tc
        return self.plan.backend.encode(
            stream[seg.start:seg.stop], tc.codebook, chunk=tc.chunk,
            cap=seg.cap, layout=tc.layout)

    def _ship_chunk(self, stream, i: int, ct, stats: TransferStats):
        """The wire hop for chunk ``i``: walk the remaining capacity schedule
        on overflow, then raw fallback.  Returns the in-flight payload
        (compressed object, or None when the chunk ships its raw bits)."""
        plan, tc = self.plan, self.plan.tc
        seg = plan.segments[i]
        be = plan.backend
        ok = bool(be.ok(ct))
        extra = 0
        if not ok:
            for rbe, layout, cap in plan.schedule_for(seg.n_elements,
                                                      seg.cap)[1:]:
                extra += 1
                ct2 = rbe.encode(stream[seg.start:seg.stop], tc.codebook,
                                 chunk=tc.chunk, cap=cap, layout=layout)
                if bool(rbe.ok(ct2)):
                    ct, ok = ct2, True
                    break
        stats.chunk_retried[i] = extra > 0
        stats.chunk_retry_steps[i] = extra
        stats.chunk_ok[i] = ok
        stats.chunk_wire_bytes[i] = (float(be.wire_bytes(ct)) if ok
                                     else seg.raw_bytes)
        return ct if ok else None

    def _decode_chunk(self, stream, i: int, payload):
        """Receiver side: straight to the shipped bit stream."""
        seg = self.plan.segments[i]
        if payload is None:      # raw fallback: the original bits shipped
            return stream[seg.start:seg.stop]
        return self.plan.backend.decode_bits(payload).reshape(-1)

    def _chunked_sidecars(self, cache, stats: TransferStats):
        """Everything outside the pipelined stream: fold the stream, encode
        fp8 sidecar leaves, count lo halves + raw passthrough."""
        plan = self.plan
        stream, lo, fp8, raw = plan.fold_stream(cache)
        fp8_payload: Dict[str, object] = {}
        for r in plan.routes:
            if r.route == "fp32_hilo":
                stats.fp32_lo_wire_bytes += 2.0 * r.n_elements
            elif r.route == "fp8":
                ct, ok, extra = _encode_scheduled(
                    plan, fp8[r.key], plan.fp8_codebook, r.n_elements, r.cap,
                    scheduled=True)
                _record_unit(stats, r.key, bool(ok), extra)
                stats.fp8_wire_bytes += (float(plan.backend.wire_bytes(ct))
                                         if ok else r.raw_bytes)
                fp8_payload[r.key] = ct if ok else fp8[r.key]
            elif r.route == "raw":
                stats.raw_passthrough_bytes += r.raw_bytes
        return stream, lo, fp8_payload, raw

    def _new_chunked_stats(self) -> TransferStats:
        n = self.plan.n_chunks
        return TransferStats(
            chunk_wire_bytes=[0.0] * n, chunk_ok=[True] * n,
            raw_passthrough_bytes=0.0, n_elements=self.plan.stream_len,
            chunk_retried=[False] * n, chunk_retry_steps=[0] * n)

    def _send_chunked(self, cache):
        stats = self._new_chunked_stats()
        stream, lo, fp8_payload, raw = self._chunked_sidecars(cache, stats)
        in_flight = [self._ship_chunk(stream, i, self._encode_chunk(stream, i),
                                      stats)
                     for i in range(self.plan.n_chunks)]
        self.last_stats = stats
        return stream, in_flight, lo, fp8_payload, raw

    def _recv_chunked(self, payload):
        stream, in_flight, lo, fp8_payload, raw = payload
        decoded = [self._decode_chunk(stream, i, p)
                   for i, p in enumerate(in_flight)]
        return self._reassemble(decoded, lo, fp8_payload, raw)

    def _reassemble(self, decoded_bits: List[torch.Tensor], lo, fp8_payload,
                    raw):
        plan = self.plan
        bits_out = (C.unsigned_view(torch.cat([C.signed_view(b)
                                               for b in decoded_bits]))
                    if len(decoded_bits) > 1 else decoded_bits[0])
        fp8_dec = {}
        for r in plan.routes:
            if r.route == "fp8":
                p = fp8_payload[r.key]
                fp8_dec[r.key] = (p if isinstance(p, torch.Tensor)  # raw leaf
                                  else plan.backend.decode(p))
        return plan.unfold_stream(bits_out, lo, fp8_dec, raw)

    def _transfer_chunked_interleaved(self, cache):
        """The fused chunked path on the explicit overlap schedule: at step t
        encode chunk t, ship chunk t-1, decode chunk t-2."""
        stats = self._new_chunked_stats()
        stream, lo, fp8_payload, raw = self._chunked_sidecars(cache, stats)
        n = self.plan.n_chunks
        encoded: Dict[int, object] = {}
        in_flight: Dict[int, object] = {}
        decoded: Dict[int, torch.Tensor] = {}
        for enc_i, xfer_i, dec_i in ChunkSchedule(n).stages():
            if 0 <= enc_i < n:
                encoded[enc_i] = self._encode_chunk(stream, enc_i)
            if 0 <= xfer_i < n:
                in_flight[xfer_i] = self._ship_chunk(
                    stream, xfer_i, encoded.pop(xfer_i), stats)
            if 0 <= dec_i < n:
                decoded[dec_i] = self._decode_chunk(
                    stream, dec_i, in_flight.pop(dec_i))
        self.last_stats = stats
        return self._reassemble([decoded[i] for i in range(n)], lo,
                                fp8_payload, raw)
