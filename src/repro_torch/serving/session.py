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
per-call accounting.  The wire is in-process: the compressed objects are
handed over as they are, or, when ``verify=`` or ``faults=`` is set, inside
Fletcher-32 frames over a :class:`~repro_torch.serving.faults.FaultChannel`
(verified delivery, see :class:`TransferSession`).  ``retain_last`` keeps
the last tensor-path payload for a failover re-send (``resend_last``).

**Prefix-delta transfer** (``enable_prefix_cache`` + ``transfer_delta``, on
the chunked path): only the segments and sidecars whose bits changed since
a session id's last turn cross the wire; the rest is re-used from the
receiver's copy and counted in ``TransferStats.prefix_hit_bytes``.  The
sender's shadow of the last turn stays on the bytes' device and is compared
there, in the bit domain, in one pass a turn (:class:`PrefixIndex`).

**The persistent executor** (``save(path, tree)`` / ``load(path)``): one
SZ02 file per leaf plus a plan-derived JSON manifest (``szpersist-1``,
``docs/wire_format.md`` §9), the same bytes the JAX package writes, so a
directory either package saved loads in the other.  Loads verify each
file's Fletcher-32 and the payload's frame table, re-read down the plan's
retry budget, and raise :class:`~repro_torch.core.wire.WireIntegrityError`
when the corruption persists.  ``distributed/checkpoint.py`` is a thin
wrapper over it.

**The collective executors** run across processes over
``torch.distributed`` (gloo; :mod:`repro_torch.serving.collective` holds
their bit-pinned wire and its host staging):

* **mesh** (``plan.mesh``): every rank calls ``transfer(cache)``; each
  slices its shard by the plan's specs, and the ranks of pod ``src_pod``
  send their shards' streams to the ranks of pod ``dst_pod`` that share
  their (data, model) coordinate, which decode them.  Tensor granularity
  ships one message; chunked granularity drives ``ChunkSchedule`` with at
  most two chunks in flight.  Unlike the JAX mesh executor, each shard
  walks the capacity schedule on its concrete ``ok`` flag and falls back
  to raw, so an overflowing shard arrives intact; source ranks decode
  nothing; ``last_stats`` counts the bytes handed to ``torch.distributed``
  (``last_comm`` the headers, staging and wire time).
* **collective** (``ring_reduce(stacked)``): the rotating-ring all-reduce
  over compressed streams; leaves whose hops overflowed anywhere re-run on
  the raw ring.  ``training/grad_compress.py`` is a thin wrapper over it.
* **reshard** (``reshard(tree, dst)``): the local wire hop, then placement
  on ``dst``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import abstract as AB
from repro_torch.core import codec as C
from repro_torch.core import tree as TR
from repro_torch.core.backend import (CodecBackend, WireBackend,
                                      WireCompressed, get_backend)
from repro_torch.core.pipeline import ChunkSchedule
from repro_torch.core.wire import WireIntegrityError, WireStats, fletcher32
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import mesh_shape
from repro_torch.serving import collective as CL
from repro_torch.serving.faults import FaultChannel, resolve_faults
from repro_torch.serving.plan import TransferPlan, TransferStats

# hard ceiling on wire attempts per unit (initial ship + re-fetches).  The
# default FaultPlan stops randomized faults at max_attempt=8, so only an
# explicitly-persistent adversarial plan can reach this — and then the
# session fails LOUDLY instead of decoding garbage or spinning forever.
_MAX_WIRE_ATTEMPTS = 32

# persistent-executor manifest (docs/wire_format.md §9)
PERSIST_MANIFEST = "manifest.json"
PERSIST_FORMAT = "szpersist-1"


class TransferIntegrityError(RuntimeError):
    """A wire unit could not be delivered intact within the attempt budget —
    every re-fetch, the terminal raw re-fetches included, failed
    verification.  Raised instead of ever decoding corrupt bytes."""


def _backend_for(comp_obj, be: CodecBackend) -> CodecBackend:
    """The backend that can decode (or tag) ``comp_obj``: wire payloads
    decode only with a wire backend, streams and raw tensors with a stream
    codec (``torch`` and ``cuda`` share the stream layout)."""
    if isinstance(comp_obj, WireCompressed):
        return be if isinstance(be, WireBackend) else get_backend("wire")
    return get_backend("torch") if isinstance(be, WireBackend) else be


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
    if AB.host_bool(plan.backend.ok(ct)):
        return ct, True, 0
    extra = 0
    for be, layout, c in plan.schedule_for(n, cap)[1:]:
        extra += 1
        ct = be.encode(x, codebook, chunk=tc.chunk, cap=c, layout=layout)
        if AB.host_bool(be.ok(ct)):
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


def _host_bytes(x: torch.Tensor) -> bytes:
    """A tensor's bytes in memory order, as the host sees them."""
    flat = C.signed_view(x).detach().contiguous().reshape(-1)
    return flat.view(torch.uint8).cpu().numpy().tobytes()


def _from_host_bytes(blob: bytes, dtype: torch.dtype, shape, device
                     ) -> torch.Tensor:
    """Inverse of :func:`_host_bytes`: a tensor of ``dtype`` and ``shape`` on
    ``device``."""
    u8 = (torch.frombuffer(bytearray(blob), dtype=torch.uint8) if blob
          else torch.zeros(0, dtype=torch.uint8))
    return u8.view(dtype).reshape(shape).to(device)


def _persist_comp(payload: bytes, r, fmt: str, dtype: str, device
                  ) -> WireCompressed:
    """A persisted SZ02 payload as the wire backend's object, decoding onto
    ``device``."""
    stats = WireStats(n_elements=r.n_elements, n_escapes=0,
                      payload_bytes=len(payload), raw_bytes=int(r.raw_bytes))
    return WireCompressed(payload=payload, shape=r.shape, dtype=dtype,
                          fmt=fmt, stats=stats, device=str(device))


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
            ct = comp[key]
            leaves.append(_backend_for(ct, backend).decode(ct).reshape(leaf.shape))
        elif key + "#hi" in comp:  # fp32 hi/lo split
            ct = comp[key + "#hi"]
            hi = C.widen(_backend_for(ct, backend).decode(ct)).to(torch.int64)
            u = (hi << 16) | C.widen(raw[key + "#lo"]).to(torch.int64)
            leaves.append(C.narrow_u32(u).view(torch.int32).view(torch.float32)
                          .reshape(leaf.shape))
        else:
            leaves.append(raw[key])
    return TR.unflatten(treedef, leaves)


# ---------------------------------------------------------------------------
# prefix-delta index (transfer_delta)
# ---------------------------------------------------------------------------

def _bits(x: torch.Tensor) -> torch.Tensor:
    """Flat byte view of a tensor: shadows compare in the BIT domain, so NaN
    payloads, negative zeros and denormals compare exactly."""
    return x.reshape(-1).view(torch.uint8)


def _owned(x: torch.Tensor, sender: torch.Tensor) -> torch.Tensor:
    """``x``, cloned where it shares storage with the sender's ``sender``:
    the receiver keeps a copy of its own."""
    if x.untyped_storage().data_ptr() == sender.untyped_storage().data_ptr():
        return x.clone()
    return x


@dataclasses.dataclass
class _PrefixEntry:
    """One session's resident cache, seen from both ends of the wire: the
    sender's bit shadows of its last turn (on the bytes' device) and the
    receiver's objects a hit re-uses without wire traffic."""

    stream: torch.Tensor                   # sender int16 shadow of fold_stream
    seg_bits: List[torch.Tensor]           # receiver decoded bits per segment
    side_shadow: Dict[str, torch.Tensor]   # "<fam>:<key>" -> sender copy
    side_obj: Dict[str, object]            # "<fam>:<key>" -> receiver object
    nbytes: float                          # raw-byte footprint (LRU accounting)


class PrefixIndex:
    """LRU-by-bytes map of session id -> :class:`_PrefixEntry`.

    The execution-side twin of the scheduler's ``PrefixDirectory``: it holds
    the receiver objects and the sender shadows that
    :meth:`TransferSession.transfer_delta` compares against.
    ``capacity_bytes=None`` is unbounded; otherwise least-recently-used
    sessions are dropped until the raw-byte footprint fits (an entry larger
    than the whole budget is dropped at once)."""

    def __init__(self, capacity_bytes: Optional[float] = None):
        if capacity_bytes is not None and capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be positive (or None)")
        self.capacity_bytes = capacity_bytes
        self.evictions = 0
        self._entries: "OrderedDict[object, _PrefixEntry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def sessions(self):
        return list(self._entries)

    @property
    def resident_bytes(self) -> float:
        return sum(e.nbytes for e in self._entries.values())

    def get(self, session_id) -> Optional[_PrefixEntry]:
        e = self._entries.get(session_id)
        if e is not None:
            self._entries.move_to_end(session_id)
        return e

    def put(self, session_id, entry: _PrefixEntry) -> None:
        self._entries[session_id] = entry
        self._entries.move_to_end(session_id)
        if self.capacity_bytes is None:
            return
        while self._entries and self.resident_bytes > self.capacity_bytes:
            self._entries.popitem(last=False)
            self.evictions += 1

    def drop(self, session_id) -> None:
        self._entries.pop(session_id, None)

    def clear(self) -> None:
        self._entries.clear()


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

class TransferSession:
    """Run a :class:`TransferPlan` repeatedly: ``send``/``recv`` or the fused
    ``transfer``.  Accumulates ``calls``/``total_wire_bytes``; per-call
    accounting is in ``last_stats``.

    **Wire integrity** (``verify=True`` and/or ``faults=``): every wire
    object — pipeline chunks, tensor-path leaves, sidecars — ships inside a
    Fletcher-32 checksum frame over a
    :class:`~repro_torch.serving.faults.FaultChannel`.  With ``verify`` on,
    a mismatched or dropped frame is re-fetched: the staged compressed
    object is shipped again with the fault coordinate re-keyed (it is not
    encoded again), as many times as the plan's capacity schedule has
    steps, then the unit's RAW bits as the terminal re-fetch.  Corrupt
    bytes are never decoded, and exhaustion raises
    :class:`TransferIntegrityError`.  ``faults=`` injects a seeded
    :class:`~repro_torch.serving.faults.FaultPlan` into the channel."""

    def __init__(self, plan: TransferPlan, *, faults=None,
                 verify: bool = False, retain_last: bool = False,
                 device=None):
        self.plan = plan
        # where ``load`` puts the leaves (None: the card, see
        # repro_torch.device)
        self.device = device
        self.verify = verify
        self.retain_last = retain_last
        self.faults = resolve_faults(faults)
        if plan.mesh is not None and (verify or self.faults is not None):
            raise ValueError(
                "verify/faults run on the host wire hop; the mesh path's "
                "collective permute has no host-side frame to checksum")
        # the checksum-framed wire: active whenever faults are injected or
        # verification is on, so the plain hop pays nothing
        self._channel = (FaultChannel(self._object_checksum, self.faults)
                         if (verify or self.faults is not None) else None)
        self.last_stats: Optional[TransferStats] = None
        self.calls = 0
        self.total_wire_bytes = 0.0
        self._uid = 0         # per-send transfer id (fault-plan keying)
        self._injected_seen = 0
        self._staged = None   # in-flight payload between send() and recv()
        # the pristine encoded payload of the last tensor-path send, kept
        # only under retain_last (see resend_last)
        self._retained = None
        # prefix-delta state (see transfer_delta), and the padded
        # (n_segments, per) comparison buffer of the segment shadows
        self._prefix_index: Optional[PrefixIndex] = None
        self._hit_buf: Optional[torch.Tensor] = None
        # collective executors: the per-shard session of a mesh plan (its
        # plan over the shard shapes), the ring's per-participant routes,
        # and what the last call handed to torch.distributed
        self._shard_session: Optional["TransferSession"] = None
        self._shard_struct = None
        self._ring_routes = None
        self.last_comm: Optional[CL.CommStats] = None

    def _object_checksum(self, obj) -> int:
        """Fletcher-32 over any wire object: compressed streams, a wire
        payload or a raw tensor."""
        return _backend_for(obj, self.plan.backend).checksum(obj)

    # -- public API ----------------------------------------------------------
    def send(self, cache, check: bool = True) -> None:
        """Prefill-side half: encode every routed leaf and put the payload on
        the wire.  Call ``recv`` to complete.  ``check=False`` skips the
        structure validation for callers that already ran ``plan.matches``."""
        if self._staged is not None:
            raise RuntimeError("send() called twice without recv()")
        if check and not (self.plan.mesh is not None and cache is None):
            self._check_structure(cache)
        self._uid += 1
        if self.plan.mesh is not None:
            self._staged = ("mesh", cache)
        elif self.plan.granularity == "chunked":
            self._staged = ("chunked", self._send_chunked(cache))
        else:
            self._staged = ("tensor", self._send_tensor(cache))

    def _set_verify(self, verify: Optional[bool]) -> None:
        """Per-call ``verify=`` knob: None keeps the session default."""
        if verify is None:
            return
        if verify and self._channel is None:
            raise ValueError(
                "this session shipped unframed payloads (no checksums on the "
                "wire); build it with plan.session(verify=True) or faults=")
        self.verify = bool(verify)

    def recv(self, select_dst: bool = True, verify: Optional[bool] = None):
        """Decode-side half: returns the reassembled cache pytree.
        ``verify=True`` enforces the checksum frames shipped by ``send``
        (re-fetch on mismatch), ``verify=False`` delivers without
        enforcement, None keeps the session default.  On a mesh plan this
        runs the collective (see :meth:`_run_mesh` for ``select_dst``)."""
        if self._staged is None:
            raise RuntimeError("recv() called before send()")
        self._set_verify(verify)
        kind, payload = self._staged
        self._staged = None
        if kind == "mesh":
            out = self._run_mesh(payload, select_dst=select_dst)
        elif kind == "chunked":
            out = self._recv_chunked(payload)
        else:
            out = self._recv_tensor(payload)
        self._account()
        return out

    def transfer(self, cache, select_dst: bool = True, check: bool = True,
                 verify: Optional[bool] = None):
        """Fused send + recv.  The chunked path interleaves the stages on the
        explicit ``ChunkSchedule`` (encode t / ship t-1 / decode t-2); the
        result is bit-identical to split send()+recv().  ``verify=`` as on
        ``recv``; ``select_dst`` as on :meth:`_run_mesh` (mesh plans; a
        destination rank may pass ``cache=None``)."""
        self._set_verify(verify)
        if self.plan.mesh is None and self.plan.granularity == "chunked":
            if self._staged is not None:
                raise RuntimeError("transfer() called with a send() pending")
            if check:
                self._check_structure(cache)
            self._uid += 1
            out = self._transfer_chunked_interleaved(cache)
            self._account()
            return out
        self.send(cache, check=check)
        return self.recv(select_dst=select_dst)

    def transfer_shard(self, shard):
        """The mesh hop of each source rank's OWN shard: a sharded prefill
        worker holds only its ``(data, model)`` block of every leaf and
        passes that (each leaf's shape checked against ``local_shape`` of
        the plan's whole shape under its spec); destination ranks pass
        None and return their own shard, as ``transfer(select_dst=False)``
        does.  Units, records, ``last_stats`` and the capacity walk are the
        whole-cache path's, and so are the bytes: that path slices the
        same block out of the whole cache first."""
        if self.plan.mesh is None:
            raise ValueError("transfer_shard runs a mesh plan's hop")
        if self._staged is not None:
            raise RuntimeError("transfer_shard() called with a send() pending")
        self._uid += 1
        out = self._run_mesh(shard, select_dst=False, own=True)
        self._account()
        return out

    def transfer_compressed(self, cache, check: bool = True,
                            verify: Optional[bool] = None):
        """Tensor-path transfer that STOPS at the compressed streams: returns
        ``(comp, raw)`` in the ``encode_leaves`` key convention, after
        verified delivery when the session frames its wire.  Only the tensor
        path qualifies (chunked granularity re-segments leaves)."""
        if self.plan.mesh is not None or self.plan.granularity == "chunked":
            raise ValueError(
                "transfer_compressed requires the local tensor path "
                "(mesh=None, n_chunks == 1)")
        self._set_verify(verify)
        self.send(cache, check=check)
        _, payload = self._staged
        self._staged = None
        comp, raw, structure, pristine_comp, pristine_raw = payload
        if self._channel is not None:
            comp, raw = self._deliver_tensor(comp, raw, structure,
                                             pristine_comp, pristine_raw)
        self._account()
        return comp, raw

    def resend_last(self, verify: Optional[bool] = None):
        """Re-ship the most recent tensor-path transfer from its retained
        encoded payload — the decode-worker-failover path: one more wire
        hop, no re-encode.  Returns the decoded cache, bit-identical to the
        original transfer's result; ``last_stats`` / ``total_wire_bytes``
        account the repeated hop like any other call."""
        if self.plan.mesh is not None or self.plan.granularity == "chunked":
            raise ValueError(
                "resend_last requires the local tensor path (mesh=None, "
                "n_chunks == 1); chunked/mesh transfers are not retained")
        if self._retained is None:
            raise RuntimeError(
                "no retained transfer to re-send; build the session with "
                "retain_last=True and complete a transfer first")
        if self._staged is not None:
            raise RuntimeError("resend_last() called with a send() pending")
        self._set_verify(verify)
        comp, raw, cache = self._retained
        be = self.plan.backend
        stats = TransferStats(chunk_wire_bytes=[], chunk_ok=[],
                              raw_passthrough_bytes=0.0, n_elements=0)
        for r in self.plan.routes:
            key = r.key
            if key in comp:
                nbytes = float(_backend_for(comp[key], be)
                               .wire_bytes(comp[key]))
                if r.route == "fp8":
                    stats.fp8_wire_bytes += nbytes
                else:
                    stats.leaf_wire_bytes[key] = nbytes
                stats.leaf_ok[key] = True
            elif key + "#hi" in comp:
                hi = comp[key + "#hi"]
                stats.leaf_wire_bytes[key] = float(
                    _backend_for(hi, be).wire_bytes(hi))
                stats.fp32_lo_wire_bytes += 2.0 * r.n_elements
                stats.leaf_ok[key] = True
            elif r.route == "raw":
                stats.raw_passthrough_bytes += r.raw_bytes
            else:
                # a leaf that fell back to raw on the original encode
                if r.route == "fp8":
                    stats.fp8_wire_bytes += r.raw_bytes
                else:
                    stats.leaf_wire_bytes[key] = r.raw_bytes
                stats.leaf_ok[key] = False
        self.last_stats = stats
        self._uid += 1
        if self._channel is not None:
            comp_f, raw_f = self._frame_tensor(comp, raw)
            comp_d, raw_d = self._deliver_tensor(comp_f, raw_f, cache,
                                                 comp, raw)
        else:
            comp_d, raw_d = comp, raw
        out = decode_leaves(comp_d, raw_d, cache, be)
        self._account()
        return out

    # -- prefix-delta transfer ----------------------------------------------
    def enable_prefix_cache(self,
                            capacity_bytes: Optional[float] = None
                            ) -> PrefixIndex:
        """Attach a :class:`PrefixIndex` so :meth:`transfer_delta` can skip
        segments the destination already holds.  Chunked path only: delta
        granularity is the plan's codec-aligned segmentation.  Returns the
        index (idempotent; the first capacity wins)."""
        if self.plan.mesh is not None or self.plan.granularity != "chunked":
            raise ValueError(
                "prefix-delta transfer rides the local chunked path "
                "(mesh=None, n_chunks > 1); build the plan with "
                "granularity='chunked'")
        if self._prefix_index is None:
            self._prefix_index = PrefixIndex(capacity_bytes)
        return self._prefix_index

    def transfer_delta(self, cache, session_id, *, check: bool = True,
                       verify: Optional[bool] = None):
        """Prefix-aware transfer: ship only the segments (and sidecars) that
        CHANGED since this session id's last transfer.

        A segment of the folded stream hits when its bits equal the sender's
        shadow of the last turn; a hit costs zero wire bytes (the receiver
        re-uses the bits it decoded then) and its raw size lands in
        ``last_stats.prefix_hit_bytes``.  Changed segments run the normal
        chunked machinery: capacity-schedule retries, checksum framing,
        verified re-fetches.  Sidecars (fp32 lo halves, fp8 leaves, raw
        passthrough) hit on whole-object bit equality.  The result is
        bit-identical to a full ``transfer`` of the same cache, and a cold
        session id ships exactly what a full transfer ships.  Requires
        :meth:`enable_prefix_cache`.

        The comparison is one device pass over the stream and the sidecars
        against the shadows, with one boolean vector read back."""
        if self._prefix_index is None:
            raise RuntimeError(
                "prefix cache not enabled; call enable_prefix_cache() first")
        if self._staged is not None:
            raise RuntimeError("transfer_delta() called with a send() "
                               "pending")
        self._set_verify(verify)
        if check:
            self._check_structure(cache)
        self._uid += 1
        plan = self.plan
        stats = self._new_chunked_stats()
        stream, lo, fp8, raw = plan.fold_stream(cache)
        sides = self._delta_sides(lo, fp8, raw)
        entry = self._prefix_index.get(session_id)
        n_seg = plan.n_chunks
        if entry is None:
            hits = [False] * (n_seg + len(sides))
        else:
            hits = self.shadow_hits(stream, sides, entry).tolist()

        # the pipelined stream, segment by segment
        bits: List[torch.Tensor] = []
        for i, seg in enumerate(plan.segments):
            if hits[i]:
                bits.append(entry.seg_bits[i])
                stats.prefix_hit_bytes += seg.raw_bytes
                # chunk_wire_bytes[i] stays 0.0: nothing crossed the wire
            else:
                p = self._wire_hop(stream, i, self._encode_chunk(stream, i),
                                   stats)
                bits.append(_owned(self._chunk_out(stream, i, p, stats),
                                   stream))

        # the sidecars, each whole
        lo_out: Dict[str, object] = {}
        fp8_dec: Dict[str, object] = {}
        raw_out: Dict[str, object] = {}
        miss_lo: Dict[str, object] = {}
        miss_fp8: Dict[str, object] = {}
        miss_raw: Dict[str, object] = {}
        routes = {r.key: r for r in plan.routes}
        for (fam, k, _), hit in zip(sides, hits[n_seg:]):
            r = routes[k]
            if fam == "lo":
                if hit:
                    lo_out[k] = entry.side_obj[f"lo:{k}"]
                    stats.prefix_hit_bytes += 2.0 * r.n_elements
                else:
                    miss_lo[k] = lo[k]
                    stats.fp32_lo_wire_bytes += 2.0 * r.n_elements
            elif fam == "fp8":
                if hit:
                    fp8_dec[k] = entry.side_obj[f"fp8:{k}"]
                    stats.prefix_hit_bytes += r.raw_bytes
                else:
                    ct, ok, extra = _encode_scheduled(
                        plan, fp8[k], plan.fp8_codebook, r.n_elements, r.cap,
                        scheduled=True)
                    _record_unit(stats, k, bool(ok), extra)
                    stats.fp8_wire_bytes += (
                        float(plan.backend.wire_bytes(ct)) if ok
                        else r.raw_bytes)
                    miss_fp8[k] = ct if ok else fp8[k]
            elif hit:
                raw_out[k] = entry.side_obj[f"raw:{k}"]
                stats.prefix_hit_bytes += r.raw_bytes
            else:
                miss_raw[k] = raw[k]
                stats.raw_passthrough_bytes += r.raw_bytes

        if self._channel is not None:
            lo_f, fp8_f, raw_f = self._ship_sidecars(miss_lo, miss_fp8,
                                                     miss_raw)
            miss_lo, miss_fp8, miss_raw = self._deliver_sidecars(
                lo_f, fp8_f, raw_f, (miss_lo, miss_fp8, miss_raw), stats)
        lo_out.update(miss_lo)
        raw_out.update(miss_raw)
        for k, p in miss_fp8.items():
            fp8_dec[k] = (p if isinstance(p, torch.Tensor)   # raw fallback
                          else _backend_for(p, plan.backend).decode(p))

        # a fresh tensor even for one segment: the delivered cache never
        # aliases what the receiver keeps for the next turn
        bits_out = C.unsigned_view(torch.cat([C.signed_view(b) for b in bits]))
        out = plan.unfold_stream(bits_out, lo_out, fp8_dec, raw_out)

        # refresh the shadows and the receiver objects for the NEXT turn
        shadow: Dict[str, torch.Tensor] = {}
        side_obj: Dict[str, object] = {}
        nbytes = 2.0 * stream.numel()
        kept = {"lo": lo_out, "fp8": fp8_dec, "raw": raw_out}
        for fam, k, sender in sides:
            shadow[f"{fam}:{k}"] = sender.clone()
            obj = kept[fam][k]
            side_obj[f"{fam}:{k}"] = (_owned(obj, sender)
                                      if isinstance(obj, torch.Tensor) else obj)
            nbytes += (2.0 * routes[k].n_elements if fam == "lo"
                       else routes[k].raw_bytes)
        self._prefix_index.put(session_id, _PrefixEntry(
            stream=C.signed_view(stream).clone(), seg_bits=bits,
            side_shadow=shadow, side_obj=side_obj, nbytes=nbytes))

        self.last_stats = stats
        self._account()
        return out

    def _delta_sides(self, lo, fp8, raw) -> List[Tuple[str, str, torch.Tensor]]:
        """The sidecars of a folded cache in route order, as ``(family,
        key, sender tensor)``: fp32 lo halves, fp8 leaves, raw leaves."""
        sides = []
        for r in self.plan.routes:
            if r.route == "fp32_hilo":
                sides.append(("lo", r.key, lo[r.key]))
            elif r.route == "fp8":
                sides.append(("fp8", r.key, fp8[r.key]))
            elif r.route == "raw":
                sides.append(("raw", r.key, raw[r.key]))
        return sides

    def shadow_hits(self, stream: torch.Tensor, sides, entry: _PrefixEntry
                    ) -> torch.Tensor:
        """Which segments and sidecars equal ``entry``'s shadows, bit for
        bit, as one bool tensor on the stream's device: one element per
        segment, then one per sidecar in ``sides`` order.

        The stream compares in one pass into a ``(n_segments, per)`` buffer
        padded with True past the stream's end, reduced with
        ``all(dim=1)``; no host sync happens here."""
        segs = self.plan.segments
        n = stream.numel()
        per = segs[0].n_elements
        if self._hit_buf is None:
            self._hit_buf = torch.ones(len(segs) * per, dtype=torch.bool,
                                       device=stream.device)
        torch.eq(C.signed_view(stream), entry.stream, out=self._hit_buf[:n])
        flags = [self._hit_buf.view(len(segs), per).all(dim=1)]
        for fam, k, sender in sides:
            shadow = entry.side_shadow[f"{fam}:{k}"]
            flags.append((_bits(sender) == _bits(shadow)).all().reshape(1)
                         .to(stream.device))
        return torch.cat(flags)

    # -- persistent executor -------------------------------------------------
    def save(self, path: str, tree, *, extra: Optional[Dict] = None,
             check: bool = True) -> str:
        """Write ``tree`` to ``path`` as one SZ02 file per routed leaf plus a
        plan-derived JSON manifest (``docs/wire_format.md`` §9), byte for
        byte what the JAX package writes for the same tree.

        Routes run as on the wire: a 'splitzip' leaf becomes an SZ02 payload
        (with its Fletcher-32 frame table), an 'fp32_hilo' leaf the SZ02
        payload of its hi half followed by the raw lo bytes, an 'fp8' leaf
        an SZ02 payload under the fp8 codebook, a 'raw' leaf its exact
        bytes.  Everything is written into a temporary directory beside
        ``path`` and renamed into place, so ``path`` is either absent or
        complete.  Returns ``path``; the accounting is in ``last_stats``."""
        if self.plan.mesh is not None:
            raise ValueError("save/load run on host files; build the plan "
                             "with mesh=None")
        if check:
            self._check_structure(tree)
        self._uid += 1
        plan, tc = self.plan, self.plan.tc
        wire_be = get_backend("wire")
        stats = TransferStats(chunk_wire_bytes=[], chunk_ok=[],
                              raw_passthrough_bytes=0.0,
                              n_elements=plan.stream_len)
        flat = TR.flatten_with_path(tree)[0]
        parent = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=parent, prefix=".tmp_persist_")
        entries = []
        try:
            for i, ((_, leaf), r) in enumerate(zip(flat, plan.routes)):
                fname = f"leaf_{i:05d}.szc"
                payload, tail = b"", b""
                if r.route == "splitzip":
                    payload = wire_be.encode(leaf, tc.codebook,
                                             chunk=tc.chunk).payload
                    stats.leaf_wire_bytes[r.key] = float(len(payload))
                    stats.leaf_ok[r.key] = True
                elif r.route == "fp32_hilo":
                    hi, lo = _fp32_halves(leaf)
                    payload = wire_be.encode(hi, tc.codebook,
                                             chunk=tc.chunk).payload
                    tail = _host_bytes(lo)
                    stats.leaf_wire_bytes[r.key] = float(len(payload))
                    stats.leaf_ok[r.key] = True
                    stats.fp32_lo_wire_bytes += float(len(tail))
                elif r.route == "fp8":
                    payload = wire_be.encode(leaf, plan.fp8_codebook,
                                             chunk=tc.chunk).payload
                    stats.fp8_wire_bytes += float(len(payload))
                    stats.leaf_ok[r.key] = True
                else:
                    tail = _host_bytes(leaf)
                    stats.raw_passthrough_bytes += float(len(tail))
                blob = payload + tail
                with open(os.path.join(tmp, fname), "wb") as f:
                    f.write(blob)
                entries.append({
                    "key": r.key, "file": fname, "route": r.route,
                    "shape": list(r.shape), "dtype": r.dtype,
                    "sz_bytes": len(payload), "checksum": fletcher32(blob),
                })
            manifest = {"format": PERSIST_FORMAT,
                        "codebook": {"fmt": tc.codebook.fmt,
                                     "exponents": list(tc.codebook.exponents)},
                        "extra": extra or {}, "leaves": entries}
            with open(os.path.join(tmp, PERSIST_MANIFEST), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.last_stats = stats
        self._account()
        return path

    def load(self, path: str) -> Tuple[object, Dict]:
        """Read a :meth:`save` directory back into the plan's structure, bit
        for bit, onto the session's device.  Returns ``(tree, extra)``.

        Every leaf file is verified twice: its Fletcher-32 against the
        manifest, then the SZ02 payload's own frame table as it decodes
        (``wire-verify``).  A mismatch, or a fault the session's
        ``faults=`` plan injects as the file is read, re-reads the file down
        the plan's retry budget (``retry_doublings + 1`` re-reads, counted in
        ``last_stats.refetches``); corruption that persists raises
        :class:`~repro_torch.core.wire.WireIntegrityError` after
        ``last_stats`` is published, and the caller
        (``distributed/checkpoint.py``) falls back to the previous step."""
        if self.plan.mesh is not None:
            raise ValueError("save/load run on host files; build the plan "
                             "with mesh=None")
        plan, tc = self.plan, self.plan.tc
        device = resolve_device(self.device)
        self._uid += 1
        with open(os.path.join(path, PERSIST_MANIFEST)) as f:
            manifest = json.load(f)
        entries = manifest["leaves"]
        if manifest.get("format") != PERSIST_FORMAT:
            raise ValueError(f"unknown persistent format "
                             f"{manifest.get('format')!r} at {path}")
        if len(entries) != len(plan.routes):
            raise ValueError(
                f"{path} holds {len(entries)} leaves; this plan expects "
                f"{len(plan.routes)}: rebuild the plan for the structure")
        wire_ver = get_backend("wire-verify")
        stats = TransferStats(chunk_wire_bytes=[], chunk_ok=[],
                              raw_passthrough_bytes=0.0,
                              n_elements=plan.stream_len)
        leaves = []
        for i, (r, meta) in enumerate(zip(plan.routes, entries)):
            if (meta["key"] != r.key or meta["route"] != r.route
                    or tuple(meta["shape"]) != r.shape
                    or meta["dtype"] != r.dtype):
                raise ValueError(
                    f"leaf {i} ({meta['key']!r}) does not match the plan "
                    f"route {r.key!r}; structure drifted since save")
            try:
                blob = self._read_verified(os.path.join(path, meta["file"]),
                                           meta, i, stats)
            except WireIntegrityError:
                # publish the partial accounting (verify failures, re-read
                # bytes of the abandoned candidate) for the fallback policy
                stats.leaf_ok[r.key] = False
                self.last_stats = stats
                self._account()
                raise
            sz = meta["sz_bytes"]
            if r.route == "splitzip":
                ct = _persist_comp(blob[:sz], r, tc.codebook.fmt, r.dtype,
                                   device)
                leaves.append(wire_ver.decode(ct))
                stats.leaf_wire_bytes[r.key] = float(sz)
                stats.leaf_ok[r.key] = True
            elif r.route == "fp32_hilo":
                ct = _persist_comp(blob[:sz], r, tc.codebook.fmt, "uint16",
                                   device)
                hi = C.widen(wire_ver.decode(ct)).to(torch.int64)
                lo = _from_host_bytes(blob[sz:], torch.uint16, r.shape, device)
                u = (hi << 16) | C.widen(lo).to(torch.int64)
                leaves.append(C.narrow_u32(u).view(torch.int32)
                              .view(torch.float32))
                stats.leaf_wire_bytes[r.key] = float(sz)
                stats.leaf_ok[r.key] = True
                stats.fp32_lo_wire_bytes += float(len(blob) - sz)
            elif r.route == "fp8":
                ct = _persist_comp(blob[:sz], r, plan.fp8_codebook.fmt,
                                   r.dtype, device)
                leaves.append(wire_ver.decode(ct))
                stats.fp8_wire_bytes += float(sz)
                stats.leaf_ok[r.key] = True
            else:
                leaves.append(_from_host_bytes(
                    blob, C.dtype_from_name(r.dtype), r.shape, device))
                stats.raw_passthrough_bytes += float(len(blob))
        tree = TR.unflatten(plan.treedef, leaves)
        self.last_stats = stats
        self._account()
        return tree, manifest.get("extra", {})

    def _read_verified(self, fpath: str, meta: Dict, ci: int,
                       stats: TransferStats) -> bytes:
        """One leaf file off disk, Fletcher-verified against the manifest and
        read through the session's :class:`FaultChannel` when it has one (so
        injected faults exercise the re-read path).  ``retry_doublings + 2``
        reads at most, then :class:`WireIntegrityError` naming the leaf."""
        budget = self.plan.tc.retry_doublings + 2
        for attempt in range(budget):
            with open(fpath, "rb") as f:
                blob = f.read()
            intact = True
            if self._channel is not None:
                frame = self._channel.ship(
                    torch.frombuffer(bytearray(blob), dtype=torch.uint8)
                    if blob else torch.zeros(0, dtype=torch.uint8),
                    self._uid, ci, attempt)
                payload, intact = self._channel.deliver(frame)
                stats.fault_delay_s += frame.delay_s
                blob = payload.numpy().tobytes() if payload is not None else b""
            if intact and fletcher32(blob) == meta["checksum"]:
                return blob
            stats.verify_failures += 1
            if attempt + 1 < budget:
                stats.refetches += 1
                stats.refetch_wire_bytes += float(len(blob))
        raise WireIntegrityError((ci,))

    # -- collective executor (compressed ring all-reduce) --------------------
    def ring_reduce(self, stacked, *, axis: str = "pod", mean: bool = True,
                    ratio: Optional[float] = None, check: bool = True):
        """Rotating-ring compressed all-reduce over the mesh dimension
        ``axis``: each participant's contribution circles the ring as a
        compressed stream ((n - 1) hops: encode, send to ``i + 1``,
        receive from ``i - 1``, decode, add in f32).  Input leaves carry a
        leading ``axis``-stacked dimension and every rank passes the whole
        stacked tree; rank ``i`` contributes its own row (the first of its
        block, as the JAX body's ``lf[0]``).  Output leaves drop that
        dimension, and each rank keeps its own f32 sum (the JAX output is
        ``P()`` with ``check_vma=False``: device by device, not one
        replicated value).

        Every hop counts its encode's ``ok``; the counts are summed over
        the ring, and a leaf that falls short of n(n - 1) anywhere re-runs
        on the raw, bit-pinned ring.  ``last_stats`` is the JAX package's
        analytic ``_ring_stats`` (compressed hops priced at ``ratio``, else
        raw); ``last_comm`` what this rank handed to ``torch.distributed``,
        with the host time of each hop."""
        self._ring_axis(axis)
        if check:
            self._check_structure(stacked)
        self._ring_participant_routes(axis)
        n = mesh_shape(self.plan.mesh)[axis]
        i = self.plan.mesh.get_local_rank(axis)
        return self._ring_reduce([leaf[i * (leaf.shape[0] // n)]
                                  for leaf in TR.leaves(stacked)],
                                 axis, mean, ratio)

    def ring_reduce_own(self, own, *, axis: str = "pod", mean: bool = True,
                        ratio: Optional[float] = None):
        """``ring_reduce`` from this rank's own contribution alone, for a
        plan stacked one row a participant: ``own`` has the plan's
        structure without the leading ``axis`` dimension (the row
        ``ring_reduce`` would read), so no stacked tree is built."""
        self._ring_axis(axis)
        routes = self._ring_participant_routes(axis)
        flat, treedef = TR.flatten_with_path(own)
        if treedef != self.plan.treedef or len(flat) != len(routes) or any(
                (1,) + tuple(x.shape) != r.shape
                or C.dtype_name(x.dtype) != r.dtype
                for (_, x), r in zip(flat, routes)):
            raise ValueError(
                "ring_reduce_own: the tree is not one participant's row of "
                "this TransferPlan's structure")
        return self._ring_reduce([x for _, x in flat], axis, mean, ratio)

    def _ring_axis(self, axis: str) -> None:
        mesh = self.plan.mesh
        if mesh is None or axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"ring_reduce needs a mesh plan with a "
                             f"{axis!r} axis")

    def _ring_reduce(self, xs, axis: str, mean: bool,
                     ratio: Optional[float]):
        """The ring over this rank's contributions ``xs`` (leaf order)."""
        plan = self.plan
        self._uid += 1
        routes = self._ring_participant_routes(axis)
        if any(r.route == "fp32_hilo" for r in routes):
            raise ValueError(
                "ring_reduce does not take the fp32 hi/lo route (build "
                "the gradient plan with compress_fp32=False); fp32 "
                "leaves ship raw, bit-pinned")
        t0 = time.perf_counter()
        n = mesh_shape(plan.mesh)[axis]
        i = plan.mesh.get_local_rank(axis)
        group = plan.mesh.get_group(axis)
        comm = CL.CommStats(hop_s=[0.0] * (n - 1))
        self.last_comm = comm
        device = xs[0].device if xs else torch.device("cpu")
        link = CL.Link(group, device, comm)
        books = {"splitzip": plan.tc.codebook, "fp8": plan.fp8_codebook}
        sums, oks = [], []
        for x, r in zip(xs, routes):
            total, ok = self._ring_leaf(link, x, books.get(r.route), r.cap,
                                        n, i)
            sums.append(total)
            oks.append(ok)
        counts = torch.tensor(oks, dtype=torch.int64)
        dist.all_reduce(counts, group=group)
        failed = frozenset(j for j, c in enumerate(AB.host_values(
            counts, [n * (n - 1)] * len(oks))) if c != n * (n - 1))
        for j in sorted(failed):
            sums[j], _ = self._ring_leaf(link, xs[j], None, 0, n, i)
        out = [((t / n) if mean else t).to(x.dtype) for t, x in zip(sums, xs)]
        synchronize(device)
        comm.seconds = time.perf_counter() - t0
        self.last_stats = self._ring_stats(axis, ratio, failed)
        self._account()
        return TR.unflatten(plan.treedef, out)

    def _ring_leaf(self, link: CL.Link, x: torch.Tensor, codebook, cap: int,
                   n: int, i: int):
        """One leaf around the ring: ``(f32 sum, hops whose encode held)``.
        ``codebook=None`` is the raw ring.  The JAX order: ``acc = x``,
        then ``acc += rotating`` a hop.  A stream that arrives with its
        ``ok`` flag down is not decoded: the leaf re-runs raw anyway."""
        tc, be = self.plan.tc, self.plan.backend
        acc = x.to(torch.float32)
        rotating, ok = x, 0
        nxt, prv = (i + 1) % n, (i - 1) % n
        for h in range(n - 1):
            t0 = time.perf_counter()
            if codebook is None:
                rec, parts = CL.raw_unit(rotating)
                ok += 1
            else:
                ct = be.encode(rotating, codebook, chunk=tc.chunk, cap=cap,
                               layout=tc.layout)
                ok += int(AB.host_bool(be.ok(ct)))
                rec, parts = CL.comp_unit(ct)
            (got,), body = link.exchange(nxt, prv, [(rec, parts)], 1)
            if got[0] == CL.RAW:
                rotating = body.raw(tuple(x.shape), x.dtype)
            else:
                ct = body.comp(got, n=x.numel(), shape=tuple(x.shape),
                               dtype=C.dtype_name(x.dtype),
                               codebook=codebook, chunk=tc.chunk)
                if AB.host_bool(ct.ok):
                    rotating = be.decode(ct).reshape(x.shape)
            body.end_unit()
            body.done()
            acc = acc + rotating.to(torch.float32)
            synchronize(x.device)
            link.stats.hop_s[h] += time.perf_counter() - t0
        return acc, ok

    def _ring_participant_routes(self, axis: str):
        """Per-participant routes: the plan was built over ``axis``-stacked
        leaves, so re-resolve on the stripped shapes (the per-hop payloads)
        — this is where ``tc.min_compress_elems`` bites."""
        if self._ring_routes is None:
            n = mesh_shape(self.plan.mesh)[axis]
            local = []
            for r in self.plan.routes:
                if not r.shape or r.shape[0] % n:
                    raise ValueError(
                        f"ring_reduce leaf {r.key!r} has no leading "
                        f"{axis}-divisible dimension (shape {r.shape})")
                local.append(torch.empty(
                    (r.shape[0] // n,) + r.shape[1:],
                    dtype=C.dtype_from_name(r.dtype), device="meta"))
            lp = TransferPlan.build(TR.unflatten(self.plan.treedef, local),
                                    self.plan.tc, granularity="tensor")
            self._ring_routes = lp.routes
        return self._ring_routes

    def _ring_stats(self, axis: str, ratio: Optional[float],
                    failed: frozenset = frozenset()) -> TransferStats:
        """Analytic per-call accounting for the collective executor, the
        JAX package's: compressed hops at ``ratio`` (else raw), a failed
        leaf's wasted compressed pass plus its raw re-run as a raw
        re-fetch."""
        hops = mesh_shape(self.plan.mesh)[axis] - 1
        routes = self._ring_participant_routes(axis)
        stats = TransferStats(chunk_wire_bytes=[], chunk_ok=[],
                              raw_passthrough_bytes=0.0,
                              n_elements=sum(r.n_elements for r in routes
                                             if r.route != "raw"))
        rho = ratio if ratio is not None else 1.0
        for j, r in enumerate(routes):
            if r.route == "raw":
                stats.raw_passthrough_bytes += r.raw_bytes * hops
            elif j in failed:
                stats.leaf_wire_bytes[r.key] = r.raw_bytes / rho * hops
                stats.leaf_ok[r.key] = False
                stats.refetches += 1
                stats.raw_refetches += 1
                stats.refetch_wire_bytes += r.raw_bytes * hops
            elif r.route == "fp8":
                stats.fp8_wire_bytes += r.raw_bytes / rho * hops
                stats.leaf_ok[r.key] = True
            else:
                stats.leaf_wire_bytes[r.key] = r.raw_bytes / rho * hops
                stats.leaf_ok[r.key] = True
        return stats

    # -- reshard hop -----------------------------------------------------------
    def reshard(self, tree, dst=None, *, check: bool = True,
                verify: Optional[bool] = None):
        """One reshard hop: encode every routed leaf, ship the streams
        through this session's wire (integrity framing and re-fetches
        included when the session carries ``verify=`` / ``faults=``),
        decode, and place the result on ``dst``: None (where it decoded),
        one device for every leaf, or a pytree of devices matching
        ``tree`` (the counterpart of ``device_put`` onto shardings).
        Bit-exact end to end."""
        if self.plan.mesh is not None:
            raise ValueError(
                "reshard ships host-staged streams (the old mesh may not "
                "exist anymore); build the plan with mesh=None")
        self._set_verify(verify)
        self.send(tree, check=check)
        out = self.recv()
        if dst is None:
            return out
        if isinstance(dst, (str, torch.device)):
            return TR.unflatten(self.plan.treedef,
                                [x.to(dst) for x in TR.leaves(out)])
        devices = TR.leaves(dst)
        if len(devices) != len(self.plan.routes):
            raise ValueError(f"{len(devices)} devices for "
                             f"{len(self.plan.routes)} leaves")
        return TR.unflatten(self.plan.treedef,
                            [x.to(d) for x, d in zip(TR.leaves(out), devices)])

    # -- internals -----------------------------------------------------------
    def _check_structure(self, cache) -> None:
        if not self.plan.matches(cache):
            raise ValueError(
                "cache structure does not match this TransferPlan; rebuild "
                "the plan for the new structure (TransferPlan.build)")

    def _account(self) -> None:
        self.calls += 1
        if self.last_stats is not None:
            if self._channel is not None:
                # per-call slice of the channel's running fault counter
                self.last_stats.faults_injected = (self._channel.injected
                                                   - self._injected_seen)
                self._injected_seen = self._channel.injected
            self.total_wire_bytes += self.last_stats.wire_bytes

    # -- local / tensor ------------------------------------------------------
    def _send_tensor(self, cache):
        stats = TransferStats(chunk_wire_bytes=[], chunk_ok=[],
                              raw_passthrough_bytes=0.0, n_elements=0)
        comp, raw = encode_leaves(self.plan, cache, scheduled=True,
                                  stats=stats)
        if self.retain_last:
            self._retained = (comp, raw, cache)
        self.last_stats = stats
        if self._channel is None:
            return comp, raw, cache, None, None
        # frame every wire object; keep the pristine dicts sender-side so a
        # verified re-fetch can re-ship the exact same object
        comp_f, raw_f = self._frame_tensor(comp, raw)
        return comp_f, raw_f, cache, comp, raw

    def _frame_tensor(self, comp, raw):
        """Frame the tensor path's wire objects: compressed entries first,
        then raw ones, numbered in that order (the fault coordinate)."""
        comp_f = {k: self._channel.ship(v, self._uid, ci, 0)
                  for ci, (k, v) in enumerate(comp.items())}
        raw_f = {k: self._channel.ship(v, self._uid, len(comp) + ci, 0)
                 for ci, (k, v) in enumerate(raw.items())}
        return comp_f, raw_f

    def _recv_tensor(self, payload):
        comp, raw, structure, pristine_comp, pristine_raw = payload
        if self._channel is not None:
            comp, raw = self._deliver_tensor(comp, raw, structure,
                                             pristine_comp, pristine_raw)
        return decode_leaves(comp, raw, structure, self.plan.backend)

    def _deliver_tensor(self, comp_f, raw_f, structure, pristine_comp,
                        pristine_raw):
        """Unframe + verify every tensor-path entry.  A compressed entry
        whose re-ships exhaust the retry budget falls back to the whole
        ORIGINAL leaf shipped raw (mirroring the encode-overflow fallback);
        raw entries re-ship themselves until intact."""
        stats = self.last_stats
        leaves = {TR.leaf_key(p): leaf
                  for p, leaf in TR.flatten_with_path(structure)[0]}
        comp: Dict[str, object] = {}
        raw: Dict[str, object] = {}
        ci = 0
        for key, frame in comp_f.items():
            base = key[:-3] if key.endswith("#hi") else key
            obj, fell_raw = self._deliver_entry(
                frame, ci, stats, resend=pristine_comp[key],
                raw_payload=leaves[base])
            if fell_raw:
                raw[base] = obj      # whole leaf ships raw; lo sidecar unused
            else:
                comp[key] = obj
            ci += 1
        for key, frame in raw_f.items():
            obj, _ = self._deliver_entry(frame, ci, stats,
                                         resend=pristine_raw[key],
                                         raw_payload=pristine_raw[key])
            raw.setdefault(key, obj)
            ci += 1
        return comp, raw

    def _deliver_entry(self, frame, ci: int, stats: TransferStats, *,
                       resend, raw_payload):
        """``(payload, used_raw_fallback)`` for one framed wire entry.

        Verified mode re-fetches on mismatch/drop: ``retry_doublings + 1``
        re-ships of the staged compressed object (each attempt re-keys the
        fault plan, so injected faults re-roll), then the raw payload as the
        terminal re-fetch — itself verified and retried, failing loud past
        ``_MAX_WIRE_ATTEMPTS``.  Unverified mode delivers whatever arrived
        (corruption flows through undetected — the hazard ``verify=``
        closes); only a full drop heals from the staged raw payload."""
        payload, intact = self._channel.deliver(frame)
        stats.fault_delay_s += frame.delay_s
        if not self.verify:
            if payload is None:      # dropped in flight: heal from the
                return raw_payload, True  # staged raw payload, raw-routed
            return payload, False
        is_raw = resend is raw_payload
        attempt = 1
        while not intact:
            if attempt <= self.plan.tc.retry_doublings + 1:
                obj, is_raw = resend, resend is raw_payload
            else:
                obj, is_raw = raw_payload, True
            payload, intact = self._refetch(ci, attempt, obj, is_raw,
                                            self._object_wire_bytes(obj),
                                            stats, f"wire entry {ci}")
            attempt += 1
        return payload, is_raw

    def _refetch(self, ci: int, attempt: int, obj, is_raw: bool,
                 nbytes: float, stats: TransferStats, what: str):
        """One verified re-fetch after a failed delivery: count it, re-ship
        ``obj`` with the fault coordinate re-keyed to ``attempt``, deliver."""
        stats.verify_failures += 1
        if attempt >= _MAX_WIRE_ATTEMPTS:
            raise TransferIntegrityError(
                f"{what}: integrity not established after {attempt} "
                "attempts (raw re-fetches included)")
        stats.refetches += 1
        stats.raw_refetches += int(is_raw)
        stats.refetch_wire_bytes += nbytes
        frame = self._channel.ship(obj, self._uid, ci, attempt)
        stats.fault_delay_s += frame.delay_s
        return self._channel.deliver(frame)

    def _object_wire_bytes(self, obj) -> float:
        """Bytes ``obj`` puts on the wire: a tensor its raw bytes, a
        compressed object (an fp8 sidecar re-fetched as its own terminal
        payload included) its codec's wire bytes."""
        if isinstance(obj, torch.Tensor):
            return float(obj.numel() * obj.element_size())
        return float(_backend_for(obj, self.plan.backend).wire_bytes(obj))

    # -- local / chunked -----------------------------------------------------
    def _encode_chunk(self, stream, i: int):
        """Encode segment ``i`` at base capacity (schedule step 0)."""
        seg = self.plan.segments[i]
        tc = self.plan.tc
        return self.plan.backend.encode(
            stream[seg.start:seg.stop], tc.codebook, chunk=tc.chunk,
            cap=seg.cap, layout=tc.layout)

    def _ship_chunk(self, stream, i: int, ct, stats: TransferStats):
        """The capacity-schedule walk for chunk ``i``: on overflow re-encode
        down the remaining schedule, then raw fallback.  Returns the payload
        to ship (compressed object, or None when the chunk ships its raw
        bits)."""
        plan, tc = self.plan, self.plan.tc
        seg = plan.segments[i]
        be = plan.backend
        ok = AB.host_bool(be.ok(ct))
        extra = 0
        if not ok:
            for rbe, layout, cap in plan.schedule_for(seg.n_elements,
                                                      seg.cap)[1:]:
                extra += 1
                ct2 = rbe.encode(stream[seg.start:seg.stop], tc.codebook,
                                 chunk=tc.chunk, cap=cap, layout=layout)
                if AB.host_bool(rbe.ok(ct2)):
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
        if isinstance(payload, torch.Tensor):
            # explicit raw bits (the framed wire ships them for real)
            return payload.reshape(-1)
        return _backend_for(payload, self.plan.backend).decode_bits(
            payload).reshape(-1)

    def _wire_hop(self, stream, i: int, ct, stats: TransferStats):
        """Chunk ``i``'s full send side: the capacity-schedule walk, then the
        checksum-framed channel when active, as ``(frame, staged)``.  Under
        a channel the raw fallback ships its EXPLICIT bits, so the wire hop
        stays falsifiable under fault injection."""
        p = self._ship_chunk(stream, i, ct, stats)
        if self._channel is None:
            return p
        seg = self.plan.segments[i]
        payload = p if p is not None else stream[seg.start:seg.stop]
        return self._channel.ship(payload, self._uid, i, 0), p

    def _chunk_out(self, stream, i: int, p, stats: TransferStats):
        if self._channel is None:
            return self._decode_chunk(stream, i, p)
        return self._deliver_chunk(stream, i, *p, stats)

    def _deliver_chunk(self, stream, i: int, frame, staged,
                       stats: TransferStats):
        """Receiver side of chunk ``i`` under an active channel.  Verified
        mode re-fetches a mismatched/dropped frame: the staged compressed
        chunk again for each remaining step of the capacity schedule (the
        attempt re-keyed so injected faults re-roll), then the chunk's raw
        bits (also verified).  Never hands corrupt bytes to the decoder;
        fails loud past ``_MAX_WIRE_ATTEMPTS``."""
        seg = self.plan.segments[i]
        payload, intact = self._channel.deliver(frame)
        stats.fault_delay_s += frame.delay_s
        if not self.verify:
            # unverified: corruption flows through; a drop falls back to the
            # local-slice shortcut (visible only in channel.injected)
            return self._decode_chunk(stream, i, payload)
        steps = len(self.plan.schedule_for(seg.n_elements, seg.cap))
        attempt = 1
        while not intact:
            if attempt < steps and staged is not None:
                obj, nbytes, is_raw = (staged, float(
                    self.plan.backend.wire_bytes(staged)), False)
            else:
                obj, nbytes, is_raw = (stream[seg.start:seg.stop],
                                       seg.raw_bytes, True)
            payload, intact = self._refetch(i, attempt, obj, is_raw, nbytes,
                                            stats, f"chunk {i}")
            attempt += 1
        return self._decode_chunk(stream, i, payload)

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

    def _ship_sidecars(self, lo, fp8_payload, raw):
        """Frame the non-pipelined wire objects (lo halves, fp8 sidecars,
        raw passthrough).  Numbering continues past the pipeline chunks so
        every fault coordinate stays unique within the transfer."""
        framed = {}
        ci = self.plan.n_chunks
        for name, d in (("lo", lo), ("fp8", fp8_payload), ("raw", raw)):
            framed[name] = {k: self._channel.ship(v, self._uid, ci + j, 0)
                            for j, (k, v) in enumerate(d.items())}
            ci += len(d)
        return framed["lo"], framed["fp8"], framed["raw"]

    def _deliver_sidecars(self, lo_f, fp8_f, raw_f, pristine, stats):
        """Unframe + verify the sidecars; a faulted sidecar re-ships its
        pristine object (it IS the terminal payload) until intact."""
        out = []
        ci = self.plan.n_chunks
        for frames, orig in zip((lo_f, fp8_f, raw_f), pristine):
            d = {}
            for j, (k, frame) in enumerate(frames.items()):
                d[k], _ = self._deliver_entry(frame, ci + j, stats,
                                              resend=orig[k],
                                              raw_payload=orig[k])
            out.append(d)
            ci += len(frames)
        return out

    def _send_chunked(self, cache):
        stats = self._new_chunked_stats()
        stream, lo, fp8_payload, raw = self._chunked_sidecars(cache, stats)
        in_flight = [self._wire_hop(stream, i, self._encode_chunk(stream, i),
                                    stats)
                     for i in range(self.plan.n_chunks)]
        self.last_stats = stats
        if self._channel is None:
            return stream, in_flight, lo, fp8_payload, raw, None
        pristine = (lo, fp8_payload, raw)
        lo_f, fp8_f, raw_f = self._ship_sidecars(lo, fp8_payload, raw)
        return stream, in_flight, lo_f, fp8_f, raw_f, pristine

    def _recv_chunked(self, payload):
        stream, in_flight, lo, fp8_payload, raw, pristine = payload
        stats = self.last_stats
        decoded = [self._chunk_out(stream, i, p, stats)
                   for i, p in enumerate(in_flight)]
        if self._channel is not None:
            lo, fp8_payload, raw = self._deliver_sidecars(
                lo, fp8_payload, raw, pristine, stats)
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
                                  else _backend_for(p, plan.backend).decode(p))
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
                in_flight[xfer_i] = self._wire_hop(
                    stream, xfer_i, encoded.pop(xfer_i), stats)
            if 0 <= dec_i < n:
                decoded[dec_i] = self._chunk_out(
                    stream, dec_i, in_flight.pop(dec_i), stats)
        if self._channel is not None:
            lo_f, fp8_f, raw_f = self._ship_sidecars(lo, fp8_payload, raw)
            lo, fp8_payload, raw = self._deliver_sidecars(
                lo_f, fp8_f, raw_f, (lo, fp8_payload, raw), stats)
        self.last_stats = stats
        return self._reassemble([decoded[i] for i in range(n)], lo,
                                fp8_payload, raw)

    # -- mesh ----------------------------------------------------------------
    def _shard_plan_session(self) -> "TransferSession":
        """The session over this rank's shard shapes, built once: the JAX
        body re-resolves routing and segmentation on the per-shard views
        (at trace time); here every rank resolves them from the plan, so a
        destination rank needs no cache."""
        if self._shard_session is None:
            plan, sizes = self.plan, mesh_shape(self.plan.mesh)
            local = [torch.empty(SH.local_shape(r.shape, spec, sizes),
                                 dtype=C.dtype_from_name(r.dtype),
                                 device="meta")
                     for r, spec in zip(plan.routes, plan.in_specs)]
            self._shard_struct = TR.unflatten(plan.treedef, local)
            lp = TransferPlan.build(self._shard_struct, plan.tc,
                                    granularity=plan.granularity)
            self._shard_session = TransferSession(lp, device=self.device)
        return self._shard_session

    def _slice_shard(self, cache):
        """This rank's shard of every leaf, as ``shard_map`` hands it."""
        return TR.unflatten(self.plan.treedef, [
            SH.shard_slice(leaf, spec, self.plan.mesh)
            for leaf, spec in zip(TR.leaves(cache), self.plan.in_specs)])

    def _own_shard(self, shard):
        """``shard`` checked to be this rank's block of the plan's cache:
        its tree, dtypes and ``local_shape`` shapes."""
        plan, sizes = self.plan, mesh_shape(self.plan.mesh)
        flat, treedef = TR.flatten_with_path(shard)
        if treedef != plan.treedef or len(flat) != len(plan.routes):
            raise ValueError("the shard's tree is not the plan's cache tree")
        for (path, leaf), r, spec in zip(flat, plan.routes, plan.in_specs):
            want = SH.local_shape(r.shape, spec, sizes)
            if tuple(leaf.shape) != want or C.dtype_name(leaf.dtype) != r.dtype:
                raise ValueError(
                    f"{r.key}: a shard of {tuple(leaf.shape)} "
                    f"{C.dtype_name(leaf.dtype)}; this rank's block of "
                    f"{r.shape} under {spec} is {want} {r.dtype}")
        return shard

    def _run_mesh(self, cache, select_dst: bool = True, own: bool = False):
        """The pod-to-pod hop across processes.  Source ranks (pod
        ``src_pod``) encode their shard down the capacity schedule (raw
        fallback on exhaustion) and send it to the rank of pod ``dst_pod``
        with their (data, model) coordinate; they decode nothing and
        return None.  Destination ranks decode what arrives onto the
        session's device and return, with ``select_dst=True``, the whole
        cache (their pod's shards all-gathered over the non-pod
        dimensions), else their own shard.  Ranks of other pods return
        None.  ``last_stats``: the bytes handed to ``torch.distributed``
        for each unit (the same on both ends); ``last_comm``: headers,
        staging and wire time.  ``own``: a source passes its own shard,
        not the whole cache (:meth:`transfer_shard`)."""
        plan = self.plan
        if any("pod" in SH.entry_axes(e) for spec in plan.in_specs
               for e in spec):
            raise ValueError("mesh transfer specs shard over the data and "
                             "model dimensions, not over 'pod'")
        n_pod = mesh_shape(self.plan.mesh)["pod"]
        if (plan.src_pod == plan.dst_pod
                or not 0 <= min(plan.src_pod, plan.dst_pod)
                or max(plan.src_pod, plan.dst_pod) >= n_pod):
            raise ValueError(f"src_pod {plan.src_pod} and dst_pod "
                             f"{plan.dst_pod} must be two pods of {n_pod}")
        pod = plan.mesh.get_local_rank("pod")
        self.last_stats = None
        self.last_comm = comm = CL.CommStats()
        if pod not in (plan.src_pod, plan.dst_pod):
            return None
        t0 = time.perf_counter()
        loc = self._shard_plan_session()
        chunked = loc.plan.granularity == "chunked"
        group = plan.mesh.get_group("pod")
        if pod == plan.src_pod:
            if cache is None:
                raise ValueError("a source rank passes the cache it sends")
            shard = self._own_shard(cache) if own else self._slice_shard(cache)
            device = TR.leaves(shard)[0].device if plan.routes else "cpu"
            link = CL.Link(group, device, comm)
            send = self._mesh_send_chunked if chunked else self._mesh_send_tensor
            records, out = send(loc, link, shard), None
        else:
            device = resolve_device(self.device)
            link = CL.Link(group, device, comm)
            recv = self._mesh_recv_chunked if chunked else self._mesh_recv_tensor
            records, out = recv(loc, link)
            if select_dst:
                out = self._gather_pod(out, device, comm)
        synchronize(device)
        comm.seconds = time.perf_counter() - t0
        comm.records = records
        self.last_stats = _mesh_stats(loc.plan, records)
        return out

    def _mesh_send_tensor(self, loc, link: CL.Link, shard):
        lp = loc.plan
        scratch = TransferStats(chunk_wire_bytes=[], chunk_ok=[],
                                raw_passthrough_bytes=0.0, n_elements=0)
        comp, raw = encode_leaves(lp, shard, scheduled=True, stats=scratch)
        steps = iter(scratch.chunk_retry_steps)
        units = []
        for leaf, r in zip(TR.leaves(shard), lp.routes):
            if r.route == "raw":
                rec, ps = CL.raw_unit(leaf)
            else:
                extra = next(steps)
                key = r.key + "#hi" if r.route == "fp32_hilo" else r.key
                if key not in comp:
                    rec, ps = CL.raw_unit(leaf, CL.FALLBACK, extra)
                else:
                    rec, ps = CL.comp_unit(comp[key], extra)
                    if r.route == "fp32_hilo":
                        ps.append(raw[r.key + "#lo"])
                        rec[4] += CL.nbytes(ps[-1:])
            units.append((rec, ps))
        link.wait(link.isend(self.plan.dst_pod, units))
        return [rec for rec, _ in units]

    def _mesh_recv_tensor(self, loc, link: CL.Link):
        lp, tc = loc.plan, loc.plan.tc
        records, body = link.recv(self.plan.src_pod, len(lp.routes))
        comp: Dict[str, object] = {}
        raw: Dict[str, torch.Tensor] = {}
        for rec, r in zip(records, lp.routes):
            if rec[0] != CL.COMP:
                raw[r.key] = body.raw(r.shape, C.dtype_from_name(r.dtype))
            elif r.route == "fp32_hilo":
                comp[r.key + "#hi"] = body.comp(
                    rec, n=r.n_elements, shape=r.shape, dtype="uint16",
                    codebook=tc.codebook, chunk=tc.chunk)
                raw[r.key + "#lo"] = body.raw(r.shape, torch.uint16)
            else:
                comp[r.key] = body.comp(
                    rec, n=r.n_elements, shape=r.shape, dtype=r.dtype,
                    codebook=lp.fp8_codebook if r.route == "fp8"
                    else tc.codebook, chunk=tc.chunk)
            body.end_unit()
        body.done()
        return records, decode_leaves(comp, raw, self._shard_struct,
                                      lp.backend)

    def _mesh_send_chunked(self, loc, link: CL.Link, shard):
        """Per-chunk sends on ``ChunkSchedule``: encode chunk t while chunk
        t-1 goes on the wire; at most two chunks in flight.  The sidecars
        (fp32 lo halves, fp8 leaves, raw leaves) follow in one message."""
        lp, n, dst = loc.plan, loc.plan.n_chunks, self.plan.dst_pod
        scratch = loc._new_chunked_stats()
        stream, lo, fp8_payload, raw = loc._chunked_sidecars(shard, scratch)
        records, encoded, in_flight = [], {}, deque()
        for enc_i, xfer_i, _ in ChunkSchedule(n).stages():
            if 0 <= enc_i < n:
                encoded[enc_i] = loc._encode_chunk(stream, enc_i)
            if 0 <= xfer_i < n:
                p = loc._ship_chunk(stream, xfer_i, encoded.pop(xfer_i),
                                    scratch)
                extra = scratch.chunk_retry_steps[xfer_i]
                seg = lp.segments[xfer_i]
                rec, parts = (CL.comp_unit(p, extra) if p is not None else
                              CL.raw_unit(stream[seg.start:seg.stop],
                                          CL.FALLBACK, extra))
                if len(in_flight) == 2:
                    link.wait(in_flight.popleft())
                in_flight.append(link.isend(dst, [(rec, parts)]))
                records.append(rec)
        fp8_extra = iter(scratch.chunk_retry_steps[n:])
        side = []
        for r in lp.routes:
            if r.route == "fp32_hilo":
                rec, ps = CL.raw_unit(lo[r.key])
            elif r.route == "fp8":
                p, extra = fp8_payload[r.key], next(fp8_extra)
                rec, ps = (CL.raw_unit(p, CL.FALLBACK, extra)
                           if isinstance(p, torch.Tensor)
                           else CL.comp_unit(p, extra))
            elif r.route == "raw":
                rec, ps = CL.raw_unit(raw[r.key])
            else:
                continue
            side.append((rec, ps))
        if side:
            in_flight.append(link.isend(dst, side))
        while in_flight:
            link.wait(in_flight.popleft())
        return records + [rec for rec, _ in side]

    def _mesh_recv_chunked(self, loc, link: CL.Link):
        lp, tc, n, src = loc.plan, loc.plan.tc, loc.plan.n_chunks, self.plan.src_pod
        records, posted, decoded = [], {}, {}
        for _, xfer_i, dec_i in ChunkSchedule(n).stages():
            if 0 <= xfer_i < n:
                (rec,) = link.recv_header(src, 1)
                posted[xfer_i] = rec, link.irecv_body(src, [rec])
            if 0 <= dec_i < n:
                rec, pending = posted.pop(dec_i)
                body = link.body(pending)
                m = lp.segments[dec_i].n_elements
                payload = (body.comp(rec, n=m, shape=(m,), dtype="uint16",
                                     codebook=tc.codebook, chunk=tc.chunk)
                           if rec[0] == CL.COMP
                           else body.raw((m,), torch.uint16))
                body.end_unit()
                body.done()
                decoded[dec_i] = loc._decode_chunk(None, dec_i, payload)
                records.append(rec)
        side_routes = [r for r in lp.routes
                       if r.route in ("fp32_hilo", "fp8", "raw")]
        lo: Dict[str, torch.Tensor] = {}
        fp8_payload: Dict[str, object] = {}
        raw: Dict[str, torch.Tensor] = {}
        if side_routes:
            side, body = link.recv(src, len(side_routes))
            for rec, r in zip(side, side_routes):
                dtype = C.dtype_from_name(r.dtype)
                if r.route == "fp32_hilo":
                    lo[r.key] = body.raw((r.n_elements,), torch.uint16)
                elif r.route == "fp8" and rec[0] == CL.COMP:
                    fp8_payload[r.key] = body.comp(
                        rec, n=r.n_elements, shape=r.shape, dtype=r.dtype,
                        codebook=lp.fp8_codebook, chunk=tc.chunk)
                elif r.route == "fp8":
                    fp8_payload[r.key] = body.raw(r.shape, dtype)
                else:
                    raw[r.key] = body.raw(r.shape, dtype)
                body.end_unit()
            body.done()
            records += side
        out = loc._reassemble([decoded[i] for i in range(n)], lo,
                              fp8_payload, raw)
        return records, out

    def _gather_pod(self, shard, device, comm: CL.CommStats):
        """A destination rank's whole cache: its pod's shards all-gathered
        over every mesh dimension a leaf is split on."""
        return TR.unflatten(self.plan.treedef, [
            SH.gather(leaf.to(device), spec, self.plan.mesh, comm)
            for leaf, spec in zip(TR.leaves(shard), self.plan.in_specs)])


def _mesh_stats(lp: TransferPlan, records) -> TransferStats:
    """A mesh hop's accounting from its unit records (so both ends agree):
    each unit's bytes as handed to ``torch.distributed``."""
    n = lp.n_chunks
    stats = TransferStats(chunk_wire_bytes=[0.0] * n, chunk_ok=[True] * n,
                          raw_passthrough_bytes=0.0,
                          n_elements=lp.stream_len if n else 0,
                          chunk_retried=[False] * n,
                          chunk_retry_steps=[0] * n)
    it = iter(records)
    for i in range(n):
        kind, _, _, _, nb, extra = next(it)
        stats.chunk_wire_bytes[i] = float(nb)
        stats.chunk_ok[i] = kind == CL.COMP
        stats.chunk_retried[i] = extra > 0
        stats.chunk_retry_steps[i] = extra
    for r in lp.routes:
        if n and r.route == "splitzip":
            continue                       # folded into the stream
        kind, _, _, _, nb, extra = next(it)
        nb, ok = float(nb), kind == CL.COMP
        if r.route == "raw":
            stats.raw_passthrough_bytes += nb
        elif r.route == "fp32_hilo" and n:
            stats.fp32_lo_wire_bytes += nb  # the lo sidecar; hi is folded
        elif r.route == "fp8":
            stats.fp8_wire_bytes += nb
            _record_unit(stats, r.key, ok, extra)
        else:
            lo = 2.0 * r.n_elements if (ok and r.route == "fp32_hilo") else 0.0
            stats.leaf_wire_bytes[r.key] = nb - lo
            stats.fp32_lo_wire_bytes += lo
            _record_unit(stats, r.key, ok, extra)
    return stats
