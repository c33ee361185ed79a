"""The wire of the collective executors: bit-pinned messages between ranks.

The mesh executor, the ring all-reduce and ``select_dst``'s gather move
bytes between processes over ``torch.distributed``.  Every message is a
header (one record of int64 fields a unit) and a body: the units' tensors
as their exact bytes, each taken through a same-width integer view
(:func:`repro_torch.core.codec.signed_view`) and then a byte view, so no
transport can round or widen a float on the way.  The counterpart of the
JAX package's bit-pinned ``ppermute`` (``repro.serving.session._permute_leaf``).

A compressed unit ships its sign-mantissa and code streams, its per-row
escape counts, its ``ok`` byte and only the escape slots the counts say are
used; the receiver rebuilds the fixed-capacity escape buffers with the
codec's own padding (position ``chunk``, or ``n_padded`` for the global
layout, value 0), so it decodes the streams the sender encoded.  The JAX
permute ships the whole buffers: 3 bytes (4 + 1 for the global layout) for
every unused slot.

Each unit starts 16-byte aligned in the body (zero bytes pad the one
before it; counted in :class:`CommStats`, not in the unit's bytes), so the
codec kernels read the received streams in place.

Transport: gloo only.  Gloo's send and receive read a raw host pointer, so
a unit that lives on the card is staged through a pinned host buffer (one
copy out on the sender, one copy in on the receiver), and the staging time
and bytes are counted (:class:`CommStats`).  NCCL needs one GPU a rank and
raises until a multi-card machine runs it; nothing falls back from one
transport to another.  The dry run's ``fake`` group is taken only inside
its abstract run (:mod:`repro_torch.core.abstract`), where no byte moves:
there a fake body ships every escape slot (the plan's capacity-sized
payload), a header arrives as its sender posted it, and each call's bytes
are tallied by collective kind.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import abstract as AB
from repro_torch.core import codec as C
from repro_torch.core.codebook import Codebook

# unit kinds in a record
RAW, COMP, FALLBACK = 0, 1, 2
# record fields: kind, layout (0 chunked / 1 global), cap, used escape
# slots, body bytes, extra encode attempts on the capacity schedule
REC = 6


@dataclasses.dataclass
class CommStats:
    """What one rank handed to and took from ``torch.distributed`` in one
    executor call (host clock)."""

    sent_bytes: float = 0.0       # headers and bodies handed to send
    recv_bytes: float = 0.0       # headers and bodies received
    header_bytes: float = 0.0     # of which headers, both directions
    messages: int = 0             # headers and bodies sent or received
    staging_s: float = 0.0        # device <-> pinned host copies
    wire_s: float = 0.0           # blocked in send / recv / wait
    seconds: float = 0.0          # the whole call
    hop_s: List[float] = dataclasses.field(default_factory=list)  # ring
    # the mesh hop's unit records (kind, layout, cap, used escape slots,
    # body bytes, extra encode attempts), in send order
    records: List[List[int]] = dataclasses.field(default_factory=list)

    @property
    def codec_s(self) -> float:
        """The call's host time outside staging and the wire: encode or
        decode, packing, and the ring's f32 adds."""
        return self.seconds - self.staging_s - self.wire_s


def check_transport(group) -> None:
    """Refuse every transport but gloo; the ``fake`` group of the dry run
    only inside its abstract run."""
    backend = str(dist.get_backend(group))
    if backend == "fake" and AB.current() is not None:
        return
    if backend != "gloo":
        raise NotImplementedError(
            f"the collective executors run over gloo only; this group's "
            f"backend is {backend!r} (NCCL needs one GPU a rank and waits "
            "for a multi-card machine)")


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, through its same-width integer view."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return C.signed_view(t).contiguous().reshape(-1).view(torch.uint8)


def nbytes(parts: Sequence[torch.Tensor]) -> int:
    return sum(p.numel() * p.element_size() for p in parts)


ALIGN = 16


def _padded(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


# ---------------------------------------------------------------------------
# units: (record, parts)
# ---------------------------------------------------------------------------

def raw_unit(x: torch.Tensor, kind: int = RAW, extra: int = 0):
    return [kind, 0, 0, 0, nbytes([x]), extra], [x]


def _used_slots(esc_count: torch.Tensor, cap: int) -> torch.Tensor:
    """Mask of the escape slots in use: ``j < count`` a row (the global
    layout has one row and one count)."""
    j = torch.arange(cap, device=esc_count.device)
    return j[None, :] < torch.clamp(esc_count.to(torch.int64), max=cap)[:, None]


def comp_unit(ct: C.CompressedTensor, extra: int = 0):
    """A compressed object as a unit: its streams, counts, ok byte and
    used escape slots (shipped whatever ``ok`` says: the ring ships an
    overflowed stream as the JAX ring does)."""
    used = _used_slots(ct.esc_count, ct.esc_pos.shape[1])
    pos, val = AB.used_slots(used, C.signed_view(ct.esc_pos), ct.esc_val)
    parts = [ct.sign_mantissa, ct.packed, ct.esc_count, ct.ok.reshape(1),
             pos, val]
    rec = [COMP, int(ct.layout == "global"), ct.cap, int(parts[4].numel()),
           nbytes(parts), extra]
    return rec, parts


class Body:
    """Cursor over a received body (bytes on the codec's device)."""

    def __init__(self, buf: torch.Tensor):
        self.buf, self.off = buf, 0

    def end_unit(self) -> None:
        """Skip the padding after a unit: the next one starts aligned."""
        self.off = _padded(self.off)

    def done(self) -> None:
        if self.off != self.buf.numel():
            raise RuntimeError(f"message body of {self.buf.numel()} bytes, "
                               f"{self.off} unpacked")

    def take(self, n: int, dtype: torch.dtype, shape=None) -> torch.Tensor:
        size = torch.empty(0, dtype=dtype).element_size()
        seg = self.buf[self.off:self.off + n * size]
        self.off += n * size
        if seg.storage_offset() % ALIGN:
            seg = seg.clone()
        out = seg.view(dtype)
        return out.reshape(shape) if shape is not None else out

    def raw(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return self.take(math.prod(shape), dtype, tuple(shape))

    def comp(self, rec, *, n: int, shape, dtype: str, codebook: Codebook,
             chunk: int) -> C.CompressedTensor:
        """Rebuild the compressed object ``comp_unit`` packed."""
        glob, cap, used = bool(rec[1]), int(rec[2]), int(rec[3])
        n_pad = -(-n // chunk) * chunk
        rows = 1 if glob else n_pad // chunk
        sm = self.take(n_pad, torch.uint8)
        packed = self.take(n_pad // 2 if codebook.k <= 16 else n_pad,
                           torch.uint8)
        count = self.take(rows, torch.int32)
        ok = self.take(1, torch.uint8).reshape(()).to(torch.bool)
        pos = self.take(used, torch.int32 if glob else torch.int16)
        val = self.take(used, torch.uint8)
        pos_full = torch.full((rows, cap), n_pad if glob else chunk,
                              dtype=torch.int64, device=sm.device)
        val_full = torch.zeros((rows, cap), dtype=torch.uint8, device=sm.device)
        mask = _used_slots(count, cap)
        AB.fill_used_slots(pos_full, mask,
                           C.widen(C.unsigned_view(pos)).to(torch.int64))
        AB.fill_used_slots(val_full, mask, val)
        return C.CompressedTensor(
            sign_mantissa=sm, packed=packed,
            esc_pos=(C.narrow_u32 if glob else C.narrow_u16)(pos_full),
            esc_val=val_full, esc_count=count, ok=ok, shape=tuple(shape),
            dtype=dtype, fmt=codebook.fmt,
            exponents=tuple(int(e) for e in codebook.exponents), chunk=chunk,
            cap=cap, layout="global" if glob else "chunked")


# ---------------------------------------------------------------------------
# the link
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Pending:
    works: list
    keep: tuple               # buffers that must outlive the works


class Link:
    """Ordered messages over one process group (group ranks as peers),
    staged through the host for gloo.  ``device`` is where received bodies
    land: the codec's device."""

    def __init__(self, group, device, stats: CommStats):
        check_transport(group)
        self.group, self.device, self.stats = group, torch.device(device), stats

    # -- staging ---------------------------------------------------------------
    def _to_host(self, units) -> torch.Tensor:
        """The units' bytes in one buffer, each unit padded to ``ALIGN``,
        on the host (pinned, for a body on the card)."""
        flat = []
        for _, parts in units:
            ps = [byte_view(p) for p in parts if p.numel()]
            pad = _padded(nbytes(ps)) - nbytes(ps)
            if pad:
                dev = ps[0].device if ps else torch.device("cpu")
                ps.append(torch.zeros(pad, dtype=torch.uint8, device=dev))
            flat.extend(ps)
        return self._stage(flat)

    def _stage(self, flat) -> torch.Tensor:
        """Byte tensors back to back in one buffer on the host (pinned, for
        bytes on the card)."""
        if not flat:
            return torch.zeros(0, dtype=torch.uint8)
        body = torch.cat(flat) if len(flat) > 1 else flat[0]
        if body.device.type == "cpu":
            return body
        t0 = time.perf_counter()
        host = torch.empty(body.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(body)
        self.stats.staging_s += time.perf_counter() - t0
        return host

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cpu":
            return host
        t0 = time.perf_counter()
        out = host.to(self.device)
        torch.cuda.synchronize(self.device)
        self.stats.staging_s += time.perf_counter() - t0
        return out

    def _host_buffer(self, n: int) -> torch.Tensor:
        return torch.empty(n, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")

    # -- messages --------------------------------------------------------------
    def isend(self, peer: int, units) -> _Pending:
        """Post one message (header, then body) of ``units``, each a
        ``(record, parts)`` pair, to group rank ``peer``."""
        records = [rec for rec, _ in units]
        header = torch.tensor([v for rec in records for v in rec],
                              dtype=torch.int64)
        body = self._to_host(units)
        assert body.numel() == sum(_padded(rec[4]) for rec in records)
        t0 = time.perf_counter()
        works = [dist.isend(header, group=self.group, group_dst=peer)]
        if body.numel():
            works.append(dist.isend(body, group=self.group, group_dst=peer))
        self.stats.wire_s += time.perf_counter() - t0
        hb = header.numel() * 8
        self.stats.sent_bytes += hb + body.numel()
        self.stats.header_bytes += hb
        self.stats.messages += len(works)
        run = AB.current()
        if run is not None:
            run.post(dist.get_rank(),
                     dist.get_global_rank(self.group, peer), records)
            run.collective("collective-permute", hb + body.numel(),
                           self.group.group_name)
        return _Pending(works, (header, body))

    def wait(self, pending: _Pending) -> None:
        t0 = time.perf_counter()
        for w in pending.works:
            w.wait()
        self.stats.wire_s += time.perf_counter() - t0

    def recv_header(self, peer: int, n_records: int) -> List[List[int]]:
        header = torch.empty(n_records * REC, dtype=torch.int64)
        t0 = time.perf_counter()
        dist.recv(header, group=self.group, group_src=peer)
        self.stats.wire_s += time.perf_counter() - t0
        self.stats.recv_bytes += header.numel() * 8
        self.stats.header_bytes += header.numel() * 8
        self.stats.messages += 1
        if AB.is_fake(header):
            return AB.current().collect(dist.get_global_rank(self.group, peer),
                                        dist.get_rank(), n_records)
        vals = header.tolist()
        return [vals[i:i + REC] for i in range(0, len(vals), REC)]

    def irecv_body(self, peer: int, records) -> _Pending:
        n = sum(_padded(rec[4]) for rec in records)
        buf = self._host_buffer(n)
        works = []
        if n:
            works.append(dist.irecv(buf, group=self.group, group_src=peer))
            self.stats.messages += 1
        self.stats.recv_bytes += n
        return _Pending(works, (buf,))

    def body(self, pending: _Pending) -> Body:
        """Wait for a posted body and bring it to the codec's device."""
        self.wait(pending)
        return Body(self._to_device(pending.keep[0]))

    def recv(self, peer: int, n_records: int) -> Tuple[List[List[int]], Body]:
        records = self.recv_header(peer, n_records)
        return records, self.body(self.irecv_body(peer, records))

    def exchange(self, dst: int, src: int, units, n_records: int):
        """Send one message to ``dst`` while receiving one from ``src`` (a
        ring hop): ``(records, body)`` received."""
        pending = self.isend(dst, units)
        got = self.recv(src, n_records)
        self.wait(pending)
        return got

    def all_to_all(self, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Block ``j`` of ``blocks`` (one a group rank, all of one shape
        and dtype) to group rank ``j``: the blocks every group rank sent
        this one, in group-rank order, on the codec's device (gloo's
        all-to-all over one host buffer, each block padded to ``ALIGN``)."""
        shape, dtype = tuple(blocks[0].shape), blocks[0].dtype
        host = self._to_host([(None, [b]) for b in blocks])
        out = self._host_buffer(host.numel())
        t0 = time.perf_counter()
        dist.all_to_all_single(out, host, group=self.group)
        self.stats.wire_s += time.perf_counter() - t0
        per = host.numel() // len(blocks)
        self.stats.sent_bytes += per * (len(blocks) - 1)
        self.stats.recv_bytes += per * (len(blocks) - 1)
        AB.collective("all-to-all", per * (len(blocks) - 1),
                      self.group.group_name)
        body = self._to_device(out)
        return [Body(body[j * per:(j + 1) * per]).raw(shape, dtype)
                for j in range(len(blocks))]

    def all_to_all_v(self, blocks: Sequence[torch.Tensor],
                     shapes: Sequence[Tuple[int, ...]]) -> List[torch.Tensor]:
        """Block ``j`` of ``blocks`` (one a group rank, one dtype, any
        shapes, empty ones too) to group rank ``j``; ``shapes[j]`` is the
        shape of the block group rank ``j`` sends this one.  The blocks
        every group rank sent this one, in group-rank order, on the codec's
        device (gloo's all-to-all with split sizes over one host buffer,
        unpadded).  The bytes a rank sends itself are not counted."""
        dtype = blocks[0].dtype
        size = torch.empty(0, dtype=dtype).element_size()
        me = dist.get_rank(self.group)
        sent = [b.numel() * size for b in blocks]
        got = [math.prod(s) * size for s in shapes]
        host = self._stage([byte_view(b) for b in blocks if b.numel()])
        out = self._host_buffer(sum(got))
        t0 = time.perf_counter()
        dist.all_to_all_single(out, host, output_split_sizes=got,
                               input_split_sizes=sent, group=self.group)
        self.stats.wire_s += time.perf_counter() - t0
        self.stats.sent_bytes += sum(sent) - sent[me]
        self.stats.recv_bytes += sum(got) - got[me]
        self.stats.messages += 1
        AB.collective("all-to-all", sum(sent) - sent[me], self.group.group_name)
        body = self._to_device(out)
        outs, off = [], 0
        for s, n in zip(shapes, got):
            outs.append(Body(body[off:off + n]).raw(tuple(s), dtype))
            off += n
        return outs

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every group rank's ``x`` (same shape and dtype everywhere), in
        group-rank order, on the codec's device."""
        host = self._to_host([(None, [x])])
        outs = [self._host_buffer(host.numel())
                for _ in range(dist.get_world_size(self.group))]
        t0 = time.perf_counter()
        dist.all_gather(outs, host, group=self.group)
        self.stats.wire_s += time.perf_counter() - t0
        self.stats.sent_bytes += host.numel()
        self.stats.recv_bytes += host.numel() * (len(outs) - 1)
        AB.collective("all-gather", host.numel(), self.group.group_name)
        return [Body(self._to_device(o)).raw(tuple(x.shape), x.dtype)
                for o in outs]


