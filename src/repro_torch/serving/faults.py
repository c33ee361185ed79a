"""Seeded, injectable fault plans for the transfer data plane.

The port of ``repro.serving.faults``.  A :class:`FaultPlan` describes WHAT
goes wrong:

* **chunk faults** on the wire hop — ``corrupt`` (one bit flipped in the
  shipped payload), ``drop`` (payload lost), ``delay`` (payload late) — both
  as seeded rates (``corrupt_p``/``drop_p``/``delay_p``) and as explicit
  per-chunk injections (``corrupt_chunks=(2,)`` corrupts chunk 2 of every
  transfer's first attempt);
* **worker kills** and **link brownouts**, the scheduler plane's faults
  (descriptors only here: the scheduler is not ported yet).

Randomized faults are drawn from a counter-based hash of ``(seed, uid,
chunk, attempt)`` — not from stateful RNG — so a seeded plan is a pure
function: the same transfer sees the same faults in any execution order,
retries re-roll (attempt is part of the key), and the draws equal the JAX
package's for the same plan.

:class:`FaultChannel` frames each wire object with its Fletcher-32 tag at
ship time, applies the plan's chunk faults, and verifies frames at
delivery; :class:`~repro_torch.serving.session.TransferSession` threads its
wire hop through it.  A corruption writes one element on the object's
device, into a copy, so corrupted streams equal the JAX package's bit for
bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.core import codec as C
from repro_torch.core.backend import WireCompressed

# ---------------------------------------------------------------------------
# deterministic per-(seed, uid, chunk, attempt) randomness
# ---------------------------------------------------------------------------

_SPLITMIX_GAMMA = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One splitmix64 scramble round — the counter-based hash behind every
    randomized fault draw (stateless, so fault plans are pure functions)."""
    x = (x + _SPLITMIX_GAMMA) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & _MASK64


def _unit_draw(seed: int, uid: int, chunk: int, attempt: int, salt: int) -> float:
    """Uniform [0, 1) draw keyed by the full fault coordinate."""
    h = seed & _MASK64
    for part in (uid, chunk, attempt, salt):
        h = _splitmix64(h ^ (part & _MASK64))
    return h / float(1 << 64)


# ---------------------------------------------------------------------------
# fault descriptors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkerKill:
    """Worker ``worker`` of tier ``role`` ('decode' or 'prefill') stops
    heartbeating at ``at`` (sim seconds); ``revive_at`` restores it
    (None == permanent death)."""

    worker: int
    at: float
    revive_at: Optional[float] = None
    role: str = "decode"

    def __post_init__(self):
        if self.role not in ("decode", "prefill"):
            raise ValueError("WorkerKill.role must be 'decode' or 'prefill'")


@dataclasses.dataclass(frozen=True)
class LinkBrownout:
    """A PD link delivers at ``factor`` (0 < factor <= 1) of its nominal
    bandwidth over ``[start, stop)``.  ``link`` selects one link of a
    multi-link fleet; None degrades every link."""

    start: float
    stop: float
    factor: float = 0.5
    link: Optional[int] = None

    def __post_init__(self):
        if not (0.0 < self.factor <= 1.0):
            raise ValueError("brownout factor must be in (0, 1]")
        if self.stop <= self.start:
            raise ValueError("brownout interval must be non-empty")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, declarative description of what goes wrong.

    Chunk-fault resolution order for transfer ``uid``, chunk ``i``, attempt
    ``a``: explicit injections first (``corrupt_chunks``/``drop_chunks``/
    ``delay_chunks`` — attempts below ``persistent_attempts``, so by
    default a single re-fetch clears them), then the seeded rates
    (re-rolled per attempt).  ``max_attempt`` caps randomized faults so an
    adversarial rate cannot starve the terminal raw re-fetch forever."""

    seed: int = 0
    corrupt_p: float = 0.0
    drop_p: float = 0.0
    delay_p: float = 0.0
    delay_s: float = 0.0                 # injected latency per delayed chunk
    corrupt_chunks: Tuple[int, ...] = ()
    drop_chunks: Tuple[int, ...] = ()
    delay_chunks: Tuple[int, ...] = ()
    persistent_attempts: int = 1
    max_attempt: int = 8
    worker_kills: Tuple[WorkerKill, ...] = ()
    brownouts: Tuple[LinkBrownout, ...] = ()

    # -- chunk faults --------------------------------------------------------
    def chunk_fault(self, uid: int, chunk: int, attempt: int) -> Optional[str]:
        """'corrupt' | 'drop' | 'delay' | None for this fault coordinate."""
        if attempt < self.persistent_attempts:
            if chunk in self.corrupt_chunks:
                return "corrupt"
            if chunk in self.drop_chunks:
                return "drop"
            if chunk in self.delay_chunks:
                return "delay"
        if attempt >= self.max_attempt:
            return None
        if (self.corrupt_p > 0.0
                and _unit_draw(self.seed, uid, chunk, attempt, 1) < self.corrupt_p):
            return "corrupt"
        if (self.drop_p > 0.0
                and _unit_draw(self.seed, uid, chunk, attempt, 2) < self.drop_p):
            return "drop"
        if (self.delay_p > 0.0
                and _unit_draw(self.seed, uid, chunk, attempt, 3) < self.delay_p):
            return "delay"
        return None

    # -- link faults ---------------------------------------------------------
    def link_rate(self, t: float, link: int = 0) -> float:
        """Fractional bandwidth of ``link`` at sim time ``t`` (1.0 ==
        nominal); overlapping applicable brownouts compound."""
        rate = 1.0
        for b in self.brownouts:
            if b.link is not None and b.link != link:
                continue
            if b.start <= t < b.stop:
                rate *= b.factor
        return rate

    def link_wall_clock(self, start: float, busy_s: float,
                        link: int = 0) -> float:
        """Wall-clock completion time of a transfer needing ``busy_s``
        seconds of NOMINAL link time when dispatched at ``start`` on
        ``link``: the brownout-degraded rate integrated piecewise."""
        if busy_s <= 0.0:
            return start
        edges = sorted({e for b in self.brownouts
                        if b.link is None or b.link == link
                        for e in (b.start, b.stop) if e > start})
        t, left = start, busy_s
        for edge in edges:
            rate = self.link_rate(t, link)
            span = edge - t
            if left <= span * rate:
                return t + left / rate
            left -= span * rate
            t = edge
        return t + left / self.link_rate(t, link)

    def describe(self) -> str:
        parts = []
        if self.corrupt_p or self.corrupt_chunks:
            parts.append(f"corrupt(p={self.corrupt_p}, "
                         f"chunks={self.corrupt_chunks})")
        if self.drop_p or self.drop_chunks:
            parts.append(f"drop(p={self.drop_p}, chunks={self.drop_chunks})")
        if self.delay_p or self.delay_chunks:
            parts.append(f"delay(p={self.delay_p}, +{self.delay_s}s)")
        parts.extend(f"kill({k.role[0]}{k.worker}@{k.at}"
                     + (f", revive@{k.revive_at})" if k.revive_at is not None
                        else ")") for k in self.worker_kills)
        parts.extend(f"brownout("
                     + (f"link{b.link}, " if b.link is not None else "")
                     + f"[{b.start},{b.stop}) x{b.factor})"
                     for b in self.brownouts)
        return f"FaultPlan[seed={self.seed}: " + (", ".join(parts) or "none") + "]"


# ---------------------------------------------------------------------------
# the checksum-framed wire hop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Frame:
    """One wire object in flight: the (possibly fault-mutated) payload plus
    the Fletcher-32 tag the SENDER computed over the pristine payload.
    ``payload is None`` == dropped in flight."""

    payload: object
    tag: int
    delay_s: float = 0.0


_STREAM_FIELDS = ("sign_mantissa", "packed", "esc_pos", "esc_val",
                  "esc_count", "ok")


def _flip(t: torch.Tensor, salt: int) -> torch.Tensor:
    """A copy of ``t`` with one bit of its byte view flipped (one element
    written, on ``t``'s device)."""
    out = C.signed_view(t).clone()
    flat = out.reshape(-1).view(torch.uint8)
    pos = _splitmix64(salt + 1) % flat.numel()
    flat[pos:pos + 1] ^= 1 << (_splitmix64(salt + 2) % 8)
    return C.unsigned_view(out)


def _corrupt_payload(payload, salt: int):
    """Flip one bit in the payload's LARGEST stream (or in the payload bytes
    of a wire object) — the smallest corruption a checksum must catch.  The
    largest, because compressed objects carry capacity-padded escape arrays
    whose dead tail would absorb the flip without observable effect."""
    if isinstance(payload, WireCompressed):
        buf = bytearray(payload.payload)
        pos = _splitmix64(salt) % max(1, len(buf))
        buf[pos] ^= 1 << (_splitmix64(salt + 1) % 8)
        return dataclasses.replace(payload, payload=bytes(buf))
    if isinstance(payload, torch.Tensor):
        return _flip(payload, salt) if payload.numel() else payload
    leaves = payload.tensors()
    sized = [i for i, t in enumerate(leaves) if t.numel() > 0]
    if not sized:
        return payload
    i = max(sized, key=lambda j: leaves[j].numel() * leaves[j].element_size())
    return dataclasses.replace(payload,
                               **{_STREAM_FIELDS[i]: _flip(leaves[i], salt)})


class FaultChannel:
    """The wire between prefill and decode: frames wire objects with a
    checksum, applies a :class:`FaultPlan`'s chunk faults in flight, and
    verifies frames on delivery.

    With ``plan=None`` the channel is transparent (checksum framing only),
    so the verify path runs without any injected fault."""

    def __init__(self, checksum: Callable[[object], int],
                 plan: Optional[FaultPlan] = None):
        self.checksum = checksum
        self.plan = plan
        self.injected = 0            # faults applied on this channel
        self.injected_delay_s = 0.0

    def ship(self, payload, uid: int, chunk: int, attempt: int) -> Frame:
        """Sender side: tag the pristine payload, then let the plan mutate
        it in flight."""
        tag = self.checksum(payload)
        delay = 0.0
        if self.plan is not None:
            fault = self.plan.chunk_fault(uid, chunk, attempt)
            if fault == "corrupt":
                salt = (self.plan.seed << 8) ^ _splitmix64(
                    (uid << 20) ^ (chunk << 8) ^ attempt)
                payload = _corrupt_payload(payload, salt)
                self.injected += 1
            elif fault == "drop":
                payload = None
                self.injected += 1
            elif fault == "delay":
                delay = self.plan.delay_s
                self.injected += 1
                self.injected_delay_s += delay
        return Frame(payload=payload, tag=tag, delay_s=delay)

    def deliver(self, frame: Frame) -> Tuple[object, bool]:
        """Receiver side: ``(payload, intact)``.  A dropped frame or a tag
        mismatch is not an error here — the session routes it through the
        retry machinery; this only refuses to hand garbage up unlabeled."""
        if frame.payload is None:
            return None, False
        return frame.payload, self.checksum(frame.payload) == frame.tag


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], FaultPlan]] = {}


def register_fault_plan(name: str, factory: Callable[[], FaultPlan]) -> None:
    """Register a named fault plan (later wins)."""
    _REGISTRY[name] = factory


def get_fault_plan(name: str) -> FaultPlan:
    if name not in _REGISTRY:
        raise KeyError(f"unknown fault plan {name!r}; "
                       f"available: {available_fault_plans()}")
    return _REGISTRY[name]()


def available_fault_plans() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_faults(faults: Union[None, str, FaultPlan]) -> Optional[FaultPlan]:
    """``None | registry name | FaultPlan`` -> the plan (None == fault-free)."""
    if faults is None or isinstance(faults, FaultPlan):
        return faults
    return get_fault_plan(faults)


# the acceptance scenario of the JAX package: 1% of chunks corrupted, one
# decode worker killed mid-run, the link browned out over an interval
register_fault_plan("chaos", lambda: FaultPlan(
    seed=7, corrupt_p=0.01,
    worker_kills=(WorkerKill(worker=1, at=0.35),),
    brownouts=(LinkBrownout(start=0.2, stop=0.6, factor=0.5),)))
# wire-integrity stress: heavy corruption + drops, every failure recoverable
register_fault_plan("lossy-wire", lambda: FaultPlan(
    seed=11, corrupt_p=0.2, drop_p=0.05))
