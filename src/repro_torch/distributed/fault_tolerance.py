"""Failure detection over a worker fleet: heartbeats and stragglers.

The port of the detector half of ``repro.distributed.fault_tolerance``:
:class:`WorkerHealth`, :class:`FaultConfig` and :class:`FailureDetector`.
The detector reads time through an injected ``clock`` (``time.monotonic``
by default); the serving scheduler passes its simulated clock, so deaths
surface with real heartbeat-timeout latency in simulated time.

``RunReport`` and ``ResilientTrainer`` (checkpoint-restart training) belong
to the training plane and are not ported with the serving control plane.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class WorkerHealth:
    worker_id: int
    last_heartbeat: float
    step_times: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    heartbeat_timeout_s: float = 60.0
    straggler_factor: float = 2.0      # step_time > factor * median => straggler
    straggler_window: int = 8
    max_restarts: int = 16
    checkpoint_every: int = 50


class FailureDetector:
    """Heartbeat + straggler detection over a worker fleet."""

    def __init__(self, n_workers: int, cfg: FaultConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.workers = {i: WorkerHealth(i, clock()) for i in range(n_workers)}

    def heartbeat(self, worker_id: int, step_time: Optional[float] = None):
        """Record a heartbeat (and optionally a step time).  A heartbeat
        revives a worker previously declared dead."""
        w = self.workers[worker_id]
        w.last_heartbeat = self.clock()
        w.alive = True
        if step_time is not None:
            w.step_times.append(step_time)
            if len(w.step_times) > self.cfg.straggler_window:
                w.step_times.pop(0)

    def timed_out(self) -> List[int]:
        """Alive workers whose heartbeat has lapsed; changes no state."""
        now = self.clock()
        return [w.worker_id for w in self.workers.values()
                if w.alive
                and now - w.last_heartbeat > self.cfg.heartbeat_timeout_s]

    def newly_dead(self) -> List[int]:
        """Mark every timed-out worker dead and return them: each death is
        reported once (until a heartbeat revives the worker)."""
        out = self.timed_out()
        for wid in out:
            self.workers[wid].alive = False
        return out

    def dead_workers(self) -> List[int]:
        """Every currently dead worker, lapsed heartbeats swept in first."""
        self.newly_dead()
        return sorted(w.worker_id for w in self.workers.values()
                      if not w.alive)

    def stragglers(self) -> List[int]:
        """Alive workers whose mean of their last three step times exceeds
        ``straggler_factor`` times the fleet's median mean step time."""
        med = self._median_step_time()
        if med is None:
            return []
        out = []
        for w in self.workers.values():
            if not w.alive or not w.step_times:
                continue
            recent = sum(w.step_times[-3:]) / min(3, len(w.step_times))
            if recent > self.cfg.straggler_factor * med:
                out.append(w.worker_id)
        return out

    def _median_step_time(self) -> Optional[float]:
        all_means = [sum(w.step_times) / len(w.step_times)
                     for w in self.workers.values() if w.alive and w.step_times]
        if not all_means:
            return None
        s = sorted(all_means)
        return s[len(s) // 2]

    def alive_count(self) -> int:
        return sum(1 for w in self.workers.values() if w.alive)
