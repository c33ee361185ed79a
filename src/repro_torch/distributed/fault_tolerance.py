"""Failure detection over a worker fleet (heartbeats and stragglers) and
checkpoint-restart training: the port of
``repro.distributed.fault_tolerance``.

The detector reads time through an injected ``clock`` (``time.monotonic``
by default); the serving scheduler passes its simulated clock, so deaths
surface with real heartbeat-timeout latency in simulated time.
:class:`ResilientTrainer` drives training steps through injected faults
(a crash restores the last checkpoint; a straggler's contribution is
dropped), saving through bare closures or a
:class:`~repro_torch.distributed.checkpoint.Checkpointer`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional


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


@dataclasses.dataclass
class RunReport:
    steps_completed: int
    restarts: int
    failures_seen: int
    stragglers_mitigated: int
    final_loss: Optional[float] = None
    # the Checkpointer's aggregated TransferStats, when one saved and
    # restored (re-reads, verify failures, wire bytes)
    transfer_stats: Optional[Any] = None


class ResilientTrainer:
    """Checkpoint-restart training loop.

    ``step_fn(state, step_idx) -> (state, metrics)`` runs one step;
    ``save_fn(step, state)`` and ``restore_fn() -> (state, step)`` are bare
    closures, or ``checkpointer=`` (a
    :class:`~repro_torch.distributed.checkpoint.Checkpointer`) binds both
    to the persistent executor: recovery then inherits verified delivery
    (Fletcher-32, the re-read budget, the previous-step fallback) and the
    :class:`RunReport` carries its accumulated ``TransferStats``.
    ``fault_source(step) -> Optional[str]`` injects ``'crash'`` or
    ``'straggler:<id>'`` events deterministically."""

    def __init__(self, step_fn, save_fn=None, restore_fn=None,
                 cfg: FaultConfig = FaultConfig(),
                 detector: Optional[FailureDetector] = None,
                 fault_source: Optional[Callable[[int], Optional[str]]] = None,
                 *, checkpointer=None):
        if checkpointer is not None and (save_fn or restore_fn):
            raise ValueError("pass save_fn/restore_fn or checkpointer=, "
                             "not both")
        if checkpointer is None and (save_fn is None or restore_fn is None):
            raise ValueError("need save_fn+restore_fn or checkpointer=")
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.checkpointer = checkpointer
        self.cfg = cfg
        self.detector = detector
        self.fault_source = fault_source or (lambda s: None)

    def _save(self, step: int, state) -> None:
        if self.checkpointer is not None:
            self.checkpointer.save(step, state)
        else:
            self.save_fn(step, state)

    def _restore(self, state_like, init_state):
        if self.checkpointer is None:
            return self.restore_fn()
        from repro_torch.distributed.checkpoint import CheckpointCorrupt
        try:
            tree, _extra, step = self.checkpointer.restore(state_like)
            return tree, step
        except (FileNotFoundError, CheckpointCorrupt):
            # crashed before the first checkpoint, or every candidate
            # exhausted its re-read budget (the stats carry the failures):
            # a cold restart is the only safe continuation
            return init_state, 0

    def run(self, state, total_steps: int) -> RunReport:
        restarts = failures = mitigated = 0
        step = 0
        loss = None
        init_state = state
        while step < total_steps:
            fault = self.fault_source(step)
            if fault == "crash":
                failures += 1
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise RuntimeError("restart budget exhausted")
                state, step = self._restore(state, init_state)
                continue
            if fault and fault.startswith("straggler"):
                # deadline-based mitigation: the straggler's microbatch is
                # dropped this step (the gradient is the survivors' mean)
                # rather than stalling the fleet
                mitigated += 1
            state, metrics = self.step_fn(state, step)
            loss = float(metrics.get("loss", float("nan"))) if metrics else None
            step += 1
            if step % self.cfg.checkpoint_every == 0 or step == total_steps:
                self._save(step, state)
        return RunReport(steps_completed=step, restarts=restarts,
                         failures_seen=failures, stragglers_mitigated=mitigated,
                         final_loss=loss,
                         transfer_stats=(self.checkpointer.stats
                                         if self.checkpointer is not None
                                         else None))
