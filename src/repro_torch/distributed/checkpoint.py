"""Checkpoint save/restore: a thin wrapper over the persistent executor (the
port of ``repro.distributed.checkpoint``).

Layout: one directory per step, one ``.szc`` SZ02 file per leaf plus the
plan-derived JSON manifest, written by
:meth:`~repro_torch.serving.session.TransferSession.save` (normative format
in ``docs/wire_format.md`` §9; byte for byte the JAX package's).  This module
adds only the step-directory convention and the fallback policy: integrity
failures (:class:`~repro_torch.core.wire.WireIntegrityError` after the
plan's re-read budget), truncated directories and structure drift fall back
to the previous checkpoint.  Atomicity, Fletcher-32 verification, fault
injection and :class:`~repro_torch.serving.plan.TransferStats` accounting
all come from the session: there is no codec, wire or hash code here
(``tests/test_torch_persist.py`` greps for it).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

from repro_torch.core import tree as TR
from repro_torch.core.codebook import Codebook
from repro_torch.core.wire import WireIntegrityError
from repro_torch.serving.plan import TransferConfig, TransferPlan, TransferStats
from repro_torch.serving.session import (PERSIST_MANIFEST,
                                         TransferIntegrityError,
                                         TransferSession)

# checkpoint codebook: weights and bf16 optimizer state share the
# activations' exponent concentration
CKPT_CODEBOOK = Codebook(fmt="bf16", exponents=tuple(range(113, 129)))

MANIFEST = PERSIST_MANIFEST


class CheckpointCorrupt(RuntimeError):
    pass


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


class Checkpointer:
    """Session-backed checkpoint manager.

    One :class:`TransferPlan` per state structure (cached across calls: the
    plan is a property of the model, not of the step), run by the
    persistent executor.  ``faults=`` threads into the session, so recovery
    drills run the re-read machinery production would.  ``device`` is where
    ``restore`` puts the leaves (default: the card).  ``stats`` aggregates
    the :class:`TransferStats` of every save and restore this manager ran
    (re-reads of abandoned candidate steps included).

    With ``placement`` (a :class:`~repro_torch.distributed.sharding.
    Placement`, e.g. ``training/train_step.py:placement``) the trees are
    this rank's shards: ``save`` gathers the whole tree on every rank
    (each holds it briefly) and rank 0 writes it, so the directory is the
    unsharded one (the
    unsharded trainer and the JAX ``Checkpointer`` load it); ``restore``
    loads the whole tree (``placement.like`` is the template) and returns
    this rank's shards."""

    def __init__(self, directory: str, *, codebook: Codebook = CKPT_CODEBOOK,
                 compress_fp32: bool = True, faults=None, device=None,
                 placement=None):
        self.directory = directory
        self.placement = placement
        self.tc = TransferConfig(codebook=codebook, backend="wire",
                                 compress_fp32=compress_fp32)
        self.faults = faults
        self.device = device
        self._sessions: Dict[Any, TransferSession] = {}
        self.stats = TransferStats(chunk_wire_bytes=[], chunk_ok=[],
                                   raw_passthrough_bytes=0.0, n_elements=0)

    def _session(self, tree) -> TransferSession:
        flat, treedef = TR.flatten_with_path(tree)
        key = (treedef, tuple((tuple(x.shape), str(x.dtype)) for _, x in flat))
        sess = self._sessions.get(key)
        if sess is None:
            plan = TransferPlan.build(tree, self.tc)
            sess = plan.session(faults=self.faults, device=self.device)
            self._sessions[key] = sess
        return sess

    def _merge(self, s: Optional[TransferStats]) -> None:
        if s is None:
            return
        agg = self.stats
        agg.raw_passthrough_bytes += s.raw_passthrough_bytes
        agg.fp32_lo_wire_bytes += s.fp32_lo_wire_bytes
        agg.fp8_wire_bytes += s.fp8_wire_bytes
        agg.verify_failures += s.verify_failures
        agg.refetches += s.refetches
        agg.raw_refetches += s.raw_refetches
        agg.refetch_wire_bytes += s.refetch_wire_bytes
        agg.faults_injected += s.faults_injected
        agg.fault_delay_s += s.fault_delay_s
        agg.n_elements = s.n_elements
        agg.leaf_wire_bytes.update(s.leaf_wire_bytes)
        agg.leaf_ok.update(s.leaf_ok)

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> str:
        """Atomically write the checkpoint of ``step``; returns its path.
        Under a placement every rank calls it: the state is gathered, rank
        0 writes it, and every rank returns once that write is complete,
        or raises at once if it failed."""
        path = _step_dir(self.directory, step)
        if self.placement is None:
            return self._write(path, tree, extra)
        tree = self.placement.gather(tree)
        failed, error = [None], None
        if dist.get_rank() == 0:
            try:
                self._write(path, tree, extra)
            except Exception as e:      # every rank hears of it, then raises
                failed, error = [f"{type(e).__name__}: {e}"], e
        del tree
        dist.broadcast_object_list(failed, src=0)
        if error is not None:
            raise error
        if failed[0] is not None:
            raise RuntimeError(f"checkpoint of step {step}: rank 0's write "
                               f"failed: {failed[0]}")
        return path

    def _write(self, path: str, tree, extra: Optional[Dict]) -> str:
        sess = self._session(tree)
        path = sess.save(path, tree, extra=extra or {})
        self._merge(sess.last_stats)
        return path

    def restore(self, tree_like, step: Optional[int] = None
                ) -> Tuple[Any, Dict, int]:
        """Load ``step`` (default: the latest) bit for bit; on corruption
        (integrity failure past the session's re-read budget, missing
        files, structure drift) fall back to the previous checkpoint.
        Returns ``(tree, extra, step_loaded)``; under a placement the tree
        is this rank's shards, and ``tree_like`` is not read."""
        steps = steps_available(self.directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        if self.placement is not None:
            tree_like = self.placement.like
        sess = self._session(tree_like)
        candidates = [s for s in steps if step is None or s == step]
        for s in reversed(candidates):
            try:
                tree, extra = sess.load(_step_dir(self.directory, s))
                self._merge(sess.last_stats)
                if self.placement is not None:
                    tree = self.placement.shard(tree)
                return tree, extra, s
            except (WireIntegrityError, TransferIntegrityError, OSError,
                    KeyError, ValueError):
                self._merge(sess.last_stats)
                continue
        raise CheckpointCorrupt(
            f"all candidate checkpoints corrupt in {self.directory}")


# -- module-level convenience API (one-shot managers) ------------------------

def save(directory: str, step: int, tree, extra: Optional[Dict] = None,
         codebook: Codebook = CKPT_CODEBOOK) -> str:
    """Atomically write the checkpoint of ``step``; returns its path."""
    return Checkpointer(directory, codebook=codebook).save(step, tree, extra)


def restore(directory: str, tree_like, step: Optional[int] = None,
            device=None) -> Tuple[Any, Dict, int]:
    """Load ``step`` (default: the latest) onto ``device``; on corruption,
    fall back to the previous checkpoint.  Returns (tree, extra,
    step_loaded)."""
    return Checkpointer(directory, device=device).restore(tree_like, step)


def steps_available(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_"))


def latest_step(directory: str) -> Optional[int]:
    steps = steps_available(directory)
    return steps[-1] if steps else None


def checkpoint_bytes(directory: str, step: int) -> int:
    path = _step_dir(directory, step)
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
