"""Fleet topology for the disaggregated scheduler.

The port of ``repro.serving.cluster``:

* :class:`LinkSpec` — one trunk path between the prefill and decode tiers:
  its link policy (:mod:`repro_torch.serving.policy` key) and a bandwidth
  scale applied to the scheduler's one :class:`CodecProfile`.
* :class:`ClusterConfig` — N prefill x M decode workers over the links,
  the router key (:mod:`repro_torch.serving.router`) and the per-decode-
  worker prefix-cache budget that turns on prefix-aware delta transfer.
* :func:`resolve_cluster` — a ``SchedulerConfig`` to its cluster.  It is
  the only reader of the legacy ``n_decode_workers`` field.
* :class:`PrefixDirectory` — the scheduler's per-decode-worker LRU of
  resident session prefixes, in tokens (the execution side's byte-exact
  index is :class:`repro_torch.serving.session.PrefixIndex`).

A ``SchedulerConfig`` without a ``cluster`` resolves to the degenerate
topology (1 prefill x 1 link x ``n_decode_workers`` decode workers, router
``'legacy'``), which reproduces the single-pipe scheduler exactly.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One prefill->decode trunk path: its link policy and the factor on
    the scheduler profile's ``link_bw`` for transfers on it (1.0 reuses the
    profile object itself)."""

    policy: str = "fifo"
    bw_scale: float = 1.0

    def __post_init__(self):
        if not (self.bw_scale > 0.0):
            raise ValueError("LinkSpec.bw_scale must be > 0")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """N prefill workers x M decode workers over heterogeneous links.

    ``router`` names the placement policy that gives each prefilled request
    a (link, decode-worker) pair; ``prefix_cache_bytes`` is each decode
    worker's budget for resident session prefixes (None: no delta)."""

    n_prefill: int = 1
    n_decode: int = 1
    links: Tuple[LinkSpec, ...] = (LinkSpec(),)
    router: str = "transfer-aware"
    prefix_cache_bytes: Optional[float] = None

    def __post_init__(self):
        if self.n_prefill < 1 or self.n_decode < 1:
            raise ValueError("a cluster needs at least one prefill and one "
                             "decode worker")
        if not self.links:
            raise ValueError("a cluster needs at least one link")

    @property
    def n_links(self) -> int:
        return len(self.links)


def resolve_cluster(cfg) -> ClusterConfig:
    """``SchedulerConfig`` -> its :class:`ClusterConfig`: the explicit
    ``cfg.cluster``, else 1 prefill worker, 1 link running ``cfg.policy``,
    ``cfg.n_decode_workers`` decode workers and the ``'legacy'`` router."""
    cluster = getattr(cfg, "cluster", None)
    if cluster is not None:
        return cluster
    return ClusterConfig(
        n_prefill=1,
        n_decode=max(1, cfg.n_decode_workers),
        links=(LinkSpec(policy=cfg.policy),),
        router="legacy",
        prefix_cache_bytes=None)


class PrefixDirectory:
    """Scheduler-side model of each decode worker's resident prefix cache:
    ``(worker, session) -> resident tokens`` with per-worker LRU eviction
    under ``capacity_bytes`` (None: unbounded).  A worker's death drops its
    whole directory.  Eviction follows insertion/touch order only."""

    def __init__(self, n_workers: int, capacity_bytes: Optional[float] = None):
        self.capacity_bytes = capacity_bytes
        self._per_worker: Dict[int, "OrderedDict[int, Tuple[int, float]]"] = {
            w: OrderedDict() for w in range(n_workers)}
        self.evictions = 0

    def hit_tokens(self, worker: int, session: int) -> int:
        """Resident tokens for ``session`` on ``worker`` (0: cold).  A pure
        lookup: placement probes must not reorder eviction."""
        d = self._per_worker.get(worker)
        if d is None or session not in d:
            return 0
        return d[session][0]

    def insert(self, worker: int, session: int, tokens: int,
               bytes_per_token: float) -> None:
        """Record ``session``'s resident prefix on ``worker`` (touches the
        LRU), then evict least-recently-used sessions past the budget; a
        single prefix larger than the whole budget is dropped too."""
        d = self._per_worker.get(worker)
        if d is None:
            return
        d[session] = (int(tokens), float(tokens) * bytes_per_token)
        d.move_to_end(session)
        if self.capacity_bytes is None:
            return
        total = sum(b for _, b in d.values())
        while total > self.capacity_bytes and len(d) > 1:
            _, (_, freed) = d.popitem(last=False)
            self.evictions += 1
            total -= freed
        if total > self.capacity_bytes and d:
            d.popitem(last=False)
            self.evictions += 1

    def drop_worker(self, worker: int) -> None:
        d = self._per_worker.get(worker)
        if d is not None:
            d.clear()

    def resident_bytes(self, worker: int) -> float:
        d = self._per_worker.get(worker)
        return sum(b for _, b in d.values()) if d else 0.0
