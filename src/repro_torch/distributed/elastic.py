"""Elastic scaling: legal mesh enumeration and re-mesh planning after a
capacity change (node loss, scale-up), the port of
``repro.distributed.elastic``.

A (pod, data, model) mesh is legal for an arch and shape when the global
batch divides over the data-parallel replicas (``pod * data``); any model
split is legal (what does not divide is replicated), but meshes that keep
the FFN, the vocabulary and the heads sharded score higher.  The plans,
their scores and their order are the JAX package's.

Re-meshing is: pick the best legal mesh for the surviving chips, then ship
the state through the bulk-data plane (:func:`reshard`).  One deliberate
difference: :func:`reshard`'s device check counts the ranks of the
initialised ``torch.distributed`` group (1 without a group), where the JAX
package counts ``jax.device_count()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.codebook import DEFAULT_BF16_CODEBOOK, Codebook
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.plan import TransferConfig, TransferPlan, TransferStats


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    score: float

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def legal_meshes(n_chips: int, cfg: ArchConfig, shape: ShapeConfig,
                 multi_pod: bool = False, n_pods: int = 1) -> List[MeshPlan]:
    """Every (data, model) split of ``n_chips`` (a pod), best score first."""
    plans = []
    per_pod = n_chips // n_pods if multi_pod else n_chips
    for model in _divisors(per_pod):
        data = per_pod // model
        dp = data * (n_pods if multi_pod else 1)
        # every replica needs a non-empty, equal batch slice (this also
        # rejects dp > global_batch)
        if shape.global_batch % dp != 0:
            continue
        score = 0.0
        # prefer: FFN sharded, vocab sharded, heads sharded, batch not over-split
        if cfg.d_ff and cfg.d_ff % model == 0:
            score += 2.0
        if cfg.vocab_size % model == 0:
            score += 1.5
        if cfg.num_heads and cfg.num_heads % model == 0:
            score += 1.0
        # mild preference for more TP on big models (memory), more DP on small
        big = cfg.param_count() > 8e9
        score += 0.01 * (model if big else data)
        if multi_pod:
            plans.append(MeshPlan((n_pods, data, model),
                                  ("pod", "data", "model"), score))
        else:
            plans.append(MeshPlan((data, model), ("data", "model"), score))
    return sorted(plans, key=lambda p: -p.score)


def replan_after_failure(current: MeshPlan, surviving_chips: int,
                         cfg: ArchConfig, shape: ShapeConfig
                         ) -> Optional[MeshPlan]:
    """The best legal mesh at the surviving capacity (None if none is)."""
    multi = "pod" in current.axes
    n_pods = current.shape[0] if multi else 1
    if multi and surviving_chips < n_pods:
        multi, n_pods = False, 1
    usable = surviving_chips
    while usable > 0:
        plans = legal_meshes(usable, cfg, shape, multi_pod=multi, n_pods=n_pods)
        if plans:
            return plans[0]
        usable -= 1
    return None


def visible_devices() -> int:
    """The ranks a new mesh can span: the initialised group's world size,
    or 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def reshard(state, old_mesh_plan: Optional[MeshPlan],
            new_mesh_plan: MeshPlan, *, device: DeviceLike = None,
            codebook: Codebook = DEFAULT_BF16_CODEBOOK,
            compress_fp32: bool = True, faults=None, verify: bool = False,
            placement=None) -> Tuple[Any, TransferStats]:
    """Ship ``state`` onto ``new_mesh_plan``'s configuration through the
    bulk-data plane: one :class:`TransferPlan` over the state tree, the
    ``wire`` backend's SZ02 streams through the session's reshard hop
    (bit-exact; f32 rides the hi/lo split), the result placed on
    ``device`` (default: the card), replicated.  The old mesh may already
    be gone, so the hop touches none of its collectives.  ``faults=`` and
    ``verify=`` thread into the session, so recovery drills run the
    re-fetch path.  With ``placement`` (the new mesh's
    :class:`~repro_torch.distributed.sharding.Placement`, e.g.
    ``training/train_step.py:placement``) ``state`` is the whole state and
    the result this rank's shards under its policy.  Returns ``(state,
    TransferStats)``."""
    n = visible_devices()
    if new_mesh_plan.n_devices > n:
        raise ValueError(
            f"new mesh {new_mesh_plan.shape} needs {new_mesh_plan.n_devices} "
            f"devices; only {n} visible")
    device = resolve_device(device)
    tc = TransferConfig(codebook=codebook, backend="wire",
                        compress_fp32=compress_fp32)
    sess = TransferPlan.build(state, tc).session(faults=faults, verify=verify,
                                                 device=device)
    out = sess.reshard(state, device)
    if placement is not None:
        out = placement.shard(out)
    return out, sess.last_stats


@dataclasses.dataclass
class ElasticEvent:
    step: int
    kind: str                 # 'shrink' | 'grow'
    chips_delta: int


def simulate_elastic_run(events: List[ElasticEvent], start_chips: int,
                         cfg: ArchConfig, shape: ShapeConfig) -> List[MeshPlan]:
    """Drive re-planning through a schedule of capacity changes; returns
    the mesh history."""
    chips = start_chips
    plan = legal_meshes(chips, cfg, shape)[0]
    history = [plan]
    for ev in sorted(events, key=lambda e: e.step):
        chips = max(1, chips + ev.chips_delta)
        nxt = replan_after_failure(plan, chips, cfg, shape)
        if nxt is None:
            raise RuntimeError(f"no legal mesh at {chips} chips")
        plan = nxt
        history.append(plan)
    return history
