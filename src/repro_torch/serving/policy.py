"""Pluggable link/admission policies for the disaggregated scheduler.

The port of ``repro.serving.policy``.  The scheduler treats the PD link as a
resource with one dispatch point: when a link goes idle, ONE queued request
is picked and occupies it for exactly one interval.  A policy answers two
questions there:

1. **Link ordering** (:meth:`LinkPolicy.link_key`): the scheduler calls
   ``link_key(req, est_transfer_s, cfg)`` for every queued request and
   dispatches the minimum.  Keys end with ``req.rid`` so ties break the same
   way under any submission order.
2. **Speculative admission** (:attr:`LinkPolicy.speculative`): may the
   request holding the link pre-claim a decode slot while its transfer is
   in flight?  Its first token still waits for ``transfer_done``, and
   requests already waiting for admission are served first.

Built-in policies:

``fifo``
    FIFO by prefill completion.
``sjf``
    Shortest-transfer-first on the plan-estimated transfer duration.
``edf``
    Earliest-deadline-first on ``Request.deadline`` (else ``arrival +
    cfg.slo_s``, else FIFO order).
``edf-shed``
    EDF plus shedding of queued requests that provably cannot meet their
    deadline (terminal state ``'shed'``).
``spec``
    FIFO link ordering plus speculative decode admission.

Out-of-tree policies register with :func:`register_policy`; the scheduler
resolves names through :func:`get_policy`.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Callable, Dict, Tuple

if TYPE_CHECKING:  # only for annotations: the scheduler imports this module
    from repro_torch.serving.scheduler import Request, SchedulerConfig


class LinkPolicy:
    """Abstract link/admission policy.  Subclasses set ``name`` and override
    :meth:`link_key`; ``speculative = True`` enables speculative decode
    admission, ``sheds = True`` deadline shedding."""

    name: str = "abstract"
    #: May the in-flight transfer pre-claim a free decode slot?
    speculative: bool = False
    #: Shed queued requests that provably cannot meet their deadline?
    #: ``SchedulerConfig.shed_infeasible`` overrides this either way.
    sheds: bool = False

    def link_key(self, req: "Request", est_transfer_s: float,
                 cfg: "SchedulerConfig") -> Tuple:
        """Sort key for the idle-link dispatch (the minimum gets the link).
        ``est_transfer_s`` is the plan-estimated transfer duration the link
        will be charged.  Keys must end with ``req.rid``."""
        raise NotImplementedError

    def deadline_of(self, req: "Request", cfg: "SchedulerConfig") -> float:
        """The effective deadline: the request's own, else ``arrival +
        cfg.slo_s``, else +inf."""
        if req.deadline != math.inf:
            return req.deadline
        if cfg.slo_s is not None:
            return req.arrival + cfg.slo_s
        return math.inf


class FifoPolicy(LinkPolicy):
    """FIFO by prefill completion."""

    name = "fifo"

    def link_key(self, req, est_transfer_s, cfg):
        return (req.prefill_done, req.rid)


class ShortestTransferFirstPolicy(LinkPolicy):
    """The queued request with the smallest plan-estimated transfer goes
    next (non-preemptive)."""

    name = "sjf"

    def link_key(self, req, est_transfer_s, cfg):
        return (est_transfer_s, req.prefill_done, req.rid)


class EarliestDeadlinePolicy(LinkPolicy):
    """Order the link by effective deadline; deadline ties (no deadline
    anywhere included) fall back to FIFO order."""

    name = "edf"

    def link_key(self, req, est_transfer_s, cfg):
        return (self.deadline_of(req, cfg), req.prefill_done, req.rid)


class SheddingEDFPolicy(EarliestDeadlinePolicy):
    """EDF plus shedding: a queued request that would land past its deadline
    even if dispatched now (transfer, then one decode step) is dropped."""

    name = "edf-shed"
    sheds = True


class SpeculativeAdmissionPolicy(FifoPolicy):
    """FIFO link ordering plus speculative decode admission."""

    name = "spec"
    speculative = True


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], LinkPolicy]] = {}
_INSTANCES: Dict[str, LinkPolicy] = {}


def register_policy(name: str, factory: Callable[[], LinkPolicy]) -> None:
    """Register a link/admission policy under ``name`` (later wins)."""
    _REGISTRY[name] = factory
    _INSTANCES.pop(name, None)


def get_policy(name: str) -> LinkPolicy:
    """Resolve a policy name to its (cached) instance."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown link policy {name!r}; available: {available_policies()}")
    if name not in _INSTANCES:
        _INSTANCES[name] = _REGISTRY[name]()
    return _INSTANCES[name]


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_policy("fifo", FifoPolicy)
register_policy("sjf", ShortestTransferFirstPolicy)
register_policy("edf", EarliestDeadlinePolicy)
register_policy("edf-shed", SheddingEDFPolicy)
register_policy("spec", SpeculativeAdmissionPolicy)
