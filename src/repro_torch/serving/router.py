"""Router registry: place prefilled requests on (link, decode-worker) pairs.

The port of ``repro.serving.router``.  Routers are stateless singletons
behind ``register_router`` / ``get_router`` / ``available_routers``.
:meth:`Router.place` takes a request and a read-only view of the scheduler
and returns ``(link_id, decode_id)``; ``decode_id == -1`` defers the worker
to admission time (least-loaded alive), which is what ``legacy`` does.

The view (the scheduler itself) offers ``cluster``, ``cfg``,
``est_transfer_s(req, link, worker)``, ``link_backlog_s(link)``,
``decode_load(worker)``, ``decode_alive(worker)`` and ``rr_next(kind)``
(round-robin counters live on the scheduler, so equal runs stay equal).
Routers must be deterministic functions of the view.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple


class Router:
    """Base placement policy; subclasses override :meth:`place`."""

    name = "base"

    def place(self, req, view) -> Tuple[int, int]:
        raise NotImplementedError

    def _alive_decodes(self, view) -> List[int]:
        alive = [w for w in range(view.cluster.n_decode)
                 if view.decode_alive(w)]
        # with every worker detected dead the request still needs a place;
        # revival or failover sorts it out later
        return alive or list(range(view.cluster.n_decode))


_REGISTRY: Dict[str, Callable[[], Router]] = {}
_INSTANCES: Dict[str, Router] = {}


def register_router(name: str, factory: Callable[[], Router]) -> None:
    _REGISTRY[name] = factory
    _INSTANCES.pop(name, None)


def get_router(name: str) -> Router:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown router {name!r}; available: {sorted(_REGISTRY)}")
    if name not in _INSTANCES:
        _INSTANCES[name] = _REGISTRY[name]()
    return _INSTANCES[name]


def available_routers() -> List[str]:
    return sorted(_REGISTRY)


class LegacyRouter(Router):
    """Everything on link 0; the decode worker is chosen at admission time
    (least-loaded alive).  Computes nothing."""

    name = "legacy"

    def place(self, req, view) -> Tuple[int, int]:
        return 0, -1


class TransferAwareRouter(Router):
    """Minimize, over every (link, decode) pair,

        est_transfer_s(req, link, worker) + link_backlog_s(link)
            + decode_load(worker) * decode_time_per_step

    ``est_transfer_s`` is prefix-delta aware, so a warm session is pulled
    back to the worker holding its prefix.  Ties break on (cost, link,
    worker)."""

    name = "transfer-aware"

    def place(self, req, view) -> Tuple[int, int]:
        step = view.cfg.decode_time_per_step
        best = None
        for wid in self._alive_decodes(view):
            decode_cost = view.decode_load(wid) * step
            for li in range(view.cluster.n_links):
                cost = (view.est_transfer_s(req, li, wid)
                        + view.link_backlog_s(li) + decode_cost)
                key = (cost, li, wid)
                if best is None or key < best:
                    best = key
        return best[1], best[2]


class RoundRobinRouter(Router):
    """Cycle alive decode workers and links independently (the counters
    live on the scheduler)."""

    name = "round-robin"

    def place(self, req, view) -> Tuple[int, int]:
        alive = self._alive_decodes(view)
        wid = alive[view.rr_next("decode") % len(alive)]
        li = view.rr_next("link") % view.cluster.n_links
        return li, wid


class LeastLoadedRouter(Router):
    """Pin the least-loaded alive decode worker when the transfer is
    routed; take the link with the smallest backlog."""

    name = "least-loaded"

    def place(self, req, view) -> Tuple[int, int]:
        wid = min(self._alive_decodes(view),
                  key=lambda w: (view.decode_load(w), w))
        li = min(range(view.cluster.n_links),
                 key=lambda l: (view.link_backlog_s(l), l))
        return li, wid


register_router("legacy", LegacyRouter)
register_router("transfer-aware", TransferAwareRouter)
register_router("round-robin", RoundRobinRouter)
register_router("least-loaded", LeastLoadedRouter)
