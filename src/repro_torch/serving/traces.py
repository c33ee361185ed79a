"""Seeded multi-tenant trace generator for fleet-scale serving scenarios.

The port of ``repro.serving.traces``:

* **bursty arrivals** — exponential gaps between burst epochs, bounded-Pareto
  burst sizes;
* **heavy-tailed prompt lengths** — bounded Pareto by inverse CDF;
* **SLO classes** — each request draws a weighted :class:`TenantClass`,
  which sets its deadline (``arrival + slo_s``) and output budget;
* **shared-prefix sessions** — with probability ``session_p`` a request
  continues an open session: its prompt is the session's history plus a
  follow-up, and ``prefix_len`` marks the shared prefix for prefix-aware
  delta transfer.

Everything is drawn from one ``numpy`` ``default_rng(seed)`` in the JAX
package's order, so equal configs give the JAX package's trace bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.serving.scheduler import Request


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One service class: arrival weight, SLO, and output-length range."""

    name: str
    weight: float
    slo_s: float
    new_tokens: Tuple[int, int]  # inclusive [lo, hi] max_new_tokens range

    def __post_init__(self):
        if self.weight <= 0.0:
            raise ValueError("TenantClass.weight must be > 0")
        lo, hi = self.new_tokens
        if not (1 <= lo <= hi):
            raise ValueError("TenantClass.new_tokens must satisfy 1 <= lo <= hi")


# Interactive chat (tight TTFT, short outputs), standard API traffic, and
# offline batch (loose SLO, long generations).
DEFAULT_TENANTS: Tuple[TenantClass, ...] = (
    TenantClass("interactive", weight=0.5, slo_s=0.4, new_tokens=(4, 32)),
    TenantClass("standard", weight=0.35, slo_s=1.5, new_tokens=(16, 96)),
    TenantClass("batch", weight=0.15, slo_s=8.0, new_tokens=(64, 256)),
)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs for :func:`generate_trace`; every field has a sane default so
    tests can override just what a scenario varies."""

    seed: int = 0
    n_requests: int = 64
    # arrivals: exponential gaps between bursts, bounded-Pareto burst sizes
    mean_burst_gap_s: float = 0.05
    burst_alpha: float = 1.2
    max_burst: int = 8
    burst_spread_s: float = 0.005   # uniform jitter of arrivals inside a burst
    # bounded-Pareto prompt lengths
    prompt_alpha: float = 1.1
    prompt_min: int = 16
    prompt_max: int = 2048
    tenants: Tuple[TenantClass, ...] = DEFAULT_TENANTS
    # shared-prefix sessions: probability a request continues an open
    # session rather than opening a new one; follow-up turns append
    # [lo, hi] fresh tokens onto the session history
    session_p: float = 0.0
    followup_tokens: Tuple[int, int] = (16, 128)
    max_open_sessions: int = 8

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if not (0.0 <= self.session_p <= 1.0):
            raise ValueError("session_p must be in [0, 1]")
        if not (1 <= self.prompt_min <= self.prompt_max):
            raise ValueError("prompt bounds must satisfy 1 <= min <= max")
        if not self.tenants:
            raise ValueError("at least one TenantClass is required")


def _bounded_pareto(rng: np.random.Generator, alpha: float, lo: float,
                    hi: float) -> float:
    """One bounded-Pareto draw on [lo, hi] via inverse CDF."""
    u = float(rng.random())
    la, ha = lo ** alpha, hi ** alpha
    return (-(u * ha - u * la - ha) / (ha * la)) ** (-1.0 / alpha)


def generate_trace(cfg: TraceConfig) -> List[Request]:
    """Synthesize a seeded multi-tenant trace as scheduler ``Request``s.

    Requests come back sorted by arrival with ``rid`` assigned in arrival
    order (ties broken by generation order), ready for ``Scheduler.submit``.
    Session continuations carry ``session >= 0`` and ``prefix_len`` equal to
    the history already shipped for that session; fresh requests (and all
    requests when ``session_p == 0``) carry ``session == -1``."""
    rng = np.random.default_rng(cfg.seed)
    lo_t, hi_t = cfg.followup_tokens
    weights = np.asarray([t.weight for t in cfg.tenants], dtype=np.float64)
    weights = weights / weights.sum()

    # (arrival, gen_order, prompt, new_tokens, deadline, tenant, sid, prefix)
    rows = []
    # open sessions: sid -> total tokens resident after the last turn
    open_sessions: "dict[int, int]" = {}
    next_sid = 0
    t = 0.0
    made = 0
    while made < cfg.n_requests:
        t += float(rng.exponential(cfg.mean_burst_gap_s))
        burst = int(_bounded_pareto(rng, cfg.burst_alpha, 1.0,
                                    float(cfg.max_burst)))
        burst = min(max(1, burst), cfg.n_requests - made)
        for _ in range(burst):
            arrival = t + float(rng.uniform(0.0, cfg.burst_spread_s))
            tenant = cfg.tenants[int(rng.choice(len(cfg.tenants), p=weights))]
            new_tokens = int(rng.integers(tenant.new_tokens[0],
                                          tenant.new_tokens[1] + 1))
            sid, prefix = -1, 0
            if (cfg.session_p > 0.0 and open_sessions
                    and float(rng.random()) < cfg.session_p):
                # continue the least-recently-extended open session
                sid = min(open_sessions)
                prefix = open_sessions.pop(sid)
                prompt = prefix + int(rng.integers(lo_t, hi_t + 1))
            else:
                prompt = int(round(_bounded_pareto(
                    rng, cfg.prompt_alpha, float(cfg.prompt_min),
                    float(cfg.prompt_max))))
                prompt = min(max(cfg.prompt_min, prompt), cfg.prompt_max)
                if cfg.session_p > 0.0:
                    sid = next_sid
                    next_sid += 1
            if sid >= 0:
                # after this turn the session's resident history is the
                # prompt plus everything it may generate
                open_sessions[sid] = prompt + new_tokens
                while len(open_sessions) > cfg.max_open_sessions:
                    open_sessions.pop(min(open_sessions))
            rows.append((arrival, made, prompt, new_tokens,
                         arrival + tenant.slo_s, tenant.name, sid, prefix))
            made += 1

    rows.sort(key=lambda r: (r[0], r[1]))
    out = []
    for rid, (arrival, _, prompt, new_tokens, deadline, tname, sid,
              prefix) in enumerate(rows):
        out.append(Request(
            rid=rid, arrival=arrival, prompt_len=prompt,
            max_new_tokens=new_tokens, deadline=deadline,
            session=sid, prefix_len=prefix, tenant=tname))
    return out
