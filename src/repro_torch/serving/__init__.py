"""Disaggregated serving on the port: the engine and its transfer plane
(plan, session with prefix-delta transfer, faults), and the control plane
(event scheduler, link policies, fleet topology, routers, traces)."""

from repro_torch.serving.plan import TransferConfig, TransferPlan, TransferStats
from repro_torch.serving.session import PrefixIndex, TransferSession
from repro_torch.serving.engine import DisaggregatedEngine, EngineStats
from repro_torch.serving.cluster import (ClusterConfig, LinkSpec,
                                         PrefixDirectory, resolve_cluster)
from repro_torch.serving.policy import (LinkPolicy, available_policies,
                                        get_policy, register_policy)
from repro_torch.serving.router import (Router, available_routers, get_router,
                                        register_router)
from repro_torch.serving.scheduler import (DisaggregatedScheduler, Request,
                                           SchedulerConfig, summarize)
from repro_torch.serving.traces import TenantClass, TraceConfig, generate_trace

__all__ = [
    "TransferConfig", "TransferPlan", "TransferStats", "PrefixIndex",
    "TransferSession", "DisaggregatedEngine", "EngineStats", "ClusterConfig",
    "LinkSpec", "PrefixDirectory", "resolve_cluster", "LinkPolicy",
    "available_policies", "get_policy", "register_policy", "Router",
    "available_routers", "get_router", "register_router",
    "DisaggregatedScheduler", "Request", "SchedulerConfig", "summarize",
    "TenantClass", "TraceConfig", "generate_trace",
]
