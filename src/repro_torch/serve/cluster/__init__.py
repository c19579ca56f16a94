"""Solve cluster: factor-affinity routing over multi-replica engines,
hot-factor replication with TTL demotion, replica health ejection, and
cluster-wide telemetry.  See :mod:`repro_torch.serve.cluster.router`
for the full design notes."""
from .replica import EngineReplica  # noqa: F401
from .selector import AdaptiveSelector  # noqa: F401
from .factor_tier import FactorTier, FactorReplica  # noqa: F401
from .router import (SolveCluster, Router, RoutingPolicy,  # noqa: F401
                     FactorAffinityRouting, LeastLoadedRouting,
                     RoundRobinRouting, make_routing,
                     resolve_devices, ClusterOverloadedError)
from .stats import ClusterStats, ReplicaStats  # noqa: F401
