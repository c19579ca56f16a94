"""Cluster-wide telemetry: per-replica serving stats plus the router's
decision counters.

``ClusterStats`` is the one artifact a fleet operator (or the CI gate in
``benchmarks.check_cluster_regression``) needs: every replica's
:class:`~repro_torch.serve.frontend.FrontendStats` (which nests its engine's
:class:`~repro_torch.serve.engine.EngineStats`), and the routing counters that
summarize what the cluster-level scheduler did — affinity hits/misses,
hot-factor replications and TTL demotions, health ejections and
re-admissions, and requests shed because the cluster could not serve
them.  Request conservation across the cluster is
``routed == Σ replica completed+failed+pending`` and
``routed + shed == submitted`` — both CI-gated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..frontend import FrontendStats


@dataclasses.dataclass
class ReplicaStats:
    """One replica's view: router-side counters (``routed``,
    ``rejections`` — overload errors the *router* observed submitting
    here) next to the replica's own frontend/engine counters and its
    private :meth:`~repro_torch.core.solver.FactorCache.stats` snapshot
    (``cache`` — hit/miss/eviction/compaction counters and the
    fleet-stack memory accounting, so a fleet operator sees
    ``fleet_device_bytes`` track live factors across compactions)."""

    index: int
    healthy: bool
    ejected: bool
    load: int            # ingress + engine queue + active lanes
    placements: int      # graphs the router holds live on this replica
    routed: int          # requests the router sent here
    rejections: int      # EngineOverloadedError seen routing here
    frontend: FrontendStats
    cache: Optional[Dict] = None
    device: Optional[str] = None  # the replica's torch device

    def as_dict(self) -> Dict:
        # shallow: asdict() would deep-convert the nested frontend and
        # engine stats only for as_dict() below to rebuild them
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "frontend"}
        d["frontend"] = self.frontend.as_dict()
        return d


@dataclasses.dataclass
class ClusterStats:
    """Routing counters + per-replica stats (``SolveCluster.stats()``).

    ``affinity_hits`` counts requests routed to a replica already
    holding (a live placement of) their factor; ``affinity_misses``
    counts routes that had to place the factor first — the
    factor-once/serve-many economics of the cluster live in this ratio
    (``hit_rate``).  ``replications`` / ``demotions`` count hot-factor
    copies promoted to a second replica and TTL-expired copies dropped;
    ``ejections`` / ``readmissions`` the health loop's decisions;
    ``shed`` the requests the cluster could not serve at all — no
    healthy replica, unregistered graph, or factor failure — so
    ``submitted == routed + shed`` holds on every exit path.

    ``precond`` is the cluster's configured preconditioner family
    (``"auto"`` = adaptive selection); ``selector`` carries the
    :class:`~repro_torch.serve.cluster.selector.AdaptiveSelector` counters
    and per-graph estimates when adaptive, else ``None``.

    **Factor-tier telemetry** (disaggregated clusters): ``factor_dedups``
    counts routes/placements that rode an in-flight factor instead of
    enqueueing a second construction; ``adoptions`` the payloads solve
    replicas admitted without factoring (sum of their caches'
    ``adoptions``); ``factor_tier`` the tier's own counters —
    ``factor_queue_depth``, ``coalesced_factorizations``, ``failovers``,
    per-tier-replica ``factor_s`` — or ``None`` when the cluster
    factors colocated.

    ``overload`` carries the attached
    :class:`~repro_torch.obs.overload.OverloadDetector` snapshot — state
    (``ok``/``overloaded``), windowed queue/arrival readings and the
    ``scale_up``/``scale_down``/``hold`` recommendation — or ``None``
    when the cluster runs without one.

    ``health`` carries the attached
    :class:`~repro_torch.obs.health.HealthMonitor` snapshot — tracked
    ``(graph, family)`` pairs, drift quarantines, per-family worst
    maxiter/deadline-miss streaks — or ``None`` without one."""

    policy: str
    replicas: int
    healthy: int
    submitted: int
    routed: int
    affinity_hits: int
    affinity_misses: int
    replications: int
    demotions: int
    ejections: int
    readmissions: int
    shed: int
    hot_graphs: int      # graphs currently holding >= 2 live placements
    per_replica: List[ReplicaStats]
    precond: str = "ac"
    selector: Optional[Dict] = None
    factor_dedups: int = 0
    adoptions: int = 0
    factor_tier: Optional[Dict] = None
    overload: Optional[Dict] = None
    health: Optional[Dict] = None

    @property
    def hit_rate(self) -> float:
        """Fraction of routed requests that landed on a replica already
        holding the factor (0.0 before any routing)."""
        n = self.affinity_hits + self.affinity_misses
        return self.affinity_hits / n if n else 0.0

    def as_dict(self) -> Dict:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "per_replica"}
        d["per_replica"] = [r.as_dict() for r in self.per_replica]
        d["hit_rate"] = self.hit_rate
        return d
