"""Factor-affinity router over multi-replica solve engines.

One ``SolveFrontend`` is a scale ceiling: one driver thread, one
``FactorCache``, one device's worth of fleet buffers.  ``SolveCluster``
owns N :class:`~repro_torch.serve.cluster.replica.EngineReplica`\\ s and puts a
``Router`` in front, restating the cache-aware routing pattern of LLM
serving gateways (route to the replica that already holds the expensive
per-tenant state; replicate hot state; shed to the least-loaded replica
otherwise) for factor-once/serve-many PCG: the *factored graph* is the
warm state — cheap to reuse, costly to rebuild — so affinity routing is
what makes the cluster amortize like a single cache.

Routing policies (pluggable, ``make_routing``):

* ``factor_affinity`` — route a ``graph_id`` to the replica whose cache
  holds its fingerprint live (ties: least-loaded, so replicated hot
  factors split traffic); on miss, **place** it on the replica with the
  most free fleet capacity (budget headroom, reusable fleet rows) and
  record the placement;
* ``least_loaded`` (``p2c``) — power-of-two-choices on queue depth +
  in-flight lanes (seeded sampler, so traces replay deterministically);
* ``round_robin`` (``rr``) — the baseline that ignores all state.

Whatever the policy chooses, the cluster *ensures* the factor is
resident before submitting (factoring through the replica's driver-
thread control channel), so ``rr``/``p2c`` pay repeated placements
where affinity pays one — the difference the affinity-hit counters and
``benchmarks.bench_cluster`` measure.

**Hot-factor replication.**  The router tracks per-graph arrival rates
in a sliding window; when a graph crosses ``replicate_above`` req/s and
holds a single live placement, it is proactively factored onto a second
replica **with a TTL** (``replica_ttl_s``), and affinity routing then
splits its traffic across both copies.  Demotion reuses the cache's
existing staleness machinery: the copy expires out of the replica's
cache by TTL, the router observes the fingerprint is no longer fresh on
its next route and drops the placement (counted as a demotion); a graph
that is still hot simply re-promotes.

**Health.**  A replica is unroutable while its driver thread is dead
(``SolveFrontend.alive`` — a crashed driver fails its futures rather
than blackholing, and never comes back) or while it is *ejected*: too
many router-observed ``EngineOverloadedError`` rejections inside the
health window ejects the replica for ``readmit_cooldown_s``, after
which it is re-admitted with a cleared record.  Requests that no
healthy replica can take raise :class:`ClusterOverloadedError` and are
counted as ``shed``.

**Bit-exactness.**  Routing changes *where* a request runs, never what
it computes: each replica serves through the unchanged engine/fleet
programs, so any routed request is bit-exact with a direct
``FactorHandle.solve`` on the serving replica's own cache (the
cluster's signature invariant, acceptance-tested and CI-gated).

**Devices.**  In the port a replica's device is a ``torch.device``
(:func:`resolve_devices`): with no spec the replicas round-robin over
the visible CUDA cards, and with none the cluster raises — the CPU is
used only when it is asked for.  One card may host every replica; each
one's driver thread launches on its own thread's current stream.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from concurrent.futures import Future
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from ...core.solver import PRECOND_FAMILIES, graph_fingerprint
from ...obs.flight import NULL_FLIGHT
from ...obs.registry import NULL as _NULL_METRICS
from ..admission import make_policy
from ..engine import SolveRequest, make_request
from ..frontend import EngineOverloadedError

from .factor_tier import FactorTier
from .replica import EngineReplica
from .selector import AdaptiveSelector
from .stats import ClusterStats, ReplicaStats


def _one_device(s) -> torch.device:
    """One entry of a device spec — a ``torch.device``, a card index or a
    device string (``"cpu"``, ``"cuda"``, ``"cuda:1"``) — with a CUDA
    device given its index (``"cuda"`` is card 0) and checked to exist."""
    if isinstance(s, int) or (isinstance(s, str) and s.isdigit()):
        dev = torch.device("cuda", int(s))
    else:
        dev = torch.device(s)
    if dev.type == "cuda":
        idx = 0 if dev.index is None else dev.index
        count = torch.cuda.device_count()
        if not 0 <= idx < count:
            raise ValueError(f"device {s!r}: {count} CUDA device(s) "
                             f"available")
        dev = torch.device("cuda", idx)
    return dev


def resolve_devices(spec, n: int) -> List[torch.device]:
    """Resolve a device assignment for ``n`` replica slots.

    ``spec`` may be ``None`` (round-robin over ``cuda:0 …
    cuda:{device_count-1}``; raises, as ``runtime.resolve_device`` does,
    when no CUDA device is present — the CPU is never chosen silently), a
    comma-separated string (``"cuda:0,cuda:1"``, ``"0,1"``, ``"cpu"`` —
    the ``--devices`` CLI form), or a sequence of ``torch.device``\\ s,
    integer card indices or device strings.  Fewer entries than slots
    round-robin."""
    if spec is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass devices='cpu' "
                               "to run the plain PyTorch path")
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        if isinstance(spec, (str, int, torch.device)):
            spec = ([p.strip() for p in spec.split(",") if p.strip()]
                    if isinstance(spec, str) else [spec])
        pool = [_one_device(s) for s in spec]
        if not pool:
            raise ValueError("empty device spec")
    return [pool[i % len(pool)] for i in range(n)]


class ClusterOverloadedError(EngineOverloadedError):
    """No healthy replica could take the request (all ejected, dead, or
    rejecting under backpressure) — the cluster-level 429."""


def _capacity_score(rep: EngineReplica) -> Tuple:
    """Comparable free-capacity key (higher = roomier): budget headroom
    first, then admittable handles, then fleet rows reusable without
    growing a stack, then fewest resident handles."""
    p = rep.capacity_probe()
    return (p["free_bytes"] if p["free_bytes"] is not None else float("inf"),
            (p["free_handles"] if p["free_handles"] is not None
             else float("inf")),
            p["fleet_free_rows"], -p["handles"])


def _roomiest(reps: Sequence[EngineReplica]) -> EngineReplica:
    return max(reps, key=lambda r: (_capacity_score(r), -r.load, -r.index))


# ---------------------------------------------------------------------------
# Routing policies
# ---------------------------------------------------------------------------

class RoutingPolicy:
    """Chooses the serving replica for one request.  ``holders`` are the
    healthy replicas already holding the graph's factor live,
    ``pending`` those with a factor for it still in flight (both
    possibly empty); ``candidates`` are all healthy replicas (a
    superset).  The cluster ensures the factor is resident on whatever
    is returned, so a policy that ignores ``holders`` simply pays more
    placements."""

    name = "base"

    def choose(self, graph_id: str, holders: Sequence[EngineReplica],
               candidates: Sequence[EngineReplica],
               pending: Sequence[EngineReplica] = ()) -> EngineReplica:
        raise NotImplementedError


class RoundRobinRouting(RoutingPolicy):
    """Cycle over healthy replicas, blind to factor placement and load —
    the baseline affinity routing must beat on hit rate (CI-gated)."""

    name = "rr"

    def __init__(self):
        self._i = 0

    def choose(self, graph_id, holders, candidates, pending=()):
        rep = candidates[self._i % len(candidates)]
        self._i += 1
        return rep


class LeastLoadedRouting(RoutingPolicy):
    """Power-of-two-choices: sample two healthy replicas (seeded RNG —
    replays are deterministic) and take the less loaded; the classic
    balanced-allocations shed policy, still blind to placement."""

    name = "p2c"

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def choose(self, graph_id, holders, candidates, pending=()):
        if len(candidates) > 2:
            ij = self._rng.choice(len(candidates), size=2, replace=False)
            candidates = [candidates[int(k)] for k in ij]
        return min(candidates, key=lambda r: (r.load, r.index))


class FactorAffinityRouting(RoutingPolicy):
    """Route to a replica already holding the factor (least-loaded among
    holders, so a replicated hot factor splits its traffic); a factor
    still *in flight* counts next — riding the pending placement
    instead of starting a second immortal copy of the same graph; only
    a true miss places, on the replica with the most free fleet
    capacity."""

    name = "affinity"

    def choose(self, graph_id, holders, candidates, pending=()):
        if holders:
            return min(holders, key=lambda r: (r.load, r.index))
        if pending:
            return min(pending, key=lambda r: (r.load, r.index))
        return _roomiest(candidates)


_ROUTINGS = {
    "rr": RoundRobinRouting, "round_robin": RoundRobinRouting,
    "p2c": LeastLoadedRouting, "least_loaded": LeastLoadedRouting,
    "affinity": FactorAffinityRouting,
    "factor_affinity": FactorAffinityRouting,
}


def make_routing(name: str, *, seed: int = 0) -> RoutingPolicy:
    """Build a routing policy by CLI name (``affinity`` / ``p2c`` /
    ``rr``, long aliases accepted)."""
    try:
        cls = _ROUTINGS[name]
    except KeyError:
        raise ValueError(f"unknown routing policy {name!r}; choose from "
                         f"{sorted(_ROUTINGS)}") from None
    return cls(seed=seed) if cls is LeastLoadedRouting else cls()


# ---------------------------------------------------------------------------
# Router: placements, rates, health, counters
# ---------------------------------------------------------------------------

_MISSING = object()


def _done_future() -> Future:
    fut: Future = Future()
    fut.set_result(None)
    return fut


class Router:
    """The cluster's stateful routing brain.  Owns the placement map
    (``graph_id -> {replica_index: None | pending factor Future}``),
    per-graph arrival-rate windows, per-replica health records and every
    routing counter.  All methods are called with the cluster lock held;
    replica probes they touch are read-only."""

    def __init__(self, policy: RoutingPolicy,
                 replicas: Sequence[EngineReplica], *,
                 clock: Callable[[], float],
                 factor_cb: Callable[[str, EngineReplica, Optional[float]],
                                     Future],
                 replicate_above: Optional[float] = None,
                 rate_window_s: float = 1.0,
                 replica_ttl_s: float = 30.0,
                 eject_rejections: int = 4,
                 health_window_s: float = 1.0,
                 readmit_cooldown_s: float = 2.0,
                 flight=None):
        self.policy = policy
        self.replicas = list(replicas)
        self._clock = clock
        self._factor_cb = factor_cb
        self.replicate_above = replicate_above
        self.rate_window_s = rate_window_s
        self.replica_ttl_s = replica_ttl_s
        self.eject_rejections = eject_rejections
        self.health_window_s = health_window_s
        self.readmit_cooldown_s = readmit_cooldown_s
        # graph_id -> {replica index: None (live) | Future (factoring)}
        self.placements: Dict[str, Dict[int, Optional[Future]]] = {}
        self._arrivals: Dict[str, Deque[float]] = defaultdict(deque)
        self._rejects: Dict[int, Deque[float]] = defaultdict(deque)
        self._ejected_until: Dict[int, float] = {}
        self.routed = 0
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.factor_dedups = 0
        self.replications = 0
        self.demotions = 0
        self.ejections = 0
        self.readmissions = 0
        self.shed = 0
        self.routed_per: Dict[int, int] = defaultdict(int)
        self.rejections_per: Dict[int, int] = defaultdict(int)
        # flight-recorder hooks: pre-bound so the health loop pays one
        # call per *transition*, nothing per route.  incident() defers
        # its dump to a worker thread, so firing it here — under the
        # cluster lock — cannot deadlock against stats_fn.
        fl = flight if flight is not None else NULL_FLIGHT
        self._flight = fl
        self._ev_eject = fl.bind("eject")
        self._ev_readmit = fl.bind("readmit")

    # -- health -------------------------------------------------------------
    def healthy(self, *, advance: bool = True) -> List[EngineReplica]:
        """Routable replicas.  With ``advance`` (the routing path) this
        also runs the ejection/re-admission loop: a dead driver ejects
        permanently (its futures are already failed — work *drains*, it
        does not blackhole); an overload ejection expires after
        ``readmit_cooldown_s``.  ``advance=False`` (telemetry) is a pure
        read — polling stats must never change routing state or count
        cleanly-closed replicas as ejections."""
        now = self._clock()
        out = []
        for rep in self.replicas:
            i = rep.index
            until = self._ejected_until.get(i)
            if not rep.alive:
                if advance and until != float("inf"):
                    if until is None:
                        self.ejections += 1
                        self._ev_eject(replica=i, reason="dead_driver")
                        self._flight.incident("replica_ejected",
                                              replica=i,
                                              cause="dead_driver")
                    self._ejected_until[i] = float("inf")
                continue
            if until is not None:
                if now < until:
                    continue
                if advance:
                    del self._ejected_until[i]  # cooldown over: probation
                    self._rejects[i].clear()
                    self.readmissions += 1
                    self._ev_readmit(replica=i)
            out.append(rep)
        return out

    def record_overload(self, rep: EngineReplica) -> None:
        """A submit to ``rep`` raised ``EngineOverloadedError``; too many
        inside the health window ejects it for the cooldown."""
        i = rep.index
        self.rejections_per[i] += 1
        now = self._clock()
        dq = self._rejects[i]
        dq.append(now)
        while dq and dq[0] < now - self.health_window_s:
            dq.popleft()
        if len(dq) >= self.eject_rejections and \
                i not in self._ejected_until:
            self._ejected_until[i] = now + self.readmit_cooldown_s
            self.ejections += 1
            dq.clear()
            self._ev_eject(replica=i, reason="overload")
            self._flight.incident("replica_ejected", replica=i,
                                  cause="overload")

    def record_routed(self, rep: EngineReplica, *, hit: bool) -> None:
        """A submit to ``rep`` was accepted — only now does the route
        count (and classify as affinity hit or miss), so overload
        retries cannot double-count and ``affinity_hits +
        affinity_misses == routed`` is an exact invariant (CI-gated)."""
        self.routed += 1
        self.routed_per[rep.index] += 1
        if hit:
            self.affinity_hits += 1
        else:
            self.affinity_misses += 1

    # -- placements ---------------------------------------------------------
    def _refresh_placements(self, gid: str) -> Dict[int, Optional[Future]]:
        """Resolve pending factor futures, drop placements on dead
        replicas, demote TTL-expired (or externally evicted) copies."""
        pl = self.placements.get(gid)
        if not pl:
            return {}
        for i, fut in list(pl.items()):
            rep = self.replicas[i]
            if not rep.alive:
                del pl[i]                   # replica gone, placement too
                continue
            if fut is not None:
                if not fut.done():
                    continue                # still factoring
                if fut.exception() is not None:
                    del pl[i]               # factor failed
                    continue
                pl[i] = None                # landed: live placement
            if not rep.fresh(gid):
                del pl[i]                   # TTL demotion (staleness
                self.demotions += 1         # machinery did the aging)
        if not pl:
            self.placements.pop(gid, None)
            return {}
        return dict(pl)

    def place(self, gid: str, rep: EngineReplica, *,
              ttl_s: Optional[float] = None) -> Future:
        """Ensure ``gid``'s factor is (or is becoming) resident on
        ``rep``; returns a future resolving when it is.  The placement
        is recorded only once the factor call is actually in flight —
        a ``_factor_cb`` that raises (e.g. unregistered graph) must not
        leave a stray empty placement entry behind."""
        pl = self.placements.get(gid)
        if pl is not None:
            cur = pl.get(rep.index, _MISSING)
            if cur is None:
                return _done_future()       # already live
            if isinstance(cur, Future):
                self.factor_dedups += 1     # ride the in-flight factor
                return cur
        fut = self._factor_cb(gid, rep, ttl_s)
        self.placements.setdefault(gid, {})[rep.index] = fut
        return fut

    def drop_placement(self, gid: str, index: int) -> None:
        """Forget ``gid``'s placement on replica ``index`` (TTL expiry
        or eviction observed) — the next route re-places on a miss."""
        pl = self.placements.get(gid)
        if pl is not None:
            pl.pop(index, None)
            if not pl:
                self.placements.pop(gid, None)

    def note_arrival(self, gid: str) -> float:
        """Record one arrival; returns the windowed rate (req/s)."""
        now = self._clock()
        dq = self._arrivals[gid]
        dq.append(now)
        while dq and dq[0] < now - self.rate_window_s:
            dq.popleft()
        return len(dq) / self.rate_window_s

    # -- the routing decision ----------------------------------------------
    def route(self, gid: str, *, exclude: Set[int] = frozenset()
              ) -> Tuple[Optional[EngineReplica], Optional[Future], bool]:
        """Pick the serving replica for one request on ``gid``.  Returns
        ``(replica, wait, hit)`` — ``wait`` is a factor future the
        caller must resolve before submitting (``None`` when the factor
        is already live), ``hit`` whether the target already had a
        placement (counted via ``record_routed`` only once the submit
        lands) — or ``(None, None, False)`` when no healthy replica
        remains outside ``exclude``."""
        healthy = [r for r in self.healthy() if r.index not in exclude]
        if not healthy:
            return None, None, False
        # one arrival per *request*: overload retries (non-empty
        # exclude) must not inflate the rate — and must never trigger
        # replication, which would add factor work to a cluster at the
        # exact moment it is rejecting under load
        rate = self.note_arrival(gid) if not exclude else 0.0
        pl = self._refresh_placements(gid)
        hidx = {r.index for r in healthy}
        holders = [self.replicas[i] for i, f in pl.items()
                   if f is None and i in hidx]
        pending = [self.replicas[i] for i, f in pl.items()
                   if f is not None and i in hidx]
        target = self.policy.choose(gid, holders, healthy, pending)
        placed = target.index in pl
        # a hit is a route to a *live* factor (what hit_rate advertises);
        # riding a still-pending placement reuses the in-flight factor
        # but pays the cold latency, so it counts as a miss
        hit = placed and pl[target.index] is None
        if placed:
            wait = pl[target.index]         # None (live) or pending
            if wait is not None:
                self.factor_dedups += 1     # ride the in-flight factor
        else:
            wait = self.place(gid, target)  # immortal primary placement
        # hot-factor replication: a hot graph with exactly one *live*
        # copy gets a TTL'd twin on the roomiest other healthy replica.
        # The twin is opportunistic — a failure placing it (replica died
        # since the health snapshot, probe error) must never fail the
        # request that happened to trigger it.
        pls = self.placements.get(gid, {})
        if (self.replicate_above is not None
                and rate >= self.replicate_above
                and len(pls) == 1 and next(iter(pls.values())) is None):
            others = [r for r in healthy if r.index not in pls]
            if others:
                try:
                    self.place(gid, _roomiest(others),
                               ttl_s=self.replica_ttl_s)
                    self.replications += 1
                except Exception:
                    pass
        return target, wait, hit


# ---------------------------------------------------------------------------
# SolveCluster: the user-facing multi-replica service
# ---------------------------------------------------------------------------

class SolveCluster:
    """N engine replicas behind a routing policy.

    ::

        cluster = SolveCluster(replicas=2, routing="affinity",
                               replicate_above=100.0)
        gid = cluster.register(graph, key_from_seed(0))
        fut = cluster.submit(gid, b)          # Future[SolveRequest]
        res = fut.result()                    # res.replica = serving idx
        # or:  res = await cluster.solve(gid, b)

    ``register`` records ``(graph, key)`` so the router can factor the
    graph onto whichever replica it places it on (first routed request
    pays the cold factor; ``factor()`` pre-warms explicitly).  Every
    request is stamped with its serving replica (``req.replica``), and
    replaying it there directly reproduces the served result bit-exactly.

    **Preconditioner family** (``precond``): a fixed family name from
    :data:`repro_torch.core.solver.PRECOND_FAMILIES` serves every request
    under that family, or ``"auto"`` puts an
    :class:`~repro_torch.serve.cluster.selector.AdaptiveSelector` in front —
    an epsilon-greedy bandit choosing per request from per-graph
    convergence telemetry (cold graphs fall back to AC).  Placements of
    a non-AC family use **family-qualified graph ids**
    (``"<gid>::<family>"``), so one graph can hold several families'
    factors across the cluster; requests are rewritten to the chosen
    qualified id before routing, and ``res.graph_id`` reports the id
    that actually served.

    **Devices** (``devices``, see :func:`resolve_devices`): solve
    replicas take the first slots, factor replicas the rest.  With
    ``factor_replicas`` > 0 construction runs on a
    :class:`~repro_torch.serve.cluster.factor_tier.FactorTier`.
    """

    def __init__(self, *, replicas: int = 2, routing: str = "affinity",
                 slots: int = 8, iters_per_tick: int = 8,
                 admission: str = "fifo", max_skips: Optional[int] = None,
                 max_queue: int = 256, overload: str = "reject",
                 precond: str = "ac",
                 precond_params: Optional[Dict] = None,
                 select_epsilon: float = 0.1,
                 replicate_above: Optional[float] = None,
                 rate_window_s: float = 1.0, replica_ttl_s: float = 30.0,
                 eject_rejections: int = 4, health_window_s: float = 1.0,
                 readmit_cooldown_s: float = 2.0,
                 clock: Optional[Callable[[], float]] = None,
                 seed: int = 0, cache_kw: Optional[Dict] = None,
                 devices=None, factor_replicas: int = 0,
                 factor_max_batch: int = 16,
                 metrics=None, tracer=None, detector=None,
                 flight=None, health=None):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if factor_replicas < 0:
            raise ValueError("factor_replicas must be >= 0")
        if precond != "auto" and precond not in PRECOND_FAMILIES:
            raise ValueError(
                f"unknown precond {precond!r}; choose a registered family "
                f"{sorted(PRECOND_FAMILIES)} or 'auto'")
        self.precond = precond
        self.precond_params = dict(precond_params or {})
        # ``auto`` chooses among the registered families, in the
        # reference's preference order (the port registers AC alone)
        self.selector = None
        if precond == "auto":
            self.selector = AdaptiveSelector(
                families=[f for f in ("ac", "ichol", "amg", "spai")
                          if f in PRECOND_FAMILIES],
                seed=seed, epsilon=select_epsilon)
        # perf_counter matches the engines' default clock, so the
        # cluster-stamped submit_time and the engine-stamped admit/finish
        # times live on one timeline (what makes the lifecycle span
        # partition sum to e2e latency)
        self._clock = clock if clock is not None else time.perf_counter
        # solve replicas take the first device slots, factor replicas
        # the next ones — on a host with >= replicas + factor_replicas
        # devices the tiers never share an accelerator
        devs = resolve_devices(devices, replicas + factor_replicas)
        self.devices = devs[:replicas]
        self.replicas = [
            EngineReplica(i, slots=slots, iters_per_tick=iters_per_tick,
                          admission=make_policy(admission,
                                                max_skips=max_skips),
                          max_queue=max_queue, overload=overload,
                          clock=clock, device=devs[i], cache_kw=cache_kw,
                          metrics=metrics, tracer=tracer,
                          flight=flight, health=health)
            for i in range(replicas)]
        ckw = dict(cache_kw or {})
        self.factor_tier = FactorTier(
            factor_replicas, devices=devs[replicas:],
            chunk=ckw.get("chunk", 64),
            fill_slack=ckw.get("fill_slack", 32),
            strict=ckw.get("strict", True),
            max_retries=ckw.get("max_retries", 3),
            dtype=ckw.get("dtype", np.float32),
            max_batch=factor_max_batch,
            on_retarget=self._retarget,
            metrics=metrics,
            flight=flight) if factor_replicas > 0 else None
        self.router = Router(
            make_routing(routing, seed=seed), self.replicas,
            clock=self._clock, factor_cb=self._factor_on,
            replicate_above=replicate_above, rate_window_s=rate_window_s,
            replica_ttl_s=replica_ttl_s, eject_rejections=eject_rejections,
            health_window_s=health_window_s,
            readmit_cooldown_s=readmit_cooldown_s,
            flight=flight)
        self.registry: Dict[str, Tuple] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self.submitted = 0

        # -- observability (repro_torch.obs): cluster-level instruments + the
        # pull-style mirror of router/cache counters.  The mirror runs
        # as a registry collect callback (sample/scrape time), so the
        # routing hot path is untouched by it.
        reg = metrics if metrics is not None else _NULL_METRICS
        self.metrics = metrics
        self.tracer = tracer
        self._m_arrivals = reg.counter(
            "repro_cluster_arrivals_total",
            "requests entering the cluster submit path")
        self._m_routed = reg.counter(
            "repro_cluster_routed_total",
            "requests successfully routed, by affinity outcome",
            labels=("hit",))
        self._m_shed = reg.counter(
            "repro_cluster_shed_total",
            "requests no healthy replica could take")
        self._m_queue = reg.gauge(
            "repro_cluster_queue_depth",
            "requests waiting before lane admission, summed over "
            "healthy replicas")
        self._m_latency = reg.histogram(
            "repro_cluster_latency_seconds",
            "client-observed end-to-end latency (cluster submit to "
            "finish)")
        self._m_factor_wait = reg.histogram(
            "repro_cluster_factor_wait_seconds",
            "cold-path construction/adopt wait per routed request")
        self._obs_lock = threading.Lock()
        self.detector = detector
        self._prev_det_state: Optional[str] = None
        # -- forensic half (obs.flight / obs.health): the recorder gets
        # the cluster's stats snapshot as post-mortem context, the
        # health monitor watches every replica's engine
        # retirements and feeds drift quarantines into the selector.
        self.flight = flight
        self.health = health
        fl = flight if flight is not None else NULL_FLIGHT
        self._ev_detector = fl.bind("detector_transition")
        if flight is not None:
            flight.attach(stats_fn=lambda: self.stats().as_dict(),
                          registry=metrics)
        if health is not None:
            for rep in self.replicas:
                health.watch_engine(rep.engine)
                health.watch_cache(rep.cache)
            if self.selector is not None:
                health.on_quarantine = self._quarantine
        if metrics is not None:
            self._g_healthy = reg.gauge(
                "repro_cluster_healthy_replicas", "routable replicas")
            self._g_placements = reg.gauge(
                "repro_cluster_live_placements", "live factor placements")
            self._g_factor_queue = reg.gauge(
                "repro_cluster_factor_tier_queue_depth",
                "constructions queued on the factor tier")
            self._g_overload = reg.gauge(
                "repro_cluster_overload_state",
                "overload detector state (0 = ok, 1 = overloaded)")
            self._g_cache_bytes = reg.gauge(
                "repro_cache_device_bytes",
                "device bytes held by a replica's factor cache",
                labels=("replica",))
            metrics.on_collect(self._collect)

    # -- graph registry -----------------------------------------------------
    def register(self, g, key, *, graph_id: Optional[str] = None) -> str:
        """Record ``(graph, key)`` under its fingerprint (or explicit
        id) so the router can place its factor on demand.  ``"::"`` is
        reserved in explicit ids (it separates the family qualifier in
        placement ids)."""
        gid = graph_id if graph_id is not None else graph_fingerprint(g, key)
        if "::" in gid:
            raise ValueError(f"graph_id {gid!r} contains the reserved "
                             f"family separator '::'")
        with self._lock:
            self.registry[gid] = (g, key)
        return gid

    @staticmethod
    def _qualify(gid: str, family: str) -> str:
        """Placement id for ``gid`` served under ``family`` — AC keeps
        the bare id (backward compatible with every recorded trace)."""
        return gid if family == "ac" else f"{gid}::{family}"

    @staticmethod
    def _split(placement_id: str) -> Tuple[str, str]:
        base, sep, fam = placement_id.partition("::")
        return base, (fam if sep else "ac")

    def _serving_family(self, gid: str,
                        deadline_s: Optional[float]) -> str:
        """Family this request serves under: the fixed configured
        family, or the selector's per-graph pick for ``auto``."""
        if self.selector is not None:
            return self.selector.pick(gid, deadline_s=deadline_s)
        return self.precond

    def _quarantine(self, gid: str, family: str) -> None:
        """Health-monitor drift callback: quarantine ``family`` for the
        drifting graph in the adaptive selector.  The engine reports the
        *placement* id (possibly family-qualified) — the selector keys
        on the base graph id."""
        base, _, _ = gid.partition("::")
        self.selector.quarantine(base, family)

    def _factor_on(self, gid: str, rep: EngineReplica,
                   ttl_s: Optional[float]) -> Future:
        base, fam = self._split(gid)
        try:
            g, key = self.registry[base]
        except KeyError:
            raise KeyError(
                f"graph_id {base!r} is not registered with the cluster "
                f"(call register(graph, key) first)") from None
        params = self.precond_params if fam == self.precond else None
        if self.factor_tier is not None:
            # disaggregated path: construction queues on the factor
            # tier; the serving driver only pays the adopt
            return self.factor_tier.submit(
                gid, g, key, family=fam, precond_params=params,
                ttl_s=ttl_s, target=rep)
        return rep.factor(g, key, graph_id=gid, family=fam,
                          precond_params=params, ttl_s=ttl_s)

    def _retarget(self, gid: str, dead_index: int,
                  fut: Future) -> Optional[EngineReplica]:
        """Factor-tier failover: the placement target died before its
        adoption landed.  Move the pending placement to the roomiest
        healthy replica (under the cluster lock — the tier worker calls
        in from its own thread) and return it, or ``None`` when the
        cluster has nowhere left to put the factor."""
        with self._lock:
            healthy = [r for r in self.router.healthy()
                       if r.index != dead_index]
            if not healthy:
                return None
            new = _roomiest(healthy)
            pl = self.router.placements.get(gid)
            if pl is not None and pl.get(dead_index) is fut:
                del pl[dead_index]
            self.router.placements.setdefault(gid, {})[new.index] = fut
            return new

    def factor(self, g, key, *, graph_id: Optional[str] = None,
               replica: Optional[int] = None) -> Tuple[str, int]:
        """Pre-warm: register and factor now (blocking) on ``replica``
        or on the roomiest healthy replica, under the cluster's
        configured family (``auto`` pre-warms the AC fallback — the
        family cold graphs serve under).  Returns ``(graph_id,
        replica_index)``."""
        gid = self.register(g, key, graph_id=graph_id)
        fam = "ac" if self.precond == "auto" else self.precond
        with self._lock:
            healthy = self.router.healthy()
            if not healthy:
                raise ClusterOverloadedError("no healthy replica to "
                                             "factor onto")
            rep = self.replicas[replica] if replica is not None \
                else _roomiest(healthy)
            fut = self.router.place(self._qualify(gid, fam), rep)
        fut.result()
        return gid, rep.index

    def _collect(self, reg) -> None:
        """Registry collect callback: mirror router/cache snapshot state
        into gauges at sample/scrape time (pull-style — the routing hot
        path never pays for these), then advance the overload detector
        on the freshly-aggregated queue depth."""
        alive = [rep for rep in self.replicas if rep.alive]
        self._g_healthy.set(len(alive))
        self._m_queue.set(sum(rep.frontend.queue_depth for rep in alive))
        self._g_placements.set(
            sum(1 for pl in list(self.router.placements.values())
                for v in list(pl.values()) if v is None))
        self._g_factor_queue.set(
            self.factor_tier.queue_depth if self.factor_tier is not None
            else 0)
        for rep in self.replicas:
            self._g_cache_bytes.labels(replica=str(rep.index)).set(
                rep.cache.device_bytes if rep.alive else 0)
        if self.detector is not None:
            with self._obs_lock:   # samples race in from replica drivers
                state = self.detector.update(self._clock())
            self._g_overload.set(1 if state == "overloaded" else 0)
            prev = self._prev_det_state
            if state != prev:
                self._prev_det_state = state
                self._ev_detector(state=state, prev=prev or "")
                # a flip *into* overloaded is the sustained-pressure
                # incident the post-mortem dump exists for; the flip
                # back to ok is just an event
                if prev is not None and state == "overloaded":
                    fl = self.flight
                    if fl is not None:
                        fl.incident("sustained_overload",
                                    detector=self.detector.name,
                                    state=state)

    def _obs_done(self, fut: Future) -> None:
        """Done-callback (attached only when metrics are on) observing
        the client-visible latency of one routed request."""
        try:
            res = fut.result()
        except Exception:
            return
        self._m_latency.observe(max(res.finish_time - res.submit_time, 0.0))

    def _observer(self, base_gid: str, fam: str) -> Callable:
        """Done-callback feeding one served request back into the
        selector: service seconds as the client saw them, block-max
        iterations, convergence and deadline outcome.  A failed future
        (replica died mid-flight) records a non-converged observation
        so the bandit deprioritizes whatever was being tried."""
        def _cb(fut: Future) -> None:
            sel = self.selector
            try:
                res = fut.result()
            except Exception:
                sel.observe(base_gid, fam, wall_s=float("inf"), ok=False,
                            deadline_ok=False)
                return
            wall = max(res.finish_time - res.submit_time, 0.0)
            iters = int(np.max(res.iters)) if res.iters is not None else None
            missed = res.status == "deadline_missed" or (
                res.deadline_s is not None and wall > res.deadline_s)
            # feed the bandit *deconflated* timings off the request's
            # lifecycle stamps: pure service time (admit -> finish) as
            # the serve signal, the cold-path construction wait as its
            # own component — not the wall-clock that mixed both with
            # queueing (the ROADMAP's conflated-EWMA defect)
            serve = max(res.finish_time - res.admit_time, 0.0) \
                if res.admit_time > 0.0 else wall
            construct = res.factor_wait_s if res.factor_mode else None
            sel.observe(base_gid, fam, wall_s=wall, serve_s=serve,
                        construct_s=construct, iters=iters,
                        ok=res.status == "converged",
                        deadline_ok=not missed)
        return _cb

    # -- request path -------------------------------------------------------
    def submit_request(self, req: SolveRequest) -> "Future[SolveRequest]":
        """Route and submit a pre-built request.  Overloaded replicas
        are retried on the next-best healthy replica (each rejection
        feeds the health/ejection record); when none remains — or the
        request cannot be served at all (unregistered graph, factor
        failure) — it is **shed**, so ``submitted == routed + shed``
        holds on every exit path (CI-gated)."""
        with self._lock:
            self.submitted += 1
        self._m_arrivals.inc()
        # stamp ingress on the cluster clock (shared with the engines):
        # route and factor waits below then land inside the request's
        # [submit, finish] window, so traces attribute them and cold
        # latency includes the construction the client actually waited on
        if req.submit_time == 0.0:
            req.submit_time = self._clock()
        # resolve the serving family once per request (overload retries
        # keep it — the retry is about *where*, not *what*) and rewrite
        # the graph id to the family-qualified placement id
        base_gid, req_fam = self._split(req.graph_id)
        if req_fam == "ac":               # not already qualified
            req_fam = self._serving_family(base_gid, req.deadline_s)
            req.graph_id = self._qualify(base_gid, req_fam)
        tried: Set[int] = set()
        route_errors = 0
        try:
            while True:
                with self._lock:
                    try:
                        rep, wait, hit = self.router.route(req.graph_id,
                                                           exclude=tried)
                    except RuntimeError:
                        # a replica closed between the health snapshot
                        # and the factor-call enqueue; its alive flag is
                        # already False so the next pass routes around
                        # it — bounded by the replica count so a
                        # persistent error still surfaces
                        route_errors += 1
                        if route_errors > len(self.replicas):
                            raise
                        continue
                if rep is None:
                    raise ClusterOverloadedError(
                        f"no healthy replica for graph_id="
                        f"{req.graph_id!r} ({len(tried)} overloaded "
                        f"this submit)")
                # time-to-final-routing-decision (overwritten on retry:
                # the span covers everything before this attempt's
                # factor wait, keeping the trace partition contiguous)
                req.route_s = max(self._clock() - req.submit_time, 0.0)
                if wait is not None:
                    t_w0 = self._clock()
                    try:
                        wait.result()  # cold path: factor landing first
                    except Exception:
                        with self._lock:
                            self.router.drop_placement(req.graph_id,
                                                       rep.index)
                        if not rep.alive:
                            # replica died mid-factor: fail over, same
                            # as the submit-path race below
                            tried.add(rep.index)
                            continue
                        raise          # genuine factor failure: surface
                    req.factor_wait_s = max(self._clock() - t_w0, 0.0)
                    req.factor_mode = ("adopt" if self.factor_tier
                                       is not None else "factor")
                    self._m_factor_wait.observe(req.factor_wait_s)
                try:
                    fut = rep.submit(req)
                except EngineOverloadedError:
                    with self._lock:
                        self.router.record_overload(rep)
                    tried.add(rep.index)
                    continue
                except RuntimeError:
                    # replica closed/crashed between the health snapshot
                    # and this submit: skip it for this request — the
                    # next route's health pass ejects it — and fail over
                    # to the remaining replicas instead of surfacing a
                    # raw frontend error to the caller
                    tried.add(rep.index)
                    continue
                req.replica = rep.index
                with self._lock:
                    self.router.record_routed(rep, hit=hit)
                self._m_routed.labels(hit="1" if hit else "0").inc()
                if self.metrics is not None:
                    fut.add_done_callback(self._obs_done)
                if self.selector is not None:
                    fut.add_done_callback(
                        self._observer(base_gid, req_fam))
                return fut
        except Exception:
            with self._lock:
                self.router.shed += 1
            self._m_shed.inc()
            raise

    def submit(self, graph_id: str, b, *, rid: Optional[int] = None,
               **kw) -> "Future[SolveRequest]":
        """Build, route and queue a solve request (same builder and
        kwargs as ``SolveFrontend.submit`` —
        :func:`repro_torch.serve.engine.make_request`)."""
        with self._lock:
            self._seq += 1
            auto_rid = self._seq
        return self.submit_request(make_request(
            graph_id, b, rid=rid if rid is not None else auto_rid, **kw))

    async def solve(self, graph_id: str, b, **kw) -> SolveRequest:
        """Asyncio face (note: a cold-placement factor blocks the
        submitting coroutine — pre-warm with ``factor()`` where that
        matters)."""
        import asyncio
        return await asyncio.wrap_future(self.submit(graph_id, b, **kw))

    # -- telemetry ----------------------------------------------------------
    def stats(self) -> ClusterStats:
        """Point-in-time :class:`ClusterStats` snapshot: routing and
        health counters, per-replica breakdown (nesting each replica's
        ``FrontendStats``), the serving family, and the adaptive
        selector's estimate table under ``--precond auto`` (glossary in
        ``docs/serving.md``).  Pure read — never advances the ejection
        state machine."""
        with self._lock:
            r = self.router
            # telemetry must not advance the ejection state machine
            healthy_idx = {rep.index for rep in r.healthy(advance=False)}
            # placement counts filter on liveness here (pure read): the
            # routing path only prunes a dead replica's placements when
            # that gid is next routed, and idle graphs never are — a
            # dead replica must still report zero placements
            alive_idx = {rep.index for rep in self.replicas if rep.alive}
            def live_on(i):
                return sum(1 for pl in r.placements.values()
                           if i in pl and pl[i] is None) \
                    if i in alive_idx else 0
            per = [ReplicaStats(
                index=rep.index, healthy=rep.index in healthy_idx,
                ejected=rep.index in r._ejected_until,
                load=rep.load, placements=live_on(rep.index),
                routed=r.routed_per[rep.index],
                rejections=r.rejections_per[rep.index],
                frontend=rep.frontend.stats(),
                cache=rep.cache.stats(),
                device=(str(rep.device) if rep.device is not None
                        else None)) for rep in self.replicas]
            hot = sum(1 for pl in r.placements.values()
                      if sum(1 for i, v in pl.items()
                             if v is None and i in alive_idx) >= 2)
            return ClusterStats(
                policy=r.policy.name, replicas=len(self.replicas),
                healthy=len(healthy_idx), submitted=self.submitted,
                routed=r.routed, affinity_hits=r.affinity_hits,
                affinity_misses=r.affinity_misses,
                replications=r.replications, demotions=r.demotions,
                ejections=r.ejections, readmissions=r.readmissions,
                shed=r.shed, hot_graphs=hot, per_replica=per,
                precond=self.precond,
                selector=(self.selector.stats()
                          if self.selector is not None else None),
                factor_dedups=r.factor_dedups,
                adoptions=sum(rep.cache.adoptions
                              for rep in self.replicas),
                factor_tier=(self.factor_tier.stats()
                             if self.factor_tier is not None else None),
                overload=(self.detector.stats()
                          if self.detector is not None else None),
                health=(self.health.snapshot()
                        if self.health is not None else None))

    # -- lifecycle ----------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every replica's submitted work has resolved (a
        dead replica's futures are already failed — skipped)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = True
        for rep in self.replicas:
            if not rep.alive:
                continue
            t = None if deadline is None else \
                max(deadline - time.monotonic(), 0.0)
            ok = rep.drain(timeout=t) and ok
        return ok

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Close every replica (with ``drain``, in-flight work finishes
        first); the cluster is unusable afterwards.  The factor tier
        closes first so no construction lands on a closing driver."""
        if self.metrics is not None:
            # a scrape after close must not walk torn-down replicas
            self.metrics.remove_collect(self._collect)
        if self.factor_tier is not None:
            self.factor_tier.close()
        for rep in self.replicas:
            rep.close(drain=drain, timeout=timeout)
        if self.flight is not None:
            # post-mortem writers run on daemon threads; give in-flight
            # dumps a bounded window to land before the process moves on
            self.flight.flush(timeout=5.0)

    def __enter__(self) -> "SolveCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))
