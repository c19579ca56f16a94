"""One solve-cluster replica: a **private** ``FactorCache`` (and with it
private ``FactorFleet`` stacks and jitted fleet programs) behind a
``SolveEngine`` + ``SolveFrontend`` driver thread.

The replica is the cluster's unit of isolation and of state: holding a
factor *is* holding device memory, so the router's whole job is to send
a ``graph_id`` where its factor already lives.  All engine/cache
**mutation** goes through the frontend's driver thread — ``factor()``
rides the frontend control channel (``SolveFrontend.call``), so a
router thread never races the driver inside the cache.  The read-only
probes the router needs (``fresh``/``load``/``capacity_probe``) are
plain GIL-atomic reads of host bookkeeping and are safe from any
thread.

In the port a replica's device is a ``torch.device``: its cache's fleet
stacks and lane state live there, and its frontend's driver thread runs
inside ``torch.cuda.device`` of it, so its kernels launch there.  Any
number of replicas may share one card.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Callable, Dict, Optional

import torch

from ...core.solver import FactorCache, FactorHandle
from ..admission import AdmissionPolicy
from ..engine import SolveEngine, SolveRequest
from ..frontend import SolveFrontend


class EngineReplica:
    """``SolveFrontend`` + private ``FactorCache`` as one unit of a
    :class:`~repro_torch.serve.cluster.router.SolveCluster`.

    ``overload`` defaults to ``"reject"`` (unlike a standalone
    frontend's ``"block"``): the router wants the backpressure signal
    immediately so it can spill to another replica instead of stalling
    its submit path on one hot engine.

    ``device`` pins this replica's private cache — its fleet stacks,
    lane carries and the kernels its driver thread launches — to one
    device, so N replicas over N cards scale capacity with device count
    and the router is the only cross-device hop.  Without one the cache
    picks its own (the GPU, or an error where there is none), and
    ``device`` reports where it went.
    """

    def __init__(self, index: int, *, slots: int = 8,
                 iters_per_tick: int = 8,
                 admission: Optional[AdmissionPolicy] = None,
                 max_queue: int = 256, overload: str = "reject",
                 clock: Optional[Callable[[], float]] = None,
                 device: Optional[torch.device] = None,
                 cache_kw: Optional[Dict] = None,
                 metrics=None, tracer=None, flight=None, health=None):
        self.index = index
        kw = dict(cache_kw or {})
        if clock is not None:
            kw.setdefault("clock", clock)
        if device is not None:
            kw.setdefault("device", device)
        if flight is not None:
            kw.setdefault("flight", flight)
        self.cache = FactorCache(**kw)
        self.device = self.cache.device
        self.engine = SolveEngine(self.cache, slots=slots,
                                  iters_per_tick=iters_per_tick,
                                  admission=admission, clock=clock,
                                  metrics=metrics, tracer=tracer,
                                  flight=flight, health=health,
                                  obs_replica=index,
                                  obs_device=str(self.device))
        self.frontend = SolveFrontend(self.engine, max_queue=max_queue,
                                      overload=overload, metrics=metrics,
                                      flight=flight, obs_replica=index)

    # -- read-only probes (any thread) --------------------------------------
    def fresh(self, graph_id: str) -> bool:
        """Resident and not TTL/tick-stale: routable without factoring."""
        return self.cache.fresh(graph_id)

    @property
    def load(self) -> int:
        """Requests waiting anywhere plus lanes in flight — the routing
        load signal.  ``queue_depth`` is the frontend's own backpressure
        read; the lane scan is the same advisory GIL-atomic contract."""
        return (self.frontend.queue_depth
                + sum(l is not None for l in self.engine.lanes))

    def capacity_probe(self) -> Dict[str, Optional[int]]:
        """Free-capacity snapshot of this replica's private cache
        (budget headroom, reusable fleet rows) — what miss placement
        ranks replicas by."""
        return self.cache.capacity_probe()

    @property
    def alive(self) -> bool:
        """Driver-thread liveness (see ``SolveFrontend.alive``) — the
        signal the cluster health loop keys ejection on."""
        return self.frontend.alive

    # -- mutation (driver thread via the control channel) -------------------
    def factor(self, g, key, *, graph_id: str, family: str = "ac",
               precond_params: Optional[Dict] = None,
               ttl_s: Optional[float] = None) -> "Future[FactorHandle]":
        """Factor ``g`` into this replica's private cache **on the
        driver thread**; resolves to the admitted handle.  ``family`` /
        ``precond_params`` select the preconditioner family constructed
        (the router passes the family its placement id encodes);
        ``ttl_s`` carries the hot-replica demotion TTL (``None`` =
        immortal primary placement)."""
        return self.frontend.call(self.cache.factor, g, key,
                                  graph_id=graph_id, family=family,
                                  precond_params=precond_params,
                                  ttl_s=ttl_s)

    def adopt(self, g, f, *, graph_id: str, family: str = "ac",
              schedules=None, construct_s: float = 0.0,
              ttl_s: Optional[float] = None) -> "Future[FactorHandle]":
        """Admit a payload constructed elsewhere (a factor-tier replica)
        into this replica's private cache **on the driver thread** —
        device transfer + fleet-row scatter only, never a factorization,
        so the driver stall is milliseconds where ``factor()`` is
        seconds (the whole point of the factor tier)."""
        return self.frontend.call(self.cache.adopt, g, f,
                                  graph_id=graph_id, family=family,
                                  schedules=schedules,
                                  construct_s=construct_s, ttl_s=ttl_s)

    def submit(self, req: SolveRequest) -> "Future[SolveRequest]":
        """Queue a routed request.  *This* replica's factor is pinned
        on the request first (a non-mutating ``peek``): a TTL expiry or
        LRU eviction while the request sits in the ingress queue must
        not fail it — the engine falls back to the strong ref, exactly
        like its own mid-flight pinning.  The pin is unconditional: an
        overload retry must not carry a previously-tried replica's
        handle here, or the fallback could serve the request out of
        another replica's private fleet."""
        req._handle = self.cache.peek(req.graph_id)
        return self.frontend.submit_request(req)

    # -- lifecycle ----------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until this replica's submitted work resolves (False on
        timeout)."""
        return self.frontend.drain(timeout=timeout)

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop the replica's driver thread (draining first by
        default); pending futures fail once closed."""
        self.frontend.close(drain=drain, timeout=timeout)
