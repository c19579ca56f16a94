"""Dedicated factor tier: construction replicas that own no solve lanes.

Colocated clusters factor on the serving replica's driver thread
(``SolveFrontend.call``), freezing that replica's solve lanes for the
whole construction — seconds of ``control_s`` per cold graph.  This
module disaggregates the two phases the way LLM serving stacks split
prefill from decode (vLLM production-stack's disaggregated prefill
orchestration): a :class:`FactorTier` owns K :class:`FactorReplica`
worker threads, each pinned to its own device, draining one
cluster-level factor queue.  Solve replicas keep serving; the only
construction work that ever touches a serving driver thread is the
cheap ``FactorCache.adopt`` — device transfer + fleet-row scatter.

Three tier-level economies the colocated path cannot express:

* **Coalescing** — pending AC jobs (the batched-construction family)
  are drained together into one ``factorize_batched`` call, so a burst
  of N cold tenants pays one mega-batched wavefront program instead of
  N sequential ones (``parac`` buckets mixed shapes internally).
  Schedules derive in the same batch (``with_schedules=True``), so the
  serving replica never runs a schedule build either.
* **Dedup** — concurrent jobs for the same placement id ride one
  construction: later arrivals become *siblings* of the in-flight job
  and receive their own adoption of the shared payload (a hot graph
  being replicated to two solve replicas factors once, adopts twice).
* **Failover** — if the placement-target solve replica dies between
  enqueue and adoption, the finished payload is re-targeted through the
  cluster's ``on_retarget`` callback (which moves the router placement
  under the cluster lock) instead of dying with the driver it was
  aimed at.

The tier constructs with the same ``chunk``/``fill_slack``/``strict``
parameters as the serving caches, so an adopted factor is bit-identical
to what a colocated construction would have produced — the cluster's
bit-exactness invariant survives disaggregation (acceptance-tested).

In the port each worker pins its construction with ``device=`` (the
engine's tensors, the schedules following the factor's device) and runs
inside ``torch.cuda.device`` of a CUDA device, as a frontend's driver
does.  Before shipping a payload the worker waits for its stream: the
adoption reads the factor on another thread.
"""
from __future__ import annotations

import contextlib

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ...core.ref_ac import DeviceFactor
from ...core.parac import factorize_batched
from ...core.solver import get_family
from ...core.trisolve import build_schedules_batched
from ...obs.flight import NULL_FLIGHT
from ...obs.registry import NULL as _NULL_METRICS

from .replica import EngineReplica


class FactorJob:
    """One queued construction: placement id, graph payload, and the
    solve replica the finished factor must be adopted onto.  ``future``
    resolves to the adopted handle (the same contract as
    ``EngineReplica.factor`` — the router stores it as the pending
    placement).  ``siblings`` are deduped later arrivals for the same
    placement id, each wanting its own adoption target."""

    __slots__ = ("gid", "g", "key", "family", "params", "ttl_s",
                 "target", "future", "siblings", "enqueue_t")

    def __init__(self, gid: str, g, key, *, family: str, params: Dict,
                 ttl_s: Optional[float], target: EngineReplica,
                 enqueue_t: float):
        self.gid = gid
        self.g = g
        self.key = key
        self.family = family
        self.params = dict(params or {})
        self.ttl_s = ttl_s
        self.target = target
        self.future: "Future" = Future()
        self.siblings: List["FactorJob"] = []
        self.enqueue_t = enqueue_t

    @property
    def coalescable(self) -> bool:
        # only the default-parameter AC construction goes through
        # factorize_batched; parameterized/deterministic families
        # construct singly (still off the serving driver)
        return self.family == "ac" and not self.params


class FactorReplica(threading.Thread):
    """One tier worker: drains the shared queue, constructs on its own
    pinned device, ships adoptions.  Crashing on one job fails that
    job's futures and keeps draining — a poisoned graph must not wedge
    the whole tier."""

    def __init__(self, index: int, tier: "FactorTier",
                 device: Optional[torch.device]):
        super().__init__(name=f"factor-replica-{index}", daemon=True)
        self.index = index
        self.tier = tier
        self.device = device
        self.factored = 0        # constructions completed
        self.batches = 0         # construction calls issued
        self.coalesced = 0       # constructions that shared a batch
        self.adoptions = 0       # adoptions shipped (incl. siblings)
        self.failovers = 0       # adoptions re-targeted off a dead replica
        self.factor_s = 0.0      # construction wall-clock on this worker
        self.start()

    # -- construction -------------------------------------------------------
    def _construct(self, batch: List[FactorJob]) -> List[tuple]:
        """Build every job's payload (and schedules where derivable) on
        this worker's device.  Coalescable batches go through one
        ``factorize_batched``; singles through the family builder."""
        t = self.tier
        if len(batch) > 1 or (batch[0].coalescable and len(batch) == 1):
            fs, scheds = factorize_batched(
                [j.g for j in batch],
                np.stack([np.asarray(j.key, np.uint32) for j in batch]),
                chunk=t.chunk, fill_slack=t.fill_slack, strict=t.strict,
                max_retries=t.max_retries, dtype=t.dtype,
                with_schedules=True, device=self.device)
            return list(zip(fs, scheds))
        job = batch[0]
        fam = get_family(job.family)
        kw = dict(job.params)
        if job.family == "ac":
            kw.setdefault("chunk", t.chunk)
            kw.setdefault("fill_slack", t.fill_slack)
            kw.setdefault("strict", t.strict)
            kw.setdefault("max_retries", t.max_retries)
            kw.setdefault("device", self.device)
        f = fam.build(job.g, job.key, dtype=t.dtype, **kw)
        sch = None
        if fam.kind == "factor" and isinstance(f, DeviceFactor):
            # the schedules follow the factor's device
            sch = build_schedules_batched([f])[0]
        return [(f, sch)]

    # -- adoption (with dead-target failover) -------------------------------
    def _ship(self, job: FactorJob, f, sch, construct_s: float) -> None:
        target = job.target
        attempts = 0
        while True:
            t_a0 = time.perf_counter()
            try:
                handle = target.adopt(
                    job.g, f, graph_id=job.gid, family=job.family,
                    schedules=sch, construct_s=construct_s,
                    ttl_s=job.ttl_s).result()
            except Exception as exc:
                if target.alive:
                    # genuine adopt failure (budget, bad payload):
                    # surface it — the router drops the placement
                    if not job.future.done():
                        job.future.set_exception(exc)
                    return
                attempts += 1
                retarget = self.tier._on_retarget
                newt = (retarget(job.gid, target.index, job.future)
                        if retarget is not None
                        and attempts <= self.tier.max_failovers else None)
                if newt is None:
                    if not job.future.done():
                        job.future.set_exception(RuntimeError(
                            f"factor target replica {target.index} died "
                            f"and no healthy failover target remains "
                            f"for {job.gid!r}"))
                    return
                self.failovers += 1
                with self.tier._lock:
                    self.tier.failovers += 1
                self.tier._ev_failover(gid=job.gid, dead=target.index,
                                       new=newt.index)
                target = newt
                continue
            self.adoptions += 1
            self.tier._m_adopt_s.observe(time.perf_counter() - t_a0)
            self.tier._m_adoptions.inc()
            with self.tier._lock:
                self.tier.adoptions += 1
            if not job.future.done():
                job.future.set_result(handle)
            return

    # -- the drain loop -----------------------------------------------------
    def run(self) -> None:
        dev = self.device
        with (torch.cuda.device(dev) if dev is not None
              and dev.type == "cuda" else contextlib.nullcontext()):
            self._drain()

    def _drain(self) -> None:
        tier = self.tier
        while True:
            batch = tier._take_batch()
            if batch is None:
                return
            t0 = time.perf_counter()
            try:
                payloads = self._construct(batch)
                if self.device is not None and self.device.type == "cuda":
                    # the adopting driver thread reads these tensors
                    torch.cuda.current_stream(self.device).synchronize()
            except Exception as exc:
                for job in batch:
                    victims = [job]
                    while True:
                        sibs = tier._finish(job)
                        if not sibs:
                            break
                        victims.extend(sibs)
                    for j in victims:
                        if not j.future.done():
                            j.future.set_exception(exc)
                continue
            dt = time.perf_counter() - t0
            self.factor_s += dt
            tier._m_construct_s.observe(dt)
            self.batches += 1
            self.factored += len(batch)
            if len(batch) > 1:
                self.coalesced += len(batch)
                with tier._lock:
                    tier.coalesced_factorizations += len(batch)
            per_job_s = dt / len(batch)
            for job, (f, sch) in zip(batch, payloads):
                self._ship(job, f, sch, per_job_s)
                # siblings deduped onto this job adopt the same payload
                # (possibly onto other replicas); drain until none race in
                while True:
                    sibs = tier._finish(job)
                    if not sibs:
                        break
                    for sib in sibs:
                        self._ship(sib, f, sch, 0.0)

    def stats(self) -> Dict:
        return dict(index=self.index, alive=self.is_alive(),
                    device=(str(self.device) if self.device is not None
                            else None),
                    factored=self.factored, batches=self.batches,
                    coalesced=self.coalesced, adoptions=self.adoptions,
                    failovers=self.failovers, factor_s=self.factor_s)


class FactorTier:
    """K construction workers over one shared factor queue.

    Args:
        replicas: worker-thread count.
        devices: per-worker ``torch.device`` pinning (``None`` entries
            leave the construction on the engine's default device, the
            GPU).
        chunk / fill_slack / strict / max_retries / dtype: construction
            parameters — must match the serving caches' so adopted
            factors are bit-identical to colocated ones.
        max_batch: coalescing cap per ``factorize_batched`` call.
        max_failovers: adoption re-target bound per job (a dead cluster
            must fail the future, not spin).
        on_retarget: ``(gid, dead_index, future) -> EngineReplica|None``
            — the cluster's placement-moving callback (runs under the
            cluster lock; returns the new target or ``None`` when no
            healthy replica remains).
    """

    def __init__(self, replicas: int = 1, *,
                 devices: Optional[Sequence[Optional[torch.device]]] = None,
                 chunk: int = 64, fill_slack: int = 32,
                 strict: bool = True, max_retries: int = 3,
                 dtype=np.float32, max_batch: int = 16,
                 max_failovers: int = 8,
                 on_retarget: Optional[Callable] = None,
                 metrics=None, flight=None):
        if replicas < 1:
            raise ValueError("factor tier needs >= 1 replica")
        self.chunk = chunk
        self.fill_slack = fill_slack
        self.strict = strict
        self.max_retries = max_retries
        self.dtype = dtype
        self.max_batch = max_batch
        self.max_failovers = max_failovers
        self._on_retarget = on_retarget
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: Deque[FactorJob] = deque()
        # gid -> in-flight job (queued or constructing): the dedup map.
        # Entries leave only via _finish, after adoption — a late twin
        # arriving mid-construction still rides the shared payload.
        self._pending: Dict[str, FactorJob] = {}
        self._inflight = 0
        self._closed = False
        self.enqueued = 0
        self.dedups = 0
        self.adoptions = 0
        self.failovers = 0
        self.coalesced_factorizations = 0
        # observability (repro_torch.obs): tier-level instruments shared by
        # the workers — no-ops when metrics is None
        reg = metrics if metrics is not None else _NULL_METRICS
        self._m_enqueued = reg.counter(
            "repro_factor_tier_enqueued_total",
            "constructions queued on the factor tier")
        self._m_dedups = reg.counter(
            "repro_factor_tier_dedups_total",
            "placements that rode an in-flight construction")
        self._m_adoptions = reg.counter(
            "repro_factor_tier_adoptions_total",
            "factor payloads shipped to solve replicas")
        self._m_construct_s = reg.histogram(
            "repro_factor_tier_construct_seconds",
            "construction wall seconds per batch on a tier worker")
        self._m_adopt_s = reg.histogram(
            "repro_factor_tier_adopt_seconds",
            "adopt round-trip seconds per shipped payload")
        fl = flight if flight is not None else NULL_FLIGHT
        self._ev_failover = fl.bind("failover")
        self.workers = [
            FactorReplica(i, self,
                          devices[i] if devices is not None else None)
            for i in range(replicas)]

    # -- producer side (router / cluster threads) ---------------------------
    def submit(self, gid: str, g, key, *, family: str = "ac",
               precond_params: Optional[Dict] = None,
               ttl_s: Optional[float] = None,
               target: EngineReplica) -> "Future":
        """Queue a construction for ``gid`` destined for ``target``;
        returns the future the router stores as the pending placement
        (resolves to the adopted handle).  A job for the same ``gid``
        already in flight dedupes: this call rides its construction and
        only pays its own adoption."""
        with self._work:
            if self._closed:
                raise RuntimeError("submit on a closed FactorTier")
            job = FactorJob(gid, g, key, family=family,
                            params=precond_params, ttl_s=ttl_s,
                            target=target, enqueue_t=time.monotonic())
            prior = self._pending.get(gid)
            if prior is not None:
                prior.siblings.append(job)
                self.dedups += 1
                self._m_dedups.inc()
                return job.future
            self._pending[gid] = job
            self._queue.append(job)
            self.enqueued += 1
            self._m_enqueued.inc()
            self._work.notify()
        return job.future

    @property
    def queue_depth(self) -> int:
        """Constructions queued or in flight on a worker — the tier's
        backlog signal (advisory cross-thread read)."""
        return len(self._queue) + self._inflight

    # -- worker side --------------------------------------------------------
    def _take_batch(self) -> Optional[List[FactorJob]]:
        """Block for work; returns a head job plus any coalescable
        pending jobs (one ``factorize_batched`` worth), or ``None`` on
        close."""
        with self._work:
            while not self._queue and not self._closed:
                self._work.wait(timeout=0.05)
            if not self._queue:
                return None          # closed and drained
            head = self._queue.popleft()
            batch = [head]
            if head.coalescable:
                keep = deque()
                while self._queue and len(batch) < self.max_batch:
                    j = self._queue.popleft()
                    if j.coalescable:
                        batch.append(j)
                    else:
                        keep.append(j)
                while keep:
                    self._queue.appendleft(keep.pop())
            self._inflight += len(batch)
            return batch

    def _finish(self, job: FactorJob) -> List[FactorJob]:
        """Drain ``job``'s deduped siblings; once none remain, retire
        its dedup entry (and its in-flight count).  Called repeatedly
        until it returns empty — a twin racing in mid-adoption is still
        picked up."""
        with self._lock:
            sibs = job.siblings
            if sibs:
                job.siblings = []
                return sibs
            if self._pending.get(job.gid) is job:
                del self._pending[job.gid]
            self._inflight -= 1
            return []

    # -- telemetry / lifecycle ----------------------------------------------
    def stats(self) -> Dict:
        with self._lock:
            return dict(
                replicas=len(self.workers),
                factor_queue_depth=self.queue_depth,
                enqueued=self.enqueued, dedups=self.dedups,
                adoptions=self.adoptions, failovers=self.failovers,
                coalesced_factorizations=self.coalesced_factorizations,
                factor_s=sum(w.factor_s for w in self.workers),
                per_replica=[w.stats() for w in self.workers])

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Stop the workers once the queue drains; queued-but-unstarted
        jobs after the timeout fail their futures."""
        with self._work:
            self._closed = True
            self._work.notify_all()
        for w in self.workers:
            w.join(timeout=timeout)
        with self._lock:
            leftovers = list(self._queue)
            self._queue.clear()
        for job in leftovers:
            for j in [job] + job.siblings:
                if not j.future.done():
                    j.future.set_exception(
                        RuntimeError("FactorTier closed"))
