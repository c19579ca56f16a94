"""Async serving frontend: a background-thread driver over
:class:`SolveEngine` with an asyncio-friendly submit/await API and a
bounded ingress queue with backpressure.

The engine itself is deliberately single-threaded (its lane maps, pin
table and signature counters are plain Python state), so the
frontend owns **one driver thread** that is the only thread ever
touching the engine or its :class:`FactorCache`:

* ``submit()`` validates nothing itself — it enqueues ``(request,
  future)`` onto a bounded ingress deque and wakes the driver.  The
  driver forwards ingress to ``engine.submit`` (validation errors
  resolve the future exceptionally), ticks while the engine is busy,
  and resolves each request's future the moment it retires;
* **backpressure**: when ``ingress + engine queue`` reaches
  ``max_queue``, ``submit`` either blocks until the scheduler drains
  (``overload="block"``) or raises :class:`EngineOverloadedError`
  (``overload="reject"``) — rejected submissions are counted and never
  reach the engine;
* ``await frontend.solve(graph_id, b)`` is the asyncio face: it wraps
  the concurrent future for the running event loop, so a service can
  multiplex thousands of callers over one engine without threads of its
  own;
* ``call(fn, ...)`` runs a callable **on the driver thread** between
  engine rounds — the only safe way for another thread to mutate the
  engine or its cache (a cluster router uses it to factor graphs onto
  this replica);
* a driver-thread crash (engine exception outside per-request
  validation) fails every pending future with the crash recorded in
  ``driver_error`` instead of hanging them; ``alive`` exposes liveness
  to a cluster router's ejection loop.

Results are the engine's: the driver thread runs the same tick loop as
the synchronous ``run_until_drained``, so a request served through the
frontend is **bit-exact** with a direct ``FactorHandle.solve`` of the
same rhs block (tested), whatever the admission policy.

The port's CUDA work therefore runs on the driver thread, not the main
one.  PyTorch's current device is per thread, so the driver enters the
cache's device (``torch.cuda.device``) for its whole life: a cache
pinned to ``cuda:i`` launches on ``cuda:i``.  The kernels' one-time
build at first use is serialized by the runtime's lock, whichever thread
launches first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import torch

from ..obs.flight import NULL_FLIGHT
from ..obs.registry import NULL as _NULL_METRICS
from ..obs.tracing import span

from .engine import EngineStats, SolveEngine, SolveRequest, make_request


class EngineOverloadedError(RuntimeError):
    """Raised by ``submit`` under ``overload="reject"`` when the bounded
    request queue is full (the backpressure signal a load balancer turns
    into HTTP 429 / retry-after)."""


@dataclasses.dataclass
class FrontendStats:
    """Queue-depth and lifecycle counters for the async frontend.
    ``queue_depth``/``queue_peak`` count requests waiting *anywhere*
    before lane admission (frontend ingress + engine queue)."""

    submitted: int
    completed: int
    failed: int
    rejected: int
    queue_depth: int
    queue_peak: int
    max_queue: int
    alive: bool
    control_calls: int
    control_s: float
    factor_queue_depth: int
    engine: EngineStats

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["engine"] = self.engine.as_dict()
        return d


class SolveFrontend:
    """Asyncio-friendly service frontend over a :class:`SolveEngine`.

    ::

        eng = SolveEngine(cache, admission=make_policy("deadline"))
        with SolveFrontend(eng, max_queue=256) as fe:
            res = await fe.solve("grid2d_64", b, deadline_s=0.5)
            # res.x, res.status in {"converged", "deadline_missed", ...}

    ``submit`` / ``submit_request`` return a
    :class:`concurrent.futures.Future` resolving to the completed
    :class:`SolveRequest`; ``solve`` awaits it on the caller's event
    loop.  Thread-safe: any number of producer threads / event loops may
    submit concurrently.

    Args:
        engine: the engine this frontend drives — after construction,
            only the frontend's driver thread may touch it (use
            :meth:`call` for out-of-band work like factoring).
        max_queue: bound on requests waiting anywhere before lane
            admission (ingress + engine queue) — the backpressure
            threshold.
        overload: what a full queue does to ``submit`` — ``"block"``
            stalls the submitter until space frees, ``"reject"`` raises
            :class:`EngineOverloadedError`.
        idle_wait_s: driver-thread sleep between polls when the engine
            is idle (latency floor for a cold first request).
    """

    def __init__(self, engine: SolveEngine, *, max_queue: int = 256,
                 overload: str = "block", idle_wait_s: float = 0.05,
                 metrics=None, flight=None, obs_replica: int = -1):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if overload not in ("block", "reject"):
            raise ValueError("overload must be 'block' or 'reject'")
        self.engine = engine
        self.max_queue = max_queue
        self.overload = overload
        self.idle_wait_s = idle_wait_s
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)    # driver wake-up
        self._space = threading.Condition(self._lock)   # submitter wake-up
        self._ingress: Deque[Tuple[SolveRequest, Future]] = deque()
        self._control: Deque[Tuple[Callable, tuple, dict, Future]] = deque()
        self._futures: Dict[SolveRequest, Future] = {}
        self._closed = False
        self.driver_error: Optional[BaseException] = None
        self._seq = 0
        self.submitted = 0
        self.completed = 0
        self.failed = 0          # futures resolved exceptionally
        self.rejected = 0
        self.queue_peak = 0
        # control-channel visibility: every second the driver spends in
        # `call()` work (factorizations, adopts, compactions) is a second
        # its solve lanes sit frozen — the colocated-vs-disaggregated
        # stall is read straight off these, not inferred from latency
        self.control_calls = 0
        self.control_s = 0.0
        self._control_inflight = 0
        # observability (repro_torch.obs): pre-bound children; no-ops when
        # metrics is None, so the submit/driver paths never branch
        reg = metrics if metrics is not None else _NULL_METRICS
        rep = str(obs_replica) if obs_replica >= 0 else "solo"
        self._m_submitted = reg.counter(
            "repro_frontend_submitted_total", "requests accepted at ingress",
            labels=("replica",)).labels(replica=rep)
        self._m_rejected = reg.counter(
            "repro_frontend_rejected_total",
            "submissions refused by backpressure",
            labels=("replica",)).labels(replica=rep)
        self._m_completed = reg.counter(
            "repro_frontend_completed_total",
            "futures resolved with a finished request",
            labels=("replica",)).labels(replica=rep)
        self._m_failed = reg.counter(
            "repro_frontend_failed_total",
            "futures resolved exceptionally",
            labels=("replica",)).labels(replica=rep)
        self._m_queue = reg.gauge(
            "repro_frontend_queue_depth",
            "requests waiting before lane admission (ingress + engine)",
            labels=("replica",)).labels(replica=rep)
        self._m_control_s = reg.histogram(
            "repro_frontend_control_seconds",
            "driver-thread seconds per control-channel call",
            labels=("replica",)).labels(replica=rep)
        self._flight = flight if flight is not None else NULL_FLIGHT
        self._obs_rep_label = rep
        self._thread = threading.Thread(target=self._run,
                                        name="solve-frontend", daemon=True)
        self._thread.start()

    # -- submission (any thread) --------------------------------------------
    def _depth(self) -> int:
        # ingress + engine queue = requests waiting for a lane; reading
        # len() of the engine deque cross-thread is atomic under the GIL
        # and only feeds backpressure, never engine decisions
        return len(self._ingress) + len(self.engine.queue)

    @property
    def queue_depth(self) -> int:
        """Requests waiting anywhere before lane admission (ingress +
        engine queue) — the same advisory cross-thread read that drives
        backpressure; a cluster router's load signal."""
        return self._depth()

    def submit_request(self, req: SolveRequest) -> "Future[SolveRequest]":
        """Queue a pre-built :class:`SolveRequest`; returns a future that
        resolves to the same (completed) request object on retirement,
        or raises the engine's validation error."""
        fut: "Future[SolveRequest]" = Future()
        with self._work:
            if self._closed:
                raise RuntimeError("submit on a closed SolveFrontend")
            while self._depth() >= self.max_queue:
                if self.overload == "reject":
                    self.rejected += 1
                    self._m_rejected.inc()
                    raise EngineOverloadedError(
                        f"request queue full ({self.max_queue} waiting)")
                self._space.wait(timeout=self.idle_wait_s)
                if self._closed:
                    raise RuntimeError("SolveFrontend closed while "
                                       "blocked on backpressure")
            # pre-stamp submission so queueing delay includes ingress
            # time (the engine keeps a pre-stamped submit_time)
            if req.submit_time == 0.0:
                req.submit_time = self.engine._clock()
            self._ingress.append((req, fut))
            self.submitted += 1
            self._m_submitted.inc()
            depth = self._depth()
            self.queue_peak = max(self.queue_peak, depth)
            self._m_queue.set(depth)
            self._work.notify_all()
        return fut

    def submit(self, graph_id: str, b, *, rid: Optional[int] = None,
               **kw) -> "Future[SolveRequest]":
        """Build and queue a solve request (``b``: ``(n,)`` or
        ``(nrhs, n)``; ``kw`` = ``tol``/``maxiter``/``priority``/
        ``deadline_s``, see :func:`repro_torch.serve.engine.make_request`)."""
        with self._lock:
            self._seq += 1
            auto_rid = self._seq
        return self.submit_request(make_request(
            graph_id, b, rid=rid if rid is not None else auto_rid, **kw))

    async def solve(self, graph_id: str, b, **kw) -> SolveRequest:
        """Asyncio face: ``res = await frontend.solve(gid, b)``."""
        import asyncio
        return await asyncio.wrap_future(self.submit(graph_id, b, **kw))

    # -- control channel (any thread) ---------------------------------------
    def call(self, fn: Callable, *args, **kw) -> "Future[Any]":
        """Run ``fn(*args, **kw)`` **on the driver thread**, between
        engine rounds, returning a future for its result.  This is the
        only safe way for another thread to touch the engine or its
        ``FactorCache`` (e.g. a cluster router factoring a graph onto
        this replica): the driver thread is their sole owner.  ``fn``
        exceptions resolve the future exceptionally; they never kill the
        driver."""
        fut: "Future[Any]" = Future()
        with self._work:
            if self._closed:
                raise RuntimeError("call on a closed SolveFrontend")
            self._control.append((fn, args, kw, fut))
            self._work.notify_all()
        return fut

    @property
    def factor_queue_depth(self) -> int:
        """Control-channel work waiting for (or holding) the driver —
        queued ``call()``s plus the one executing.  Under a colocated
        cluster this is the factorization backlog stalling this
        replica's lanes; with a factor tier it stays near zero (adopts
        are cheap).  Advisory cross-thread read, like ``queue_depth``."""
        return len(self._control) + self._control_inflight

    @property
    def alive(self) -> bool:
        """Driver-thread liveness — the health signal a cluster router
        keys ejection on.  False once the driver crashed (see
        ``driver_error``) or the frontend closed."""
        return (self._thread.is_alive() and self.driver_error is None
                and not self._closed)

    # -- driver thread (sole owner of the engine) ---------------------------
    def _run(self) -> None:
        dev = torch.device(self.engine.cache.device)
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            self._drive()

    def _idle(self) -> bool:
        """Nothing for the driver to do (read under ``_work``)."""
        return not (self._ingress or self._control or self.engine.busy
                    or self._closed)

    def _drive(self) -> None:
        # sole owner of the engine; `_futures` is touched only here
        # (dict get/set/pop are GIL-atomic, so stats/drain may peek)
        eng = self.engine
        while True:
            with self._work:
                if self._idle():
                    with span("frontend.wait"):
                        while self._idle():
                            self._work.wait(timeout=self.idle_wait_s)
                if self._closed:
                    # close(drain=True) already waited for idle; a hard
                    # close abandons in-flight work deliberately
                    break
                batch = list(self._ingress)
                self._ingress.clear()
                control = list(self._control)
                self._control.clear()
                if batch:
                    self._space.notify_all()
            with self._lock:
                self._control_inflight = len(control)
            for fn, args, kw, cfut in control:
                t0 = time.monotonic()
                try:
                    with span("frontend.control"):
                        res = fn(*args, **kw)
                except Exception as exc:
                    if not cfut.done():
                        cfut.set_exception(exc)
                else:
                    if not cfut.done():
                        cfut.set_result(res)
                finally:
                    dt = time.monotonic() - t0
                    # under the stats lock: these are read-modify-writes
                    # racing the `stats()` snapshots router/health threads
                    # take — unlocked, a snapshot could observe
                    # control_calls incremented but control_s stale
                    with self._lock:
                        self.control_calls += 1
                        self.control_s += dt
                        self._control_inflight -= 1
                    self._m_control_s.observe(dt)
            try:
                if batch:
                    with span("frontend.ingress"):
                        self._forward(batch)
                if eng.busy:
                    for done in eng.tick():
                        fut = self._futures.pop(done, None)
                        if fut is None:
                            continue  # submitted directly to the engine,
                            # not through the frontend: not ours to count
                        self.completed += 1
                        self._m_completed.inc()
                        if not fut.done():
                            fut.set_result(done)
                    with self._space:
                        self._space.notify_all()  # lanes freed → drained
            except Exception as exc:
                # a wedged engine must fail fast, not hang every future:
                # record the crash (surfaced as `alive == False` — the
                # router's ejection signal), close, and fall through to
                # the cleanup below so pending futures resolve
                # exceptionally instead of blackholing
                self.driver_error = exc
                self._flight.incident(
                    "driver_crash", replica=self._obs_rep_label,
                    error=repr(exc))
                with self._work:
                    self._closed = True
                    self._work.notify_all()
                    self._space.notify_all()
                break
        # closed (or crashed): fail whatever never completed
        why = ("SolveFrontend closed" if self.driver_error is None
               else f"engine driver crashed: {self.driver_error!r}")
        for req, fut in list(self._futures.items()):
            self.failed += 1
            if not fut.done():
                fut.set_exception(RuntimeError(why))
        self._futures.clear()
        for req, fut in list(self._ingress):
            self.failed += 1
            if not fut.done():
                fut.set_exception(RuntimeError(why))
        self._ingress.clear()
        for fn, args, kw, cfut in list(self._control):
            if not cfut.done():
                cfut.set_exception(RuntimeError(why))
        self._control.clear()

    def _forward(self, batch) -> None:
        """Hand an ingress batch to the engine (driver thread)."""
        for req, fut in batch:
            try:
                self.engine.submit(req)
            except Exception as exc:  # unknown graph / bad shape
                self.failed += 1
                self._m_failed.inc()
                if not fut.done():    # caller may have cancelled
                    fut.set_exception(exc)
            else:
                self._futures[req] = fut

    # -- lifecycle ----------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request has resolved (or timeout;
        returns False on timeout).  The driver keeps running.  Counts,
        not queue emptiness: work the driver holds between ingress and
        engine submission is still pending."""
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        while self.submitted > self.completed + self.failed:
            if deadline is not None and _time.monotonic() > deadline:
                return False
            _time.sleep(0.001)
        return True

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop the driver thread.  With ``drain`` (default) in-flight
        and queued work finishes first; otherwise pending futures fail
        with ``RuntimeError``."""
        if drain:
            self.drain(timeout=timeout)
        with self._work:
            self._closed = True
            self._work.notify_all()
            self._space.notify_all()
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "SolveFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    def stats(self) -> FrontendStats:
        """Point-in-time :class:`FrontendStats` snapshot (nests the
        engine's :class:`EngineStats`); safe from any thread."""
        with self._lock:
            depth = self._depth()
            peak = max(self.queue_peak, depth)
            # read the control pair under the same lock the driver's
            # accumulation holds, so calls/seconds are mutually coherent
            control_calls = self.control_calls
            control_s = self.control_s
            factor_depth = len(self._control) + self._control_inflight
        return FrontendStats(
            submitted=self.submitted, completed=self.completed,
            failed=self.failed, rejected=self.rejected,
            queue_depth=depth, queue_peak=peak,
            max_queue=self.max_queue, alive=self.alive,
            control_calls=control_calls, control_s=control_s,
            factor_queue_depth=factor_depth,
            engine=self.engine.stats())
