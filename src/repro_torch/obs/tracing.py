"""Per-request lifecycle tracing: span records and Chrome trace export.

A request's wall-clock decomposes into a contiguous partition of
``[submit_time, finish_time]``::

    route          submit .. +route_s          router decision + retries
    factor|adopt   .. +factor_wait_s           cold-path construction wait
    queue          .. admit_time               admission queue (head block)
    first_tick     admit .. first_tick_time    scatter-in + first step call
    solve          first_tick .. finish_time   PCG ticks to convergence

Stages a request never paid (warm hit -> no factor span; engine
recorded no first tick -> solve covers admit..finish) collapse to
nothing rather than to zero-length lies, and because the partition is
contiguous the span durations sum to the reported e2e latency exactly
— the acceptance bound (<= 5%) only absorbs float rounding.

Spans come from stamps the serving layers already cross on the host
side (`SolveRequest.submit_time` / `admit_time` / `finish_time` plus
the new ``route_s`` / ``factor_wait_s`` / ``first_tick_time``), so
tracing adds no device syncs; the engine stamps first ticks only when
a tracer is attached.

Export is Chrome ``trace_event`` JSON (``{"traceEvents": [...]}``,
complete events ``ph="X"``, microsecond ``ts``/``dur``) — loads
directly in ``chrome://tracing`` / Perfetto.  ``pid`` is the replica
(one track group per replica), ``tid`` is the request id (one row per
request), so a request's spans nest on their own row and cross-replica
interleaving is visible at a glance.

Layer spans time the port's own stages (the factor's strict ladder and
its pools, rounds and finalize; a PCG iteration; an engine tick and its
admission) under the one :class:`Tracer` attached to the process
(:func:`attach` / :func:`detach`).  A site is ``with span("parac.pools")
as sp:``; detached, that is one global read returning the shared
:data:`NOOP_SPAN` (no clock, no allocation, no profiler call), and
attributes are set under ``if sp:`` so a detached site builds none.
Attached, a span takes ``time.perf_counter()`` at entry and exit, nests
under the thread's open span (``parent``), and, only while a torch
profiler session runs, also opens a ``record_function`` named
``SPAN_PREFIX + name`` so the profiler's trace holds it on the device
events' clock.  Layer spans export beside the request rows: ``pid`` 0
(the process's engine), ``tid`` the thread; ``repro_torch.launch.serve
--trace-json`` attaches its tracer, so its file holds both.  Only this
port records layer spans.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# The lifecycle stages, in partition order.
STAGES = ("route", "factor", "adopt", "queue", "first_tick", "solve")


# The name prefix of a layer span's profiler annotation.
SPAN_PREFIX = "repro::"

# The most layer spans a tracer keeps; older ones fall off and are counted.
SPAN_CAPACITY = 1 << 20


@dataclass(frozen=True)
class Span:
    """One contiguous stage of a request's lifetime, in the engine
    clock's coordinates (seconds); or a layer span (``sid`` its id,
    ``parent`` the id of the span it nests in, ``tid`` its thread,
    ``attrs`` the counters its site set), on ``time.perf_counter``."""
    name: str
    start: float
    end: float
    sid: int = -1
    parent: Optional[int] = None
    tid: Optional[int] = None
    attrs: Dict[str, object] = field(default_factory=dict, hash=False)

    @property
    def dur_s(self) -> float:
        return max(self.end - self.start, 0.0)


@dataclass
class RequestTrace:
    """The full lifecycle record for one retired request."""
    rid: int
    graph_id: str
    family: str = ""
    policy: str = ""
    status: str = ""
    replica: int = -1
    device: str = ""
    trace_id: str = ""
    spans: List[Span] = field(default_factory=list)
    attrs: Dict[str, object] = field(default_factory=dict)

    @property
    def start(self) -> float:
        return self.spans[0].start if self.spans else 0.0

    @property
    def end(self) -> float:
        return self.spans[-1].end if self.spans else 0.0

    @property
    def e2e_s(self) -> float:
        return max(self.end - self.start, 0.0)

    @property
    def span_sum_s(self) -> float:
        return sum(s.dur_s for s in self.spans)


def trace_from_request(req, *, family: str = "", policy: str = "",
                       replica: int = -1,
                       device: str = "") -> Optional[RequestTrace]:
    """Build a :class:`RequestTrace` from a retired
    :class:`~repro_torch.serve.engine.SolveRequest`'s host-side stamps.
    Returns ``None`` if the request never finished (no partition to
    report)."""
    if req.finish_time <= 0.0 or req.submit_time <= 0.0:
        return None
    t = req.submit_time
    end = req.finish_time
    spans: List[Span] = []

    def push(name: str, lo: float, hi: float) -> float:
        hi = min(max(hi, lo), end)
        if hi > lo:
            spans.append(Span(name, lo, hi))
        return hi

    route_s = getattr(req, "route_s", 0.0)
    factor_s = getattr(req, "factor_wait_s", 0.0)
    mode = getattr(req, "factor_mode", "") or "factor"
    first = getattr(req, "first_tick_time", 0.0)
    admit = req.admit_time if req.admit_time > 0.0 else t

    cur = push("route", t, t + route_s)
    cur = push("adopt" if mode == "adopt" else "factor", cur, cur + factor_s)
    cur = push("queue", cur, max(admit, cur))
    if first > cur:
        cur = push("first_tick", cur, first)
    push("solve", cur, end)

    iters = req.iters
    max_iters = int(max(iters)) if iters is not None and len(iters) else 0
    if replica < 0:
        replica = getattr(req, "replica", -1)
    return RequestTrace(
        rid=req.rid, graph_id=req.graph_id, family=family,
        policy=policy, status=req.status, replica=replica, device=device,
        trace_id=getattr(req, "trace_id", ""),
        spans=spans,
        attrs={"iters": max_iters, "nrhs": req.nrhs,
               "factor_mode": getattr(req, "factor_mode", "") or ""})


class _NoopSpan:
    """What a span site returns with no tracer attached: false, and
    every method a no-op."""
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NOOP_SPAN = _NoopSpan()

_ACTIVE: Optional["Tracer"] = None


def attach(tracer: "Tracer") -> None:
    """Make ``tracer`` the process's: every span site records into it."""
    global _ACTIVE
    _ACTIVE = tracer


def detach() -> None:
    """Stop recording layer spans."""
    global _ACTIVE
    _ACTIVE = None


def span(name: str):
    """A layer span site: the attached tracer's span ``name``, or the
    shared no-op."""
    t = _ACTIVE
    if t is None:
        return NOOP_SPAN
    return _OpenSpan(t, name, {})


_PROFILER = None     # (profiler_enabled, record_function), loaded on use


def _profiler():
    global _PROFILER
    if _PROFILER is None:
        import torch
        from torch.autograd.profiler import record_function
        _PROFILER = (torch._C._autograd._profiler_enabled, record_function)
    return _PROFILER


class _OpenSpan:
    """A layer span between its entry and exit; its record is a
    :class:`Span` once it closes."""
    __slots__ = ("tracer", "name", "attrs", "sid", "parent", "start", "_rf",
                 "_stack")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_OpenSpan":
        t = self.tracer
        try:
            stack = t._local.stack
        except AttributeError:
            stack = t._local.stack = []
        self._stack = stack
        self.parent = stack[-1].sid if stack else None
        self.sid = next(t._ids)
        stack.append(self)
        enabled, record_function = _PROFILER or _profiler()
        if enabled():
            self._rf = record_function(SPAN_PREFIX + self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._stack.pop()
        self.tracer._add((self.name, self.start, end, self.sid, self.parent,
                          threading.get_ident(), self.attrs))
        return False


class Tracer:
    """Thread-safe bounded sink of :class:`RequestTrace` records and of
    layer spans.

    Layers that can emit a trace take ``tracer=None`` and call
    :meth:`record` only when one is attached; the deque bound keeps a
    long replay from hoarding host memory (the oldest traces fall off).
    Layer spans record while the tracer is :func:`attach` ed, into a
    bound of their own (``SPAN_CAPACITY``; ``spans_dropped`` counts what
    fell off).
    """

    def __init__(self, *, capacity: int = 8192):
        self._lock = threading.Lock()
        self._traces: deque = deque(maxlen=capacity)
        self.dropped = 0
        self._seen = 0
        self._spans: deque = deque(maxlen=SPAN_CAPACITY)
        self.spans_dropped = 0
        self._ids = itertools.count(1)
        self._local = threading.local()

    # -- layer spans ----------------------------------------------------------
    def span(self, name: str, **attrs) -> _OpenSpan:
        """A layer span ``name`` recorded here whether or not this tracer
        is the attached one."""
        return _OpenSpan(self, name, attrs)

    def _add(self, rec: tuple) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.spans_dropped += 1
            self._spans.append(rec)

    def layer_spans(self) -> List[Span]:
        """The closed layer spans, in the order they closed."""
        with self._lock:
            recs = list(self._spans)
        return [Span(*r) for r in recs]

    def record(self, trace: Optional[RequestTrace]) -> None:
        if trace is None:
            return
        with self._lock:
            if len(self._traces) == self._traces.maxlen:
                self.dropped += 1
            self._traces.append(trace)
            self._seen += 1

    def traces(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._traces)

    def __len__(self) -> int:
        return len(self._traces)

    # -- Chrome trace_event export -----------------------------------------
    def chrome_events(self) -> List[Dict]:
        """Complete events (``ph="X"``) with µs timestamps relative to
        the earliest span — pid=replica, tid=request id, so spans nest
        per request row under per-replica track groups; layer spans
        (``cat="layer"``) on one row per thread."""
        traces = self.traces()
        layer = self.layer_spans()
        if not traces and not layer:
            return []
        t0 = min([tr.start for tr in traces if tr.spans]
                 + [sp.start for sp in layer])
        events: List[Dict] = []
        named: set = set()
        for tr in traces:
            pid = tr.replica if tr.replica >= 0 else 0
            if pid not in named:
                named.add(pid)
                events.append({
                    "name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name": f"replica {pid}" if tr.replica >= 0
                             else "engine"}})
            for sp in tr.spans:
                events.append({
                    "name": sp.name, "ph": "X", "cat": "request",
                    "pid": pid, "tid": tr.rid,
                    "ts": (sp.start - t0) * 1e6,
                    "dur": sp.dur_s * 1e6,
                    "args": {"rid": tr.rid, "graph_id": tr.graph_id,
                             "trace_id": tr.trace_id,
                             "family": tr.family, "policy": tr.policy,
                             "status": tr.status, "device": tr.device,
                             **tr.attrs}})
        if layer:
            pid = 0           # the process's engine, as a request row's
            if pid not in named:
                events.append({"name": "process_name", "ph": "M",
                               "pid": pid, "args": {"name": "engine"}})
            names = {th.ident: th.name for th in threading.enumerate()}
            for tid in sorted({sp.tid for sp in layer}):
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": names.get(tid, str(tid))}})
            for sp in layer:
                events.append({
                    "name": sp.name, "ph": "X", "cat": "layer", "pid": pid,
                    "tid": sp.tid, "ts": (sp.start - t0) * 1e6,
                    "dur": sp.dur_s * 1e6, "args": dict(sp.attrs)})
        return events

    def export_chrome(self, path: str) -> int:
        """Write ``{"traceEvents": [...]}`` JSON; returns the event
        count (0 writes an empty-but-valid file)."""
        events = self.chrome_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
        return len(events)

    # -- aggregate reads ----------------------------------------------------
    def stage_seconds(self) -> Dict[str, float]:
        """Total seconds spent per stage across recorded traces — the
        construct-vs-serve attribution the selector and reports read."""
        out: Dict[str, float] = {}
        for tr in self.traces():
            for sp in tr.spans:
                out[sp.name] = out.get(sp.name, 0.0) + sp.dur_s
        return out

    def stats(self) -> Dict[str, object]:
        with self._lock:
            n, dropped = len(self._traces), self.dropped
            seen = self._seen
        return {"recorded": n, "seen": seen, "dropped": dropped,
                "stage_s": self.stage_seconds()}
