"""Flight recorder: a bounded ring of typed structured events with
post-mortem dumps on incidents.

The metrics registry answers "how much / how fast"; the flight
recorder answers "what happened, in what order" when something breaks.
Serving layers record typed events — ``admit``, ``retire``, ``evict``,
``adopt``, ``compaction``, ``eject``/``readmit``, ``failover``,
``detector_transition`` — into one thread-safe ring buffer, stamped
with the request's ``rid``/``trace_id`` so a dump cross-references the
Chrome trace (``--trace-json``) row for row.

Hook pattern matches ``metrics=``/``tracer=``: layers take
``flight=None`` and substitute :data:`NULL_FLIGHT`; call sites
pre-bind event kinds once at construction (:meth:`FlightRecorder.bind`
returns a callable ``_BoundEvent``) so the hot path pays one dict
build + one lock acquire per event and never a branch on "is the
recorder on".  Nothing here touches the device.

**Incidents** — a driver crash, a replica ejection, a sustained-
overload flip, or a configurable SLO-miss streak — trigger a
**post-mortem dump**: JSONL of the last ``dump_events`` events plus a
``ClusterStats`` snapshot and a registry sample, written to
``postmortem_dir``.  The dump runs on a short-lived daemon thread:
incidents are detected *under* serving locks (the router ejects inside
the cluster lock; ``SolveCluster.stats()`` takes that same lock), so
the trigger path only snapshots the ring under the recorder lock and
defers the stats/registry/file work.  :meth:`flush` joins outstanding
dump threads (tests and launchers call it before asserting/exiting);
``max_dumps`` bounds a crash loop's disk damage.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional


class _BoundEvent:
    """A pre-bound event emitter: kind + static labels frozen at bind
    time, per-event fields merged in ``__call__``.  One of these per
    (call site, kind) lives for the recorder's lifetime."""

    __slots__ = ("_rec", "_kind", "_static")

    def __init__(self, rec: "FlightRecorder", kind: str, static: Dict):
        self._rec = rec
        self._kind = kind
        self._static = static

    def __call__(self, **fields) -> None:
        self._rec._record(self._kind, self._static, fields)


class _NullEvent:
    __slots__ = ()

    def __call__(self, **fields) -> None:
        pass


_NULL_EVENT = _NullEvent()


class NullFlight:
    """Inert recorder: binds no-op events, drops records, never dumps.
    Layers hold this when ``flight=None`` so instrumented code stays
    branch-free (same contract as the NULL metrics registry)."""

    def bind(self, kind: str, **static) -> _NullEvent:
        return _NULL_EVENT

    def record(self, kind: str, **fields) -> None:
        pass

    def incident(self, reason: str, **context) -> None:
        return None

    def dump(self, reason: str, **context) -> Optional[str]:
        return None

    def attach(self, *, stats_fn=None, registry=None) -> None:
        pass

    def flush(self, timeout: Optional[float] = None) -> bool:
        return True

    def events(self, last: Optional[int] = None) -> List[Dict]:
        return []

    def stats(self) -> Dict[str, object]:
        return {"recorded": 0, "dropped": 0, "incidents": 0, "dumps": 0}


NULL_FLIGHT = NullFlight()


def _registry_series(registry) -> Dict[str, Dict[str, object]]:
    """Compact one-line-able snapshot of every registered series:
    ``{metric: {"{a=b}": value | {"count": n, "sum": s}}}``."""
    out: Dict[str, Dict[str, object]] = {}
    for m in registry.collect():
        series: Dict[str, object] = {}
        for key, child in m.children():
            lbl = "{" + ",".join(
                f"{n}={v}" for n, v in zip(m.label_names, key)) + "}" \
                if key else ""
            snap = child.snapshot()
            if isinstance(snap, tuple):          # histogram
                total, s, _counts = snap
                series[lbl] = {"count": total, "sum": s}
            else:
                series[lbl] = snap
        out[m.name] = series
    return out


class FlightRecorder:
    """Thread-safe bounded ring buffer of typed structured events.

    Args:
        capacity: ring size; the oldest events fall off (counted as
            ``dropped``) — the recorder must never hoard host memory.
        postmortem_dir: where incident dumps land (``None`` disables
            dumping; events still record and :meth:`events` still
            answers).
        dump_events: how many trailing events a dump carries.
        slo_miss_streak: ``N`` consecutive ``retire`` events with
            ``status="deadline_missed"`` raise an ``slo_miss_streak``
            incident (``None`` disables the trigger).
        max_dumps: incident-dump cap per recorder lifetime (a crash
            loop must not fill the disk); explicit :meth:`dump` calls
            are not capped.
        clock: injectable event timestamp source (tests); defaults to
            ``time.perf_counter`` — the serving layers' clock, so event
            ``t`` joins request lifecycle stamps directly.
    """

    def __init__(self, *, capacity: int = 4096,
                 postmortem_dir: Optional[str] = None,
                 dump_events: int = 512,
                 slo_miss_streak: Optional[int] = None,
                 max_dumps: int = 8,
                 clock: Optional[Callable[[], float]] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.postmortem_dir = postmortem_dir
        self.dump_events = dump_events
        self.max_dumps = max_dumps
        self._slo_miss_streak = slo_miss_streak
        self._clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._seq = 0
        self._slo_streak = 0
        self.recorded = 0
        self.dropped = 0
        self.incidents = 0
        self.dumps = 0
        self.dump_errors = 0
        self.dump_paths: List[str] = []
        self._stats_fn: Optional[Callable[[], Dict]] = None
        self._registry = None
        self._gauges = None
        self._threads_lock = threading.Lock()
        self._dump_threads: List[threading.Thread] = []

    # -- wiring --------------------------------------------------------------
    def attach(self, *, stats_fn: Optional[Callable[[], Dict]] = None,
               registry=None) -> None:
        """Late-bind the incident-dump context: ``stats_fn`` (e.g.
        ``lambda: cluster.stats().as_dict()``) and the metrics registry
        to sample.  Both are called on the dump thread, never under
        serving locks held by the trigger."""
        if stats_fn is not None:
            self._stats_fn = stats_fn
        if registry is not None:
            self._registry = registry
            if self._gauges is None:
                self._gauges = {
                    "recorded": registry.gauge(
                        "repro_flight_events",
                        "events recorded by the flight recorder"),
                    "dropped": registry.gauge(
                        "repro_flight_dropped",
                        "events aged off the flight-recorder ring"),
                    "incidents": registry.gauge(
                        "repro_flight_incidents",
                        "incidents (crash/eject/overload/SLO-streak) "
                        "seen by the flight recorder"),
                    "dumps": registry.gauge(
                        "repro_flight_dumps",
                        "post-mortem dumps written"),
                }
                registry.on_collect(self._collect_gauges)

    def _collect_gauges(self, reg) -> None:
        st = self.stats()
        for key, g in self._gauges.items():
            g.set(float(st[key]))

    def bind(self, kind: str, **static) -> _BoundEvent:
        """Pre-bind an event kind plus static fields (replica index,
        component name) — the off-hot-path half of every call site."""
        return _BoundEvent(self, kind, dict(static))

    # -- recording -----------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """One-shot record (cold call sites); hot paths use a bound
        event from :meth:`bind` instead."""
        self._record(kind, None, fields)

    def _record(self, kind: str, static: Optional[Dict],
                fields: Dict) -> None:
        streak_hit = None
        with self._lock:
            self._seq += 1
            ev: Dict[str, object] = {"seq": self._seq,
                                     "t": self._clock(), "kind": kind}
            if static:
                ev.update(static)
            if fields:
                ev.update(fields)
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)
            self.recorded += 1
            if self._slo_miss_streak is not None and kind == "retire":
                if fields.get("status") == "deadline_missed":
                    self._slo_streak += 1
                    if self._slo_streak >= self._slo_miss_streak:
                        streak_hit = self._slo_streak
                        self._slo_streak = 0
                else:
                    self._slo_streak = 0
        if streak_hit is not None:
            self.incident("slo_miss_streak", streak=streak_hit)

    # -- incidents and dumps -------------------------------------------------
    def incident(self, reason: str, **context) -> None:
        """Record an ``incident`` event and (when a ``postmortem_dir``
        is configured and the dump cap has room) write a post-mortem on
        a daemon thread.  Safe to call under serving locks: only the
        ring snapshot happens synchronously."""
        self._record("incident", {"reason": reason}, context)
        with self._lock:
            self.incidents += 1
            if self.postmortem_dir is None or self.dumps >= self.max_dumps:
                return
            self.dumps += 1
            n = self.dumps
            snapshot = list(self._events)[-self.dump_events:]
            rec_stats = self._stats_locked()
        path = self._dump_path(n, reason)
        th = threading.Thread(
            target=self._write_dump,
            args=(path, reason, context, snapshot, rec_stats),
            name="flight-postmortem", daemon=True)
        with self._threads_lock:
            self._dump_threads.append(th)
        th.start()

    def dump(self, reason: str, **context) -> Optional[str]:
        """Synchronous dump (benches, bug reports): writes immediately
        on the calling thread and returns the path.  Do not call under
        a lock that :attr:`attach`'s ``stats_fn`` needs."""
        with self._lock:
            if self.postmortem_dir is None:
                return None
            self.dumps += 1
            n = self.dumps
            snapshot = list(self._events)[-self.dump_events:]
            rec_stats = self._stats_locked()
        path = self._dump_path(n, reason)
        self._write_dump(path, reason, context, snapshot, rec_stats)
        return path

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Join outstanding dump threads; returns ``False`` if any is
        still writing at the timeout."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        with self._threads_lock:
            pending = list(self._dump_threads)
        ok = True
        for th in pending:
            t = None if deadline is None else \
                max(deadline - time.monotonic(), 0.0)
            th.join(timeout=t)
            ok = ok and not th.is_alive()
        with self._threads_lock:
            self._dump_threads = [t for t in self._dump_threads
                                  if t.is_alive()]
        return ok

    def _dump_path(self, n: int, reason: str) -> str:
        safe = re.sub(r"[^A-Za-z0-9_.-]+", "_", reason)[:40] or "incident"
        return os.path.join(self.postmortem_dir,
                            f"postmortem-{n:03d}-{safe}.jsonl")

    def _write_dump(self, path: str, reason: str, context: Dict,
                    snapshot: List[Dict], rec_stats: Dict) -> None:
        # a failing post-mortem must never take serving down with it —
        # errors are counted, not raised
        try:
            os.makedirs(self.postmortem_dir, exist_ok=True)
            lines = [json.dumps(
                {"type": "incident", "reason": reason,
                 "wall_time": time.time(), "context": context,
                 "recorder": rec_stats}, default=str)]
            for ev in snapshot:
                lines.append(json.dumps({"type": "event", **ev},
                                        default=str))
            if self._stats_fn is not None:
                try:
                    st = self._stats_fn()
                except Exception as exc:
                    st = {"error": repr(exc)}
                lines.append(json.dumps(
                    {"type": "cluster_stats", "stats": st}, default=str))
            if self._registry is not None:
                try:
                    series = _registry_series(self._registry)
                except Exception as exc:
                    series = {"error": repr(exc)}
                lines.append(json.dumps(
                    {"type": "metrics", "series": series}, default=str))
            with open(path, "w") as fh:
                fh.write("\n".join(lines) + "\n")
            with self._lock:
                self.dump_paths.append(path)
        except Exception:
            with self._lock:
                self.dump_errors += 1

    # -- reads ---------------------------------------------------------------
    def events(self, last: Optional[int] = None) -> List[Dict]:
        """Snapshot of the ring (oldest first); ``last`` trims to the
        trailing N."""
        with self._lock:
            evs = list(self._events)
        return evs[-last:] if last is not None else evs

    def _stats_locked(self) -> Dict[str, object]:
        return {"recorded": self.recorded, "dropped": self.dropped,
                "capacity": self.capacity, "incidents": self.incidents,
                "dumps": self.dumps, "dump_errors": self.dump_errors,
                "dump_paths": list(self.dump_paths),
                "slo_streak": self._slo_streak}

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return self._stats_locked()
