"""Thread-safe metrics registry with a ring-buffered time-series view.

Every serving layer (engine tick loop, frontend ingress, cluster
router, factor tier, cache) binds its instruments against one
:class:`MetricsRegistry` so the whole stack is scrapable behind a
single endpoint (:mod:`repro_torch.obs.prometheus`) and queryable as time
series (windowed counter rates, gauge stats, histogram quantiles) —
the signal the overload detector and the ROADMAP's autoscaling path
consume.

Design constraints, in order:

* **off-hot-path** — an instrument update is one uncontended lock
  acquire and a float add; call sites pre-bind children
  (``self._m_ticks = reg.counter(...)`` once, ``.inc()`` per tick) and
  pass :data:`NULL` when observability is off, so the uninstrumented
  path stays free (the serve bench gates instrumented ticks/s at
  >= 0.98x uninstrumented);
* **bounded label cardinality** — each metric caps its label sets
  (default 64) and *raises* :class:`CardinalityError` past the cap:
  an unbounded label (per-request id, per-graph fingerprint) is a
  memory leak and a scrape bomb, and failing loudly at the offending
  call site beats silently dropping series.  Label values must come
  from bounded sets (replica index, family, policy, status);
* **explicit sampling** — the ring buffer advances only when a caller
  already on a host-side boundary invokes :meth:`sample` /
  :meth:`maybe_sample` with *its* clock (injectable everywhere else in
  the repo, so here too).  No background thread, no device syncs.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .histogram import (DEFAULT_LATENCY_BUCKETS_S, bucket_index,
                        quantile_from_counts)


class CardinalityError(ValueError):
    """A metric was asked for more label sets than its cap — an
    unbounded label (request id, graph fingerprint) leaked into the
    label schema.  Raised at the offending ``labels()`` call."""


# ---------------------------------------------------------------------------
# Children: the per-label-set value holders (the hot-path objects)
# ---------------------------------------------------------------------------

class _CounterChild:
    """Monotonic float counter.  ``inc`` is a lock-guarded
    read-modify-write: GIL scheduling can preempt between the read and
    the write, so bare ``+=`` from N threads loses updates."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._v += v

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self):
        return self._v


class _GaugeChild:
    """Last-write-wins float gauge (queue depth, active lanes)."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)        # single store: GIL-atomic

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._v += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self):
        return self._v


class _HistogramChild:
    """Fixed-bucket histogram: per-bucket counts + running sum.  The
    bucket bounds live on the parent metric (shared, immutable)."""

    __slots__ = ("_lock", "_bounds", "counts", "total", "sum")

    def __init__(self, bounds: Sequence[float]):
        self._lock = threading.Lock()
        self._bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        i = bucket_index(self._bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.total += 1
            self.sum += v

    def snapshot(self) -> Tuple[int, float, Tuple[int, ...]]:
        with self._lock:
            return (self.total, self.sum, tuple(self.counts))

    def quantile(self, q: float) -> float:
        """Lifetime quantile estimate from the live bucket counts."""
        return quantile_from_counts(self._bounds, self.snapshot()[2], q)


# ---------------------------------------------------------------------------
# Metrics: name + label schema + children
# ---------------------------------------------------------------------------

class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (), *,
                 max_series: int = 64):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self.max_series = max_series
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        self._default = None
        if not self.label_names:
            self._default = self._new_child()
            self._children[()] = self._default

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        """Child for one label-value set (created on first use; cached
        after — pre-bind at construction time, not per update).  Raises
        :class:`CardinalityError` past ``max_series`` label sets."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if len(self._children) >= self.max_series:
                        raise CardinalityError(
                            f"metric {self.name!r} exceeded its label-"
                            f"cardinality cap ({self.max_series} series); "
                            f"label values must come from a bounded set "
                            f"(offending set: "
                            f"{dict(zip(self.label_names, key))})")
                    child = self._children[key] = self._new_child()
        return child

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, v: float = 1.0) -> None:
        self._default.inc(v)

    @property
    def value(self) -> float:
        return self._default.value


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._default.set(v)

    def inc(self, v: float = 1.0) -> None:
        self._default.inc(v)

    def dec(self, v: float = 1.0) -> None:
        self._default.dec(v)

    @property
    def value(self) -> float:
        return self._default.value


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", label_names=(), *,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                 max_series: int = 64):
        self.buckets = tuple(buckets)
        super().__init__(name, help, label_names, max_series=max_series)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self._default.observe(v)

    def quantile(self, q: float) -> float:
        return self._default.quantile(q)


# ---------------------------------------------------------------------------
# Null objects: the zero-overhead "observability off" path
# ---------------------------------------------------------------------------

class _NullChild:
    __slots__ = ()

    def inc(self, v=1.0):
        pass

    def dec(self, v=1.0):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    value = 0.0

    def quantile(self, q):
        return 0.0

    def snapshot(self):
        return 0.0

    def labels(self, **kv):
        return self


class NullRegistry:
    """Registry-shaped no-op.  Instrumented call sites hold real
    instrument objects either way, so the hot path never branches on
    "is observability on" — it just calls a method that does nothing.
    Use the shared :data:`NULL` singleton."""

    _child = _NullChild()

    def counter(self, name, help="", labels=(), **kw):
        return self._child

    def gauge(self, name, help="", labels=(), **kw):
        return self._child

    def histogram(self, name, help="", labels=(), **kw):
        return self._child

    def on_collect(self, fn):
        pass

    def remove_collect(self, fn):
        pass

    def sample(self, now):
        pass

    def maybe_sample(self, now):
        pass

    def series(self, name, labels=None):
        return []

    def rate(self, name, *, window_s, now=None, labels=None):
        return 0.0

    def gauge_stats(self, name, *, window_s, now=None, labels=None):
        return {"mean": 0.0, "max": 0.0, "n": 0}

    def quantile(self, name, q, *, window_s=None, now=None, labels=None):
        return 0.0

    def collect(self):
        return []


NULL = NullRegistry()


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Named instruments + ring-buffered samples.

    ::

        reg = MetricsRegistry()
        ticks = reg.counter("repro_engine_ticks_total", "engine ticks")
        ticks.inc()
        reg.sample(now=clock())                  # advance the ring
        reg.rate("repro_engine_ticks_total", window_s=1.0, now=clock())

    Args:
        ring: samples retained per series (the time-series window).
        sample_interval_s: minimum spacing :meth:`maybe_sample`
            enforces, so hot loops can call it unconditionally.
    """

    def __init__(self, *, ring: int = 512,
                 sample_interval_s: float = 0.05):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._ring = ring
        self._interval = sample_interval_s
        self._last_sample: Optional[float] = None
        # (name, label-values) -> deque[(t, snapshot)]
        self._series: Dict[Tuple[str, Tuple[str, ...]], deque] = {}
        self._callbacks: List[Callable[["MetricsRegistry"], None]] = []

    # -- instrument creation (idempotent by name) ---------------------------
    def _get(self, cls, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labels, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = (), *,
                max_series: int = 64) -> Counter:
        return self._get(Counter, name, help, labels,
                         max_series=max_series)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = (), *,
              max_series: int = 64) -> Gauge:
        return self._get(Gauge, name, help, labels,
                         max_series=max_series)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (), *,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                  max_series: int = 64) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         buckets=buckets, max_series=max_series)

    # -- collect callbacks (pull-style mirrors of snapshot counters) --------
    def on_collect(self, fn: Callable[["MetricsRegistry"], None]) -> None:
        """Register ``fn(registry)`` to run before every sample/scrape —
        the pull path for components whose counters live elsewhere
        (``FactorCache.stats()``, router counters): the callback mirrors
        them into gauges without touching the component's hot path."""
        with self._lock:
            self._callbacks.append(fn)

    def remove_collect(self, fn) -> None:
        with self._lock:
            try:
                self._callbacks.remove(fn)
            except ValueError:
                pass

    def _run_callbacks(self) -> None:
        with self._lock:
            cbs = list(self._callbacks)
        for fn in cbs:
            try:
                fn(self)
            except Exception:
                pass      # a torn-down component must not kill sampling

    # -- sampling (the time-series write path) ------------------------------
    def sample(self, now: float) -> None:
        """Snapshot every instrument into the ring at time ``now``
        (caller's clock — injectable, like every clock in this repo)."""
        self._run_callbacks()
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for key, child in m.children():
                sk = (m.name, key)
                dq = self._series.get(sk)
                if dq is None:
                    dq = self._series[sk] = deque(maxlen=self._ring)
                dq.append((now, child.snapshot()))
        self._last_sample = now

    def maybe_sample(self, now: float) -> bool:
        """Sample only if ``sample_interval_s`` elapsed — safe to call
        from a per-tick / per-submit loop."""
        if self._last_sample is not None and \
                now - self._last_sample < self._interval:
            return False
        self.sample(now)
        return True

    # -- time-series reads --------------------------------------------------
    def _pick_series(self, name: str, labels: Optional[Dict] = None):
        m = self._metrics.get(name)
        if m is None:
            return []
        if labels is not None:
            key = tuple(str(labels[n]) for n in m.label_names)
            dq = self._series.get((name, key))
            return [list(dq)] if dq else []
        return [list(dq) for (n, _), dq in list(self._series.items())
                if n == name]

    def series(self, name: str, labels: Optional[Dict] = None):
        """Raw sampled ``(t, value)`` pairs (single series: exact label
        set, or the metric's only series; multiple series return
        concatenated)."""
        out = []
        for s in self._pick_series(name, labels):
            out.extend(s)
        return sorted(out, key=lambda tv: tv[0])

    def _window(self, seq, window_s, now):
        if now is None:
            now = seq[-1][0] if seq else 0.0
        lo = now - window_s
        return [(t, v) for t, v in seq if lo <= t <= now]

    def rate(self, name: str, *, window_s: float,
             now: Optional[float] = None,
             labels: Optional[Dict] = None) -> float:
        """Windowed counter rate: summed over label sets, computed as
        last-minus-first inside the window over elapsed time.  0.0
        with fewer than two samples in the window."""
        total = 0.0
        for seq in self._pick_series(name, labels):
            w = self._window(seq, window_s, now)
            if len(w) >= 2:
                dt = w[-1][0] - w[0][0]
                if dt > 0:
                    total += max(w[-1][1] - w[0][1], 0.0) / dt
        return total

    def gauge_stats(self, name: str, *, window_s: float,
                    now: Optional[float] = None,
                    labels: Optional[Dict] = None) -> Dict[str, float]:
        """Mean/max/count of gauge samples inside the window (summing
        across label sets per timestamp would conflate replicas — this
        aggregates the sample population instead, which is what a
        sustained-threshold detector wants)."""
        vals = []
        for seq in self._pick_series(name, labels):
            vals.extend(v for _, v in self._window(seq, window_s, now))
        if not vals:
            return {"mean": 0.0, "max": 0.0, "n": 0}
        return {"mean": sum(vals) / len(vals), "max": max(vals),
                "n": len(vals)}

    def quantile(self, name: str, q: float, *,
                 window_s: Optional[float] = None,
                 now: Optional[float] = None,
                 labels: Optional[Dict] = None) -> float:
        """Histogram quantile.  Windowed: from the bucket-count *delta*
        between the window's edge samples (the distribution of
        observations inside the window); unwindowed: from the live
        lifetime counts."""
        m = self._metrics.get(name)
        if not isinstance(m, Histogram):
            return 0.0
        if window_s is None:
            counts = None
            for _, child in m.children():
                c = child.snapshot()[2]
                counts = c if counts is None else \
                    tuple(a + b for a, b in zip(counts, c))
            return quantile_from_counts(m.buckets, counts or (), q)
        counts = None
        for seq in self._pick_series(name, labels):
            w = self._window(seq, window_s, now)
            if len(w) < 2:
                continue
            first, last = w[0][1][2], w[-1][1][2]
            delta = tuple(max(b - a, 0) for a, b in zip(first, last))
            counts = delta if counts is None else \
                tuple(a + b for a, b in zip(counts, delta))
        return quantile_from_counts(m.buckets, counts or (), q)

    # -- scrape support -----------------------------------------------------
    def collect(self) -> List[_Metric]:
        """Metrics in registration order, callbacks run first (so
        pull-style gauges are fresh at scrape time)."""
        self._run_callbacks()
        with self._lock:
            return list(self._metrics.values())
