"""Pluggable overload detection over the registry's time-series view.

This is the signal half of the ROADMAP's elastic-control-plane item
(modeled on vLLM production-stack's ``overload_detector/``): a
detector consumes sampled series — sustained queue depth and arrival
rate — and emits a state plus a scale recommendation that
:class:`~repro_torch.serve.cluster.router.SolveCluster` logs into
``ClusterStats.overload``.  Actuation (spawning/draining replicas)
lands in a later PR; the hysteresis here is what makes that actuation
safe to wire up (no flapping on a single burst sample).

State machine of :class:`SustainedThresholdDetector`::

    ok ── mean queue > high for >= sustain_s ──> overloaded
    overloaded ── mean queue < low for >= cool_s ──> ok

Thresholds compare the *windowed mean* of the queue-depth gauge (and
optionally the arrival-rate counter), so a one-sample spike neither
trips it nor resets the cooldown.
"""
from __future__ import annotations

from typing import Dict, Optional

from .registry import MetricsRegistry


class OverloadDetector:
    """Interface: call :meth:`update` from a host-side loop already
    holding a timestamp; read :meth:`stats` into telemetry."""

    name = "null"

    def update(self, now: float) -> str:
        """Advance the detector; returns the current state
        (``"ok"`` or ``"overloaded"``)."""
        return "ok"

    @property
    def state(self) -> str:
        return "ok"

    @property
    def recommendation(self) -> str:
        """``"scale_up"`` / ``"scale_down"`` / ``"hold"``."""
        return "hold"

    def stats(self) -> Dict[str, object]:
        return {"detector": self.name, "state": self.state,
                "recommendation": self.recommendation}


class SustainedThresholdDetector(OverloadDetector):
    """Queue-depth thresholds with hysteresis and sustain windows.

    Args:
        registry: the sampled :class:`MetricsRegistry` to read.
        queue_metric: gauge name carrying queue depth.
        arrival_metric: optional counter whose windowed rate is
            reported alongside (diagnostic; not part of the trigger
            unless ``high_rate`` is set).
        high_queue: windowed mean queue depth that, sustained for
            ``sustain_s``, flips the state to ``overloaded``.
        low_queue: mean depth that, sustained for ``cool_s``, flips it
            back — strictly below ``high_queue`` (the hysteresis band).
        high_rate: optional arrival-rate trigger OR-ed with the queue
            trigger.
        window_s: averaging window for each :meth:`update` reading.
        sustain_s: seconds the high reading must persist before
            entering ``overloaded`` (a single burst sample holds).
        cool_s: seconds the low reading must persist before leaving.
        idle_down_s: with the fleet idle (mean queue ~0) this long, the
            recommendation becomes ``scale_down``.
    """

    name = "sustained_threshold"

    def __init__(self, registry: MetricsRegistry, *,
                 queue_metric: str = "repro_cluster_queue_depth",
                 arrival_metric: Optional[str] =
                 "repro_cluster_arrivals_total",
                 high_queue: float = 8.0, low_queue: float = 2.0,
                 high_rate: Optional[float] = None,
                 window_s: float = 1.0, sustain_s: float = 0.5,
                 cool_s: float = 1.0, idle_down_s: float = 5.0):
        if low_queue >= high_queue:
            raise ValueError(
                f"hysteresis band requires low_queue < high_queue, got "
                f"low={low_queue} high={high_queue}")
        self.registry = registry
        self.queue_metric = queue_metric
        self.arrival_metric = arrival_metric
        self.high_queue = high_queue
        self.low_queue = low_queue
        self.high_rate = high_rate
        self.window_s = window_s
        self.sustain_s = sustain_s
        self.cool_s = cool_s
        self.idle_down_s = idle_down_s
        self._state = "ok"
        self._high_since: Optional[float] = None
        self._low_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last: Dict[str, float] = {"queue_mean": 0.0, "queue_max": 0.0,
                                        "arrival_rate": 0.0}
        self.transitions = 0
        self.updates = 0

    # -- the state machine ---------------------------------------------------
    def update(self, now: float) -> str:
        self.updates += 1
        q = self.registry.gauge_stats(self.queue_metric,
                                      window_s=self.window_s, now=now)
        rate = self.registry.rate(self.arrival_metric,
                                  window_s=self.window_s, now=now) \
            if self.arrival_metric else 0.0
        self._last = {"queue_mean": q["mean"], "queue_max": q["max"],
                      "arrival_rate": rate}
        hot = q["n"] > 0 and q["mean"] > self.high_queue
        if self.high_rate is not None and rate > self.high_rate:
            hot = True
        cold = q["n"] == 0 or q["mean"] < self.low_queue
        idle = q["n"] == 0 or q["mean"] <= 1e-9

        if self._state == "ok":
            if hot:
                if self._high_since is None:
                    self._high_since = now
                if now - self._high_since >= self.sustain_s:
                    self._state = "overloaded"
                    self.transitions += 1
                    self._low_since = None
            else:
                self._high_since = None
        else:
            if cold:
                if self._low_since is None:
                    self._low_since = now
                if now - self._low_since >= self.cool_s:
                    self._state = "ok"
                    self.transitions += 1
                    self._high_since = None
            else:
                self._low_since = None
        self._idle_since = (self._idle_since or now) if idle else None
        self._now = now
        return self._state

    @property
    def state(self) -> str:
        return self._state

    @property
    def recommendation(self) -> str:
        if self._state == "overloaded":
            return "scale_up"
        if self._idle_since is not None and \
                getattr(self, "_now", 0.0) - self._idle_since \
                >= self.idle_down_s:
            return "scale_down"
        return "hold"

    def stats(self) -> Dict[str, object]:
        return {
            "detector": self.name,
            "state": self._state,
            "recommendation": self.recommendation,
            "transitions": self.transitions,
            "updates": self.updates,
            "queue_mean": self._last["queue_mean"],
            "queue_max": self._last["queue_max"],
            "arrival_rate": self._last["arrival_rate"],
            "high_queue": self.high_queue,
            "low_queue": self.low_queue,
        }
