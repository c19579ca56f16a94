"""Numerical-health instruments: convergence diagnostics, EWMA drift
detection, and fleet-utilization gauges.

The metrics control plane watches *time*; this module watches
*quality*.  The paper's preconditioner randomizes its fill-in pattern
per construction (and rchol reports the same construction-to-
construction variance in iteration counts), so "is this family still
converging like its own history says it should" is a first-class
serving observable, not a test-time property.

:class:`HealthMonitor` consumes one :meth:`observe_retirement` per
retired request (host-side floats the engine already gathered — no
device syncs) and exports:

* per-family convergence series — final relres, retirements by status,
  the **efficiency ratio** (recent-iterations EWMA over the family's
  own slow baseline EWMA for that graph; 1.0 = on baseline, above =
  degrading), and maxiter / deadline-miss streaks;
* an **EWMA drift detector**: per ``(graph, family)``, a slow baseline
  (``baseline_alpha``) and a fast tracker (``fast_alpha``) over
  iteration counts; once ``min_samples`` iteration samples are in and
  ``fast > drift_ratio × slow`` the pair is flagged **drifting**, a
  quarantine fires (``on_quarantine(gid, family)`` — the cluster wires
  this to :meth:`AdaptiveSelector.quarantine`), and a
  ``health_drift`` flight event records the flip;
* fleet-utilization gauges via the registry's pull-style ``on_collect``
  path — lane occupancy per ``(family, n_pad, K_tier)`` bucket,
  padded-vs-live sweep waste over the occupied lanes, and a
  per-device fleet-bytes high-watermark — so the routing/serving hot
  paths never pay for them.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from .flight import NULL_FLIGHT
from .registry import NULL as _NULL_METRICS


class HealthMonitor:
    """Per-retirement convergence diagnostics + drift quarantine +
    fleet-utilization gauges, exported through one registry.

    Args:
        registry: the :class:`~repro_torch.obs.registry.MetricsRegistry` to
            export into (``None`` keeps host-side tracking but exports
            nothing).
        baseline_alpha: slow EWMA weight — the family's own history.
        fast_alpha: fast EWMA weight — what it is doing lately.
        drift_ratio: ``fast > drift_ratio * slow`` flags drift.
        min_samples: iteration samples required before the detector may
            flag (a cold graph's first noisy constructions must not
            quarantine a family).
        on_quarantine: ``(gid, family) ->`` callback fired once per
            flagged pair (exceptions swallowed — health must not take
            serving down).
        flight: optional :class:`~repro_torch.obs.flight.FlightRecorder` —
            drift flips are recorded as ``health_drift`` events.
    """

    def __init__(self, registry=None, *, baseline_alpha: float = 0.05,
                 fast_alpha: float = 0.5, drift_ratio: float = 1.5,
                 min_samples: int = 8,
                 on_quarantine: Optional[Callable[[str, str], None]] = None,
                 flight=None):
        if not 0.0 < baseline_alpha <= 1.0 or not 0.0 < fast_alpha <= 1.0:
            raise ValueError("EWMA alphas must be in (0, 1]")
        if drift_ratio <= 1.0:
            raise ValueError("drift_ratio must be > 1.0")
        self.registry = registry
        self.baseline_alpha = baseline_alpha
        self.fast_alpha = fast_alpha
        self.drift_ratio = drift_ratio
        self.min_samples = min_samples
        self.on_quarantine = on_quarantine
        self._flight = flight if flight is not None else NULL_FLIGHT
        self._ev_drift = self._flight.bind("health_drift")
        reg = registry if registry is not None else _NULL_METRICS
        self._m_relres = reg.gauge(
            "repro_health_final_relres",
            "final relative residual of the most recent retirement",
            ("family",))
        self._m_retire = reg.counter(
            "repro_health_retirements_total",
            "retirements observed by the health monitor, by final status",
            ("family", "status"))
        self._m_eff = reg.gauge(
            "repro_health_efficiency_ratio",
            "fast/slow iteration EWMA of the most recent retirement's "
            "(graph, family); 1.0 = on its own baseline, above = "
            "degrading", ("family",))
        self._m_maxiter = reg.gauge(
            "repro_health_maxiter_streak",
            "worst current consecutive-maxiter streak over the family's "
            "tracked graphs", ("family",))
        self._m_miss = reg.gauge(
            "repro_health_deadline_miss_streak",
            "worst current consecutive deadline-miss streak over the "
            "family's tracked graphs", ("family",))
        self._m_drift = reg.gauge(
            "repro_health_drift",
            "(graph, family) pairs currently flagged as drifting",
            ("family",))
        self._m_quar = reg.counter(
            "repro_health_quarantines_total",
            "drift quarantines fired", ("family",))
        # fleet-utilization gauges (pull-style: set in _collect only)
        self._m_lanes = reg.gauge(
            "repro_fleet_lane_occupancy",
            "occupied solve lanes per engine bucket",
            ("family", "n_pad", "k_tier"), max_series=256)
        self._m_waste = reg.gauge(
            "repro_fleet_sweep_waste_ratio",
            "padded-minus-live fraction of sweep rows over occupied "
            "lanes (0 = every padded row is live work)")
        self._m_watermark = reg.gauge(
            "repro_fleet_bytes_watermark",
            "high-watermark of fleet device bytes", ("device",))
        self._lock = threading.Lock()
        # (gid, family) -> {n, n_it, slow, fast, maxiter_streak,
        #                   miss_streak, drifting}
        self._hist: Dict[tuple, Dict] = {}
        self._by_family: Dict[str, List[Dict]] = {}
        self.observed = 0
        self.quarantines = 0
        self._engines: List = []
        self._caches: List = []
        self._watermarks: Dict[str, float] = {}
        self._collect_registered = False

    # -- per-retirement diagnostics -----------------------------------------
    def observe_retirement(self, *, gid: str, family: str,
                           iters: Optional[int], relres: Optional[float],
                           status: str,
                           deadline_missed: bool = False) -> None:
        """Feed one retired request's host-side convergence outcome.
        ``iters`` is the request's block-max iteration count (``None``
        when the engine gathered none — e.g. an evicted lane)."""
        fire = None
        with self._lock:
            self.observed += 1
            self._m_retire.labels(family=family, status=status).inc()
            if relres is not None:
                self._m_relres.labels(family=family).set(float(relres))
            key = (gid, family)
            rec = self._hist.get(key)
            if rec is None:
                rec = {"n": 0, "n_it": 0, "slow": 0.0, "fast": 0.0,
                       "maxiter_streak": 0, "miss_streak": 0,
                       "drifting": False}
                self._hist[key] = rec
                self._by_family.setdefault(family, []).append(rec)
            rec["n"] += 1
            rec["maxiter_streak"] = rec["maxiter_streak"] + 1 \
                if status == "maxiter" else 0
            rec["miss_streak"] = rec["miss_streak"] + 1 \
                if (deadline_missed or status == "deadline_missed") else 0
            fam_recs = self._by_family[family]
            self._m_maxiter.labels(family=family).set(
                max(r["maxiter_streak"] for r in fam_recs))
            self._m_miss.labels(family=family).set(
                max(r["miss_streak"] for r in fam_recs))
            if iters is not None:
                it = float(iters)
                if rec["n_it"] == 0:
                    rec["slow"] = rec["fast"] = it
                else:
                    a, b = self.baseline_alpha, self.fast_alpha
                    rec["slow"] += a * (it - rec["slow"])
                    rec["fast"] += b * (it - rec["fast"])
                rec["n_it"] += 1
                eff = rec["fast"] / rec["slow"] if rec["slow"] > 0 else 1.0
                self._m_eff.labels(family=family).set(eff)
                if (not rec["drifting"]
                        and rec["n_it"] >= self.min_samples
                        and rec["fast"] > self.drift_ratio * rec["slow"]):
                    rec["drifting"] = True
                    self.quarantines += 1
                    self._m_quar.labels(family=family).inc()
                    self._m_drift.labels(family=family).set(
                        sum(r["drifting"] for r in fam_recs))
                    fire = (gid, family, eff)
        if fire is not None:
            gid_f, fam_f, eff_f = fire
            self._ev_drift(gid=gid_f, family=fam_f,
                           efficiency=round(eff_f, 3))
            cb = self.on_quarantine
            if cb is not None:
                try:
                    cb(gid_f, fam_f)
                except Exception:
                    pass

    # -- fleet utilization (pull-style) --------------------------------------
    def watch_engine(self, engine) -> None:
        """Register an engine whose bucket/lane occupancy the collect
        callback mirrors into gauges at sample/scrape time."""
        self._engines.append(engine)
        self._register_collect()

    def watch_cache(self, cache) -> None:
        """Register a cache whose per-device fleet bytes feed the
        high-watermark gauge."""
        self._caches.append(cache)
        self._register_collect()

    def _register_collect(self) -> None:
        if self.registry is not None and not self._collect_registered:
            self.registry.on_collect(self._collect)
            self._collect_registered = True

    def _collect(self, reg) -> None:
        lanes_by_bucket: Dict[tuple, int] = {}
        live = padded = 0
        for eng in list(self._engines):
            for key, bl in list(eng._buckets.items()):
                fam, n_pad, k_tier = key
                k = (str(fam), str(n_pad), str(k_tier))
                lanes_by_bucket[k] = (lanes_by_bucket.get(k, 0)
                                      + int(bl.n_active))
            for lane in list(eng.lanes):
                if lane is None:
                    continue
                h = lane.req._handle
                if h is not None:
                    live += int(h.n)
                    padded += int(h.n_pad)
        for k, v in lanes_by_bucket.items():
            self._m_lanes.labels(family=k[0], n_pad=k[1],
                                 k_tier=k[2]).set(v)
        self._m_waste.set(1.0 - live / padded if padded else 0.0)
        for cache in list(self._caches):
            try:
                by_dev = cache.stats().get(
                    "fleet_device_bytes_by_device", {}) or {}
            except Exception:
                continue
            for dev, b in by_dev.items():
                dev = str(dev)
                cur = self._watermarks.get(dev, 0.0)
                if b > cur:
                    self._watermarks[dev] = cur = float(b)
                self._m_watermark.labels(device=dev).set(cur)

    # -- telemetry ------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Host-side summary for ``ClusterStats.health`` / reports."""
        with self._lock:
            drifting = sorted(
                f"{g}::{f}" for (g, f), r in self._hist.items()
                if r["drifting"])
            fams: Dict[str, Dict] = {}
            for (g, f), r in self._hist.items():
                d = fams.setdefault(f, {"tracked": 0, "drifting": 0,
                                        "max_maxiter_streak": 0,
                                        "max_deadline_miss_streak": 0})
                d["tracked"] += 1
                d["drifting"] += int(r["drifting"])
                d["max_maxiter_streak"] = max(d["max_maxiter_streak"],
                                              r["maxiter_streak"])
                d["max_deadline_miss_streak"] = max(
                    d["max_deadline_miss_streak"], r["miss_streak"])
            return {"observed": self.observed,
                    "tracked": len(self._hist),
                    "quarantines": self.quarantines,
                    "drifting": drifting, "families": fams,
                    "fleet_bytes_watermark": dict(self._watermarks)}
