"""Adaptive preconditioner-family selection for ``--precond auto``.

Every registered family (``repro_torch.core.solver.PRECOND_FAMILIES``) can
serve any graph, but which one serves it *cheapest* depends on the
graph: a stiff mesh wants the AMG apply (one fused SpMV per iteration,
more iterations), a well-conditioned graph converges in a handful of
trisolve sweeps under AC, an SPD-borderline graph may only be safe
under AC's randomized construction.  The cluster cannot know this up
front, so it learns it per graph from its own serving telemetry —
the same contextual-bandit shape LLM gateways use to pick a serving
configuration per tenant.

``AdaptiveSelector`` is an **epsilon-greedy bandit** keyed by
``(graph_id, family)``:

* ``pick(gid, deadline_s=...)`` returns the family the next request on
  ``gid`` should serve under.  A *cold* graph (no observations at all)
  always gets the fallback family (AC — the paper's construction, and
  the only family with a construction-time guarantee), so exploration
  never makes the first request on a graph slower than the status quo.
* with probability ``epsilon`` the pick **explores**: families the
  graph has never tried are preferred (uniformly), then any family —
  this is what discovers that a cheaper family converges.
* otherwise it **exploits**: among observed families predicted to meet
  the request's deadline (EWMA service seconds ≤ ``deadline_margin`` ×
  ``deadline_s``), pick the cheapest by predicted wall clock; if none
  is predicted to meet it, pick the least-bad.  Families whose last
  observation *failed* (solver did not converge) are quarantined from
  exploitation — only an explicit explore retries them.
* ``observe(gid, family, wall_s=..., ...)`` folds a completed request
  back in (EWMA with factor ``alpha``); the router calls it from the
  result future's callback, so selection learns from exactly what was
  served, including deadline misses.

The RNG is seeded — a replayed trace picks identically, which is what
lets ``benchmarks.check_precond_regression`` gate ``auto`` against
always-AC on a recorded trace.  All methods are thread-safe (router
threads pick while driver-thread callbacks observe).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class AdaptiveSelector:
    """Epsilon-greedy per-graph preconditioner-family chooser.

    Args:
        families: candidate family names, in preference order for
            tie-breaks (earlier wins).  Defaults to the four registered
            serving families.
        epsilon: exploration probability per pick (``0.0`` disables
            exploration — the selector then never leaves the fallback).
        alpha: EWMA factor for the per-``(gid, family)`` service-time
            and iteration estimates (higher = adapt faster).
        fallback: family served on cold graphs and preferred on ties.
        deadline_margin: safety factor applied to ``deadline_s`` when
            judging whether a family's predicted service time meets the
            deadline (``0.8`` → must be predicted 20% under budget).
        seed: RNG seed — picks are deterministic per (seed, call
            sequence), so replays reproduce.
    """

    def __init__(self, families: Sequence[str] = ("ac", "ichol", "amg",
                                                  "spai"),
                 *, epsilon: float = 0.1, alpha: float = 0.3,
                 fallback: str = "ac", deadline_margin: float = 0.8,
                 seed: int = 0):
        if fallback not in families:
            raise ValueError(f"fallback {fallback!r} not among candidate "
                             f"families {tuple(families)}")
        if not 0.0 <= epsilon <= 1.0:
            raise ValueError(f"epsilon must be in [0, 1], got {epsilon}")
        self.families = tuple(families)
        self.epsilon = float(epsilon)
        self.alpha = float(alpha)
        self.fallback = fallback
        self.deadline_margin = float(deadline_margin)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        # (gid, family) -> mutable record
        self._est: Dict[Tuple[str, str], Dict] = {}
        # counters (exposed via stats())
        self.picks = 0
        self.cold_picks = 0
        self.explores = 0
        self.exploits = 0
        self.observed = 0
        self.deadline_misses = 0
        self.quarantined = 0      # external (drift-detector) quarantines
        self.picks_by_family: Dict[str, int] = {f: 0 for f in self.families}

    # -- internals ----------------------------------------------------------
    def _known(self, gid: str) -> List[str]:
        return [f for f in self.families if (gid, f) in self._est]

    def _predict(self, gid: str, family: str) -> float:
        # pure service time (admit -> finish), not the old conflated
        # wall clock: queueing and cold construction must not make a
        # fast family look slow (or a slow family look fast once warm)
        return self._est[(gid, family)]["serve_s"]

    def _count(self, family: str) -> None:
        self.picks += 1
        self.picks_by_family[family] += 1

    # -- the decision -------------------------------------------------------
    def pick(self, gid: str, *, deadline_s: Optional[float] = None) -> str:
        """Family the next request on ``gid`` should serve under.

        Args:
            gid: the request's (base, unqualified) graph id.
            deadline_s: the request's SLO budget in seconds, if any —
                exploitation filters candidates on predicted service
                time against it.

        Returns:
            A family name from ``families``.
        """
        with self._lock:
            known = self._known(gid)
            if not known:
                self.cold_picks += 1
                self._count(self.fallback)
                return self.fallback
            if self._rng.random() < self.epsilon:
                self.explores += 1
                untried = [f for f in self.families if f not in known]
                pool = untried if untried else list(self.families)
                fam = pool[int(self._rng.integers(len(pool)))]
                self._count(fam)
                return fam
            self.exploits += 1
            # quarantine families whose last serve failed outright
            ok = [f for f in known if self._est[(gid, f)]["ok"]]
            pool = ok if ok else known
            if deadline_s is not None:
                budget = self.deadline_margin * deadline_s
                meeting = [f for f in pool
                           if self._predict(gid, f) <= budget]
                if meeting:
                    pool = meeting
            fam = min(pool, key=lambda f: (self._predict(gid, f),
                                           self.families.index(f)))
            self._count(fam)
            return fam

    # -- the feedback path --------------------------------------------------
    def observe(self, gid: str, family: str, *, wall_s: float,
                serve_s: Optional[float] = None,
                construct_s: Optional[float] = None,
                iters: Optional[int] = None, ok: bool = True,
                deadline_ok: bool = True) -> None:
        """Fold one completed (or failed) request back into the model.

        Args:
            gid: base graph id the request served.
            family: family it served under.
            wall_s: submit→finish seconds as the client saw it (kept
                for telemetry back-compat; no longer the prediction
                signal).
            serve_s: pure service seconds (lane admission → finish),
                read off the request's lifecycle stamps — the signal
                predictions rank on.  Falls back to ``wall_s`` when the
                caller has no stamps (pre-tracing traces).
            construct_s: construction/adopt seconds this request paid
                on the cold path (``None`` = warm hit, leaves the
                estimate untouched) — the amortizable cost a predicted
                request stream divides down.
            iters: PCG iterations the solve took (block max), if known.
            ok: whether the solve converged — ``False`` quarantines the
                family for this graph until an explore retries it.
            deadline_ok: whether the request met its deadline (always
                ``True`` for deadline-less requests).
        """
        serve = float(serve_s) if serve_s is not None else float(wall_s)
        with self._lock:
            self.observed += 1
            if not deadline_ok:
                self.deadline_misses += 1
            rec = self._est.get((gid, family))
            if rec is None:
                self._est[(gid, family)] = {
                    "wall_s": float(wall_s),
                    "serve_s": serve,
                    "construct_s": (float(construct_s)
                                    if construct_s is not None else 0.0),
                    "iters": float(iters) if iters is not None else 0.0,
                    "n": 1, "ok": bool(ok)}
                return
            a = self.alpha
            rec["wall_s"] += a * (float(wall_s) - rec["wall_s"])
            rec["serve_s"] += a * (serve - rec["serve_s"])
            if construct_s is not None:
                # constructions are rare (factor-once/serve-many): a
                # plain EWMA against mostly-absent samples would decay
                # toward stale values, so only cold-path requests move it
                rec["construct_s"] += a * (float(construct_s)
                                           - rec["construct_s"])
            if iters is not None:
                rec["iters"] += a * (float(iters) - rec["iters"])
            rec["n"] += 1
            rec["ok"] = bool(ok)

    def quarantine(self, gid: str, family: str) -> None:
        """Externally quarantine ``family`` for ``gid`` — the health
        monitor's drift detector calls this when the family's iteration
        counts degrade against their own baseline.  Same mechanism as a
        failed serve: exploitation skips the pair until an explicit
        explore retries it (so a drifting family can rehabilitate if
        the drift was transient)."""
        with self._lock:
            rec = self._est.get((gid, family))
            if rec is None:
                # never served exploitatively yet: record the flag so a
                # first exploitation pass already avoids it
                self._est[(gid, family)] = {
                    "wall_s": 0.0, "serve_s": 0.0, "construct_s": 0.0,
                    "iters": 0.0, "n": 0, "ok": False}
            else:
                rec["ok"] = False
            self.quarantined += 1

    # -- telemetry ----------------------------------------------------------
    def stats(self) -> Dict:
        """Counters plus the per-graph estimate table (JSON-friendly)."""
        with self._lock:
            return {
                "families": list(self.families),
                "epsilon": self.epsilon,
                "picks": self.picks,
                "cold_picks": self.cold_picks,
                "explores": self.explores,
                "exploits": self.exploits,
                "observed": self.observed,
                "deadline_misses": self.deadline_misses,
                "quarantined": self.quarantined,
                "picks_by_family": dict(self.picks_by_family),
                "graphs": len({g for g, _ in self._est}),
                "estimates": {f"{g}::{f}": dict(rec)
                              for (g, f), rec in self._est.items()},
            }
