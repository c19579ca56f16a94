"""Pluggable admission scheduling for the solve service.

PR 3 made lane state device-resident; admission stayed an inline FIFO
inside ``SolveEngine._admit`` — fair, but a wide request at the head of
the queue idles every free lane behind it (head-of-line blocking).
This module factors the *decision* out of the engine into a policy
object the engine consults once per tick:

* :class:`FIFOAdmission` — strict submission order with head-of-line
  blocking; byte-for-byte the engine's historical behavior (it is the
  engine's default, so sync ``SolveEngine`` users see no change);
* :class:`PriorityAdmission` — priority classes (lower value = more
  urgent) with **backfill**: when the most-urgent waiting request does
  not fit the free lanes, later narrow requests may skip ahead into
  them;
* :class:`DeadlineAdmission` — earliest-deadline-first ordering (then
  priority, then arrival) with the same backfill machinery, plus
  ``evict_hopeless = True``: the engine retires lanes whose deadline can
  no longer be met with a ``deadline_missed`` status instead of letting
  them squat on fleet slots.

**Starvation bound.**  Backfill is capped: each *admission round* (one
``select`` call with a non-empty queue) in which at least one request is
admitted past a blocked, more-urgent request increments the blocked
request's ``sched_skips``.  Once ``sched_skips == max_skips`` the
request becomes a **barrier** — nothing behind it in the policy order
may be admitted until it fits.  Hence a skipped request waits at most
``max_skips`` backfill rounds once it is the most-urgent blocked
request, and ``backfill_skips <= max_skips * skipped_reqs`` is a hard
counter invariant (gated in CI by
``benchmarks.check_serve_regression``).

**Work-conserving backfill under seal.**  A sealed queue idles free
lanes even when the sealed request will be waiting on *busy* lanes for
many more ticks.  Backfilling policies therefore still admit, past a
seal, any request whose worst-case duration **provably** cannot extend
the wait bound of the sealer or of any blocked more-urgent request: the
engine passes per-occupied-lane worst-case remaining ticks
(``busy_bounds``, from ``maxiter`` budgets and admit ticks — a lane
retires by maxiter whatever happens), a candidate's worst case is
``ceil(maxiter / iters_per_tick)`` ticks, and a blocked request needing
``need`` more lanes admits — in the worst case — when the ``need``-th
soonest-bounded busy lane retires.  A candidate no longer-lived than
that bound occupies a lane that is provably free again by then, so the
seal's guarantee is unchanged.  (Ticks are the sound currency here: the
engine's running-min tick estimate converts the bound to seconds only
for reporting — a *minimum* per-tick duration cannot prove an earlier
finish.)  Sealed backfills never touch ``sched_skips`` — they are
counted separately as ``sealed_backfills`` — so the starvation-bound
invariant above is untouched (also CI-gated: FIFO, whose ``max_skips``
is 0 and which never seals, must report zero).

Policies only *order and bound* admission; the engine still performs
the scatter per admitted request, so serving stays bit-exact
with direct ``FactorHandle.solve`` regardless of policy — scheduling
changes *when* a request's lanes start, never what they compute.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, TYPE_CHECKING

if TYPE_CHECKING:                                     # pragma: no cover
    from .engine import SolveRequest


class AdmissionPolicy:
    """Decides which waiting requests to admit into free lanes.

    ``select`` receives a snapshot of the waiting queue (submission
    order) and the number of free lanes, and returns the requests to
    admit *this round*, in admission order; the engine scatters each and
    removes it from the queue.  The policy must only return requests
    whose combined ``nrhs`` fits ``free``.

    ``evict_hopeless`` tells the engine to retire active lanes whose
    request can no longer meet its deadline (see
    :class:`DeadlineAdmission`).
    """

    name = "base"
    max_skips = 0
    evict_hopeless = False

    def __init__(self) -> None:
        self.rounds = 0            # select calls with a non-empty queue
        self.backfill_skips = 0    # total skip increments across requests
        self.skipped_reqs = 0      # requests that were ever skipped
        self.barrier_rounds = 0    # rounds cut short by a starvation barrier
        self.sealed_backfills = 0  # provably-short admissions past a seal

    def select(self, waiting: Sequence["SolveRequest"], free: int, *,
               now: float, busy_bounds: Sequence[int] = (),
               iters_per_tick: int = 1) -> List["SolveRequest"]:
        """``busy_bounds``: one worst-case-remaining-ticks entry per
        occupied lane (the engine derives them from maxiter budgets);
        only the work-conserving seal path reads them."""
        raise NotImplementedError

    def counters(self) -> Dict[str, int]:
        return dict(sched_rounds=self.rounds,
                    backfill_skips=self.backfill_skips,
                    skipped_reqs=self.skipped_reqs,
                    barrier_rounds=self.barrier_rounds,
                    sealed_backfills=self.sealed_backfills)


class _OrderedBackfill(AdmissionPolicy):
    """Shared machinery: admit greedily in policy order, let later
    requests backfill past blocked ones, stop at a starvation barrier.

    Subclasses define ``_key(req)`` — the policy order (ascending; ties
    broken by engine submission sequence, which ``_key`` must include
    last for stability).
    """

    def __init__(self, max_skips: int = 8, work_conserving: bool = True):
        super().__init__()
        if max_skips < 0:
            raise ValueError("max_skips must be >= 0")
        self.max_skips = max_skips
        self.work_conserving = work_conserving

    def _key(self, req: "SolveRequest", now: float):
        raise NotImplementedError

    @staticmethod
    def _worst_ticks(req: "SolveRequest", ipt: int) -> int:
        """Upper bound on a not-yet-admitted request's lane lifetime:
        it retires by ``maxiter`` iterations whatever happens."""
        return max(-(-req.maxiter // ipt), 1)

    def select(self, waiting: Sequence["SolveRequest"], free: int, *,
               now: float, busy_bounds: Sequence[int] = (),
               iters_per_tick: int = 1) -> List["SolveRequest"]:
        if not waiting:
            return []
        self.rounds += 1
        order = sorted(waiting, key=lambda r: self._key(r, now))
        take: List["SolveRequest"] = []
        blocked: List["SolveRequest"] = []   # more-urgent, didn't fit
        skipped: List["SolveRequest"] = []   # blocked AND passed over
        for r in order:
            if r.nrhs <= free:
                take.append(r)
                free -= r.nrhs
                for b in blocked:            # this admission skips past b
                    if b not in skipped:
                        skipped.append(b)
            else:
                if r.sched_skips >= self.max_skips:
                    # starvation barrier: r has been skipped its full
                    # allowance — nothing behind it may backfill until
                    # it admits (requests *before* it in policy order
                    # are more urgent, not backfill, so `take` stands).
                    # Only a real seal counts as a barrier round: under
                    # max_skips == 0 this branch is plain head-of-line
                    # blocking, not a seal.
                    if self.max_skips > 0:
                        self.barrier_rounds += 1
                        if self.work_conserving and free > 0:
                            take += self._seal_backfill(
                                order, r, blocked, take, free,
                                busy_bounds, iters_per_tick)
                    break
                blocked.append(r)
        for b in skipped:
            if b.sched_skips == 0:
                self.skipped_reqs += 1
            b.sched_skips += 1
            self.backfill_skips += 1
        return take

    def _seal_backfill(self, order: List["SolveRequest"],
                       sealer: "SolveRequest",
                       blocked: List["SolveRequest"],
                       take: List["SolveRequest"], free: int,
                       busy_bounds: Sequence[int],
                       ipt: int) -> List["SolveRequest"]:
        """Work-conserving admission past a starvation seal.

        A blocked request ``g`` needing ``need = g.nrhs - free`` more
        lanes admits, in the *worst* case, when the ``need``-th
        soonest-bounded occupied lane retires (every lane retires by its
        maxiter budget).  A candidate whose own worst-case tick count is
        ≤ every guarded request's bound occupies a free lane that is
        provably free again before any of them could have admitted
        anyway — so admitting it cannot extend the seal's wait bound.
        Sealed admissions never increment ``sched_skips`` (the
        starvation-bound counters are untouched); they count in
        ``sealed_backfills``."""
        wt = self._worst_ticks
        busy = list(busy_bounds)
        for t in take:                       # this round's admissions
            busy += [wt(t, ipt)] * t.nrhs    # occupy lanes too
        guarded = blocked + [sealer]
        out: List["SolveRequest"] = []
        for c in order[order.index(sealer) + 1:]:
            if c.nrhs > free:
                continue
            w = wt(c, ipt)
            b = sorted(busy)
            ok = True
            for g in guarded:
                need = g.nrhs - free         # busy lanes g waits for
                if need > len(b) or w > b[need - 1]:
                    ok = False               # no provable headroom
                    break
            if ok:
                out.append(c)
                free -= c.nrhs
                busy += [w] * c.nrhs
                self.sealed_backfills += 1
        return out


class FIFOAdmission(_OrderedBackfill):
    """Strict submission order, head-of-line blocking (the historical
    inline behavior): ``max_skips = 0`` makes the queue head an
    immediate barrier, so nothing ever skips ahead."""

    name = "fifo"

    def __init__(self):
        super().__init__(max_skips=0)

    def _key(self, req: "SolveRequest", now: float):
        return (req._seq,)


class PriorityAdmission(_OrderedBackfill):
    """Priority classes with bounded backfill.  Order: ``(priority,
    submission seq)`` — lower priority value is more urgent; within a
    class, FIFO.  Narrow requests may skip a blocked wide head at most
    ``max_skips`` rounds."""

    name = "priority"

    def _key(self, req: "SolveRequest", now: float):
        return (req.priority, req._seq)


class DeadlineAdmission(_OrderedBackfill):
    """Earliest-deadline-first with bounded backfill and hopeless-lane
    eviction.  Order: ``(deadline, priority, seq)``; requests without a
    deadline sort last within their priority class.  Sets
    ``evict_hopeless`` so the engine retires lanes that can no longer
    finish before their deadline (``status == "deadline_missed"``)
    instead of letting them hold fleet slots to maxiter."""

    name = "deadline"
    evict_hopeless = True

    def _key(self, req: "SolveRequest", now: float):
        dl = req._deadline_abs
        return (dl if dl is not None else float("inf"),
                req.priority, req._seq)


_POLICIES = {
    "fifo": FIFOAdmission,
    "priority": PriorityAdmission,
    "deadline": DeadlineAdmission,
}


def make_policy(name: str, *, max_skips: Optional[int] = None,
                work_conserving: bool = True) -> AdmissionPolicy:
    """Build a policy by CLI name (``fifo`` / ``priority`` /
    ``deadline``).  ``max_skips`` overrides the backfill allowance for
    the backfilling policies (FIFO is always 0 — that *is* FIFO);
    ``work_conserving=False`` disables provably-short admissions past a
    starvation seal (FIFO never seals, so it has neither)."""
    try:
        cls = _POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown admission policy {name!r}; "
                         f"choose from {sorted(_POLICIES)}") from None
    if cls is FIFOAdmission:
        return cls()
    if max_skips is None:
        return cls(work_conserving=work_conserving)
    return cls(max_skips=max_skips, work_conserving=work_conserving)
