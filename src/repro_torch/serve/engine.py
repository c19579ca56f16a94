"""Device-resident continuous-batching engine for Laplacian solve
requests.

The serving workload of this repo *is* the paper's value proposition:
factor once (cheap randomized construction), then amortize the factor
over a stream of right-hand sides.  ``SolveEngine`` is the vLLM-style
continuous-batching loop restated for PCG instead of token decoding,
with the data-ownership model inverted relative to the PR-2 engine:
**lanes live on the device, not the host.**

* a fixed number of **lanes** (slots); every lane's PCG carry lives in
  a persistent ``(slots, n_pad)`` :class:`pcg.FleetPCGState` on the
  fleet's device, owned by the lane's **shape bucket** for the lifetime
  of the engine — the carry never round-trips through the host;
* queued :class:`SolveRequest`\\ s ``(graph_id, rhs, tol)`` are admitted
  FIFO: admission initializes the request's columns
  (``pcg_fleet_init`` on those columns only) and writes every carry
  field into free rows with one ``index_copy_`` per field (host→device
  traffic = the new rhs columns, nothing else);
* each tick advances every bucket with active lanes through
  ``iters_per_tick`` iterations of ``pcg_fleet_step`` — one call per
  bucket over the bucket's stacked factor arrays (``FactorCache`` →
  :class:`FactorFleet` → ``pcg.FleetArrays``), a per-lane factor index
  routing each lane to its own factor.  Grouping is by ``(family, shape
  bucket, K-tier)``, not factor identity: every preconditioner of one
  family whose graphs share a pow2 size bucket and panel-width tier
  runs in one step (sub-bucketing by K-tier keeps one hub-heavy factor
  from inflating every bucket-mate's trisolve panels);
* lanes whose column converged (or hit maxiter) retire at the end of a
  tick via one **gather** of just the finished columns (device→host
  traffic = retired columns); freed lanes readmit from the queue on the
  next tick.

The reference runs five jitted programs (admit, step, gather, evict,
sync); here they are plain functions on tensors on the fleet's device,
and the port compiles nothing.  ``compile_counts`` (and
``EngineStats.*_compiles``) count the first use of each signature the
reference's ``jax.jit`` keys on — the shapes of the arguments (the
fleet's stacked arrays, the lane state, the pow2-padded row count of an
admit, gather, evict or sync) and the statics (level ceilings, apply
kind) — so ``step_compiles`` grows once per bucket, never per factor,
and the counters compare field for field with the reference's.  Host
reads per tick: the ``(slots,)`` active flags of each stepped bucket,
besides ``pcg_fleet_step``'s own ``any(active)`` per iteration.

Admission *decisions* are delegated to a pluggable
:class:`admission.AdmissionPolicy` (default :class:`FIFOAdmission`,
which reproduces the historical inline FIFO with head-of-line blocking
exactly).  Backfilling policies let narrow requests skip a blocked wide
head into free lanes, bounded by ``max_skips`` per skipped request;
deadline-aware policies additionally have the engine retire lanes that
can no longer meet their deadline (``status == "deadline_missed"``)
via a deactivate, freeing fleet slots early.  The asyncio-facing
frontend over this engine lives in :mod:`repro_torch.serve.frontend`.

Because frozen-lane PCG rows are independent (every lane's reductions
run on its own row, ``core/pcg.py``) and the engine runs the same fleet
PCG body as ``FactorHandle.solve`` over the same stacked arrays, a
served request's trajectory is **bit-identical** to a direct solve of
its own rhs block — batch composition, inactive lanes, bucket mates and
tick slicing change nothing.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.solver import FactorCache, FactorFleet, FactorHandle
from ..core.parac import _next_pow2
from ..core.pcg import (FleetArrays, FleetPCGState, _norm, pcg_fleet_init,
                        pcg_fleet_step)
from ..obs.flight import NULL_FLIGHT
from ..obs.registry import NULL as _NULL_METRICS
from ..obs.tracing import span, trace_from_request
from .admission import AdmissionPolicy, FIFOAdmission

# process-wide trace-id sequence: stamped once per request at
# construction (``__post_init__``) so flight-recorder events and
# Chrome trace rows join on the same id no matter which face —
# frontend, cluster, or a replay driver building SolveRequests
# directly — created the request
_TRACE_SEQ = itertools.count()


@dataclasses.dataclass(eq=False)          # identity equality: results are
class SolveRequest:                        # arrays, field-wise == is a trap
    """One solve job: ``L_graph x = b`` to relative tolerance ``tol``.

    ``b`` may be ``(n,)`` or ``(nrhs, n)`` — a block request occupies
    ``nrhs`` lanes and completes when every column has retired.  Result
    fields are populated on completion; ``x`` matches ``b``'s shape.
    ``arrival_s`` is an optional trace-relative arrival offset used by
    open-loop replay drivers (the engine itself only timestamps).

    Scheduling fields: ``priority`` (lower = more urgent; only ordering
    policies read it), ``deadline_s`` (SLO budget in seconds from
    submission; deadline-aware policies order by it and the engine
    evicts lanes that can no longer meet it).  ``status`` on completion
    is ``"converged"``, ``"maxiter"`` or ``"deadline_missed"``."""

    rid: int
    graph_id: str
    b: np.ndarray
    tol: float = 1e-6
    maxiter: int = 500
    arrival_s: float = 0.0
    priority: int = 0
    deadline_s: Optional[float] = None
    replica: int = -1         # filled by the cluster router (serving replica)
    trace_id: str = ""        # auto-stamped; joins flight events ↔ traces
    # -- filled by the engine -----------------------------------------------
    x: Optional[np.ndarray] = None
    iters: Optional[np.ndarray] = None
    relres: Optional[np.ndarray] = None
    converged: Optional[bool] = None
    status: str = ""
    sched_skips: int = 0      # admission rounds this request was skipped
    _seq: int = -1            # engine submission sequence (policy tiebreak)
    _deadline_abs: Optional[float] = None   # engine-clock absolute deadline
    _evicted: bool = False    # deadline eviction marked (once per request)
    submit_time: float = 0.0
    admit_time: float = 0.0
    finish_time: float = 0.0
    submit_tick: int = -1
    admit_tick: int = -1
    finish_tick: int = -1
    # -- lifecycle attribution (read by repro.obs.tracing) -------------------
    route_s: float = 0.0        # router decision + retry time (cluster)
    factor_wait_s: float = 0.0  # cold-path construction/adopt wait
    factor_mode: str = ""       # "" (warm hit) | "factor" | "adopt"
    first_tick_time: float = 0.0  # stamped by the engine when traced
    _partial: Dict[int, tuple] = dataclasses.field(
        default_factory=dict, repr=False)
    # handle resolved at submit time: the factor this request will solve
    # against, fixed for its lifetime even if the cache re-attaches the
    # graph_id to a different factor afterwards
    _handle: Optional[FactorHandle] = dataclasses.field(
        default=None, repr=False)

    def __post_init__(self):
        if not self.trace_id:
            self.trace_id = f"t{next(_TRACE_SEQ):06d}"

    @property
    def nrhs(self) -> int:
        """Lanes this request needs: 1 for a ``(n,)`` rhs, else the
        block width of its ``(nrhs, n)`` batch."""
        return 1 if np.ndim(self.b) == 1 else int(np.shape(self.b)[0])

    @property
    def latency_s(self) -> float:
        """End-to-end: submit → finish (includes queueing)."""
        return self.finish_time - self.submit_time

    @property
    def queue_wait_s(self) -> float:
        """Queueing delay: submit → lane admission."""
        return self.admit_time - self.submit_time

    @property
    def service_s(self) -> float:
        """Pure service time: lane admission → finish."""
        return self.finish_time - self.admit_time


def make_request(graph_id: str, b, *, rid: int, tol: float = 1e-6,
                 maxiter: int = 500, priority: int = 0,
                 deadline_s: Optional[float] = None) -> SolveRequest:
    """Canonical request builder shared by every submit face
    (``SolveFrontend.submit``, ``SolveCluster.submit``) so new
    per-request fields are threaded through one kwarg list, not N."""
    return SolveRequest(rid=rid, graph_id=graph_id, b=np.asarray(b),
                        tol=tol, maxiter=maxiter, priority=priority,
                        deadline_s=deadline_s)


@dataclasses.dataclass
class EngineStats:
    """Service-level counters (``SolveEngine.stats()``).  The compile
    counters (in the port: first uses of a program signature, see the
    module docstring) expose the mega-batching contract:
    ``step_compiles`` grows per *(family, shape bucket, K-tier)*, never
    per factor (``families``
    counts the distinct preconditioner families that have served lanes);
    ``cols_in``/``cols_out`` count
    host↔device column transfers, which are O(admitted + retired), never
    O(slots × ticks).

    The scheduler block exposes every admission decision:
    ``admitted_reqs == completed + in_flight_reqs`` always (gated in
    CI), ``backfill_skips <= max_skips * skipped_reqs`` is the
    starvation bound, ``deadline_evictions`` counts requests retired
    early as hopeless, and ``queue_peak`` is the high-water queue
    depth."""

    ticks: int
    completed: int
    queued: int
    active_lanes: int
    slots: int
    factors: int
    buckets: int
    families: int
    step_compiles: int
    admit_compiles: int
    gather_compiles: int
    cols_in: int
    cols_out: int
    # -- padding-tax accounting ---------------------------------------------
    # sweeps_skipped: trisolve level sweeps the dynamic per-lane bounds
    # elided vs the static bucket ceilings (summed over stepped buckets);
    # sweep_elements: padded (lanes × n_pad × K × live sweeps) panel
    # elements swept per apply, the K-tiering figure of merit gated by
    # check_serve_regression; fleet_resyncs: bucket fidx re-scatters
    # after a fleet compaction moved row indices
    sweeps_skipped: int
    sweep_elements: int
    fleet_resyncs: int
    # -- scheduler decisions ------------------------------------------------
    policy: str
    max_skips: int
    admitted_reqs: int
    in_flight_reqs: int
    sched_rounds: int
    backfill_skips: int
    skipped_reqs: int
    barrier_rounds: int
    sealed_backfills: int
    deadline_evictions: int
    queue_peak: int

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class _LaneRef:
    """Host-side bookkeeping for one occupied lane: which request/column
    it serves and which bucket owns its device row.  No carry data —
    that stays resident in the bucket's ``FleetPCGState``."""

    __slots__ = ("req", "col", "bucket")

    def __init__(self, req: SolveRequest, col: int, bucket: "_BucketLanes"):
        self.req = req
        self.col = col
        self.bucket = bucket


class _BucketLanes:
    """Persistent device-resident lane state for one shape bucket.

    ``state`` is a ``(slots, n_pad)`` :class:`FleetPCGState` allocated
    on the fleet's device once when the bucket first serves a request and
    updated only by the admit/step/evict/sync functions.  ``n_active`` mirrors the device-side
    active count so idle buckets skip their step without a device sync.
    Lane row ``i`` of every bucket corresponds to global lane ``i``; a
    global lane is owned by exactly one bucket at a time, and a row's
    ``active`` flag is True iff this bucket owns the lane and its column
    is still iterating."""

    __slots__ = ("fleet", "state", "n_active", "generation")

    def __init__(self, fleet: FactorFleet, slots: int):
        n_pad = fleet.n_pad
        dev = fleet.device
        f32, i32 = torch.float32, torch.int32

        def z(shape, dt=f32):
            return torch.zeros(shape, dtype=dt, device=dev)

        self.fleet = fleet
        # fleet generation this bucket's resident fidx values refer to;
        # a compaction bumps the fleet's and the engine re-syncs
        self.generation = fleet.generation
        # on the fleet's device, like its stacked arrays: nothing the
        # step reads is ever a host tensor
        self.state = FleetPCGState(
            X=z((slots, n_pad)), R=z((slots, n_pad)), Z=z((slots, n_pad)),
            P=z((slots, n_pad)), rz=z((slots,)), it=z((slots,), i32),
            active=z((slots,), torch.bool),
            bnorm=torch.ones((slots,), dtype=f32, device=dev),
            fidx=z((slots,), i32),
            tol=torch.ones((slots,), dtype=f32, device=dev),
            maxiter=z((slots,), i32))
        self.n_active = 0


# -- engine programs (the reference's five jitted programs, as plain
# functions on the lane state; they update it in place) -------------------

def _admit_program(fa: FleetArrays, state: FleetPCGState,
                   rows: torch.Tensor, B, fidx, tol, maxiter, *,
                   f_plan, b_plan, kind: str = "factor"):
    """Initialize the admitted columns (same math as a direct solve's
    init, on those columns only) and write every carry field into the
    resident state at ``rows`` (one ``index_copy_`` per field).  Returns
    the columns' initial active flags."""
    init = pcg_fleet_init(fa, fidx, B, tol, maxiter, f_plan=f_plan,
                          b_plan=b_plan, kind=kind)
    for dst, src in zip(state, init):
        dst.index_copy_(0, rows, src)
    return init.active


def _step_program(fa: FleetArrays, state: FleetPCGState, *, k: int,
                  f_plan, b_plan, kind: str = "factor") -> FleetPCGState:
    return pcg_fleet_step(fa, state, k=k, f_plan=f_plan, b_plan=b_plan,
                          kind=kind)


def _gather_program(state: FleetPCGState, rows: torch.Tensor):
    """Pull only the finished columns back: iterate, iteration count and
    relative residual per retired row.  The residual norm is the port's
    lane norm (each row reduced alone), as ``pcg_fleet_result`` computes
    it: a batched row norm would pick its summation order by the number
    of rows on CUDA."""
    relres = _norm(state.R[rows]) / state.bnorm[rows]
    return state.X[rows], state.it[rows], relres


def _evict_program(state: FleetPCGState, rows: torch.Tensor) -> None:
    """Force-freeze lanes at ``rows`` (deadline eviction): clearing the
    active flag makes the masked step a no-op for them, so the next
    retirement gather returns their current partial iterate."""
    state.active.index_fill_(0, rows, False)


def _sync_program(state: FleetPCGState, fidx: torch.Tensor) -> None:
    """Rewrite the resident factor indices of every lane — a fleet
    compaction moved rows; the occupied lanes' handles already carry the
    new indices and the unoccupied lanes point at row 0 (a compaction
    can shrink the stack below a stale index, and a torch gather, unlike
    an XLA one, does not clamp).  Only ``fidx`` changes: the PCG carry
    itself never references fleet rows, so the lanes' trajectories are
    untouched."""
    state.fidx.copy_(fidx)


def _shapes(*groups) -> tuple:
    """The argument shapes a ``jax.jit`` cache entry is keyed on."""
    return tuple(tuple(tuple(x.shape) for x in g) for g in groups)


class SolveEngine:
    """Continuous-batching solve service over a :class:`FactorCache`.

    Graphs must be admitted to the cache (``cache.factor`` /
    ``factor_batched``) before requests referencing them are submitted.
    """

    def __init__(self, cache: FactorCache, *, slots: int = 8,
                 iters_per_tick: int = 8, completed_history: int = 4096,
                 admission: Optional[AdmissionPolicy] = None,
                 clock: Optional[Callable[[], float]] = None,
                 metrics=None, tracer=None, flight=None, health=None,
                 obs_replica: int = -1, obs_device: str = ""):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.cache = cache
        self.slots = slots
        self.iters_per_tick = iters_per_tick
        # pluggable admission scheduler; the default reproduces the
        # historical inline FIFO (head-of-line blocking) exactly
        self.admission = admission if admission is not None \
            else FIFOAdmission()
        # injectable clock (tests drive deadline eviction without wall
        # time); every engine timestamp and deadline uses this clock
        self._clock = clock if clock is not None else time.perf_counter
        self._est_tick_s = 0.0     # min observed tick duration (s)
        self._seq = 0              # submission sequence (policy tiebreak)
        self.admitted_reqs = 0
        self.deadline_evictions = 0
        self.queue_peak = 0
        # bounded: a long-running service must not accumulate every
        # finished request's arrays forever (drain return values are the
        # delivery path; this is just recent history)
        self.completed: Deque[SolveRequest] = deque(maxlen=completed_history)
        self.lanes: List[Optional[_LaneRef]] = [None] * slots
        self.queue: Deque[SolveRequest] = deque()
        self.ticks = 0
        # graph_id → most-recent handle with queued/active work.  Each
        # request holds a strong ref to its own resolved handle
        # (``req._handle`` — that ref is what keeps an in-flight
        # factor's fleet row claimed); this map only routes *new*
        # submits for a graph that was evicted mid-flight, and is
        # dropped when the graph goes idle.
        self._pinned: Dict[str, FactorHandle] = {}
        self._buckets: Dict[Tuple[str, int, int], _BucketLanes] = {}
        self.n_completed = 0       # lifetime count (completed is bounded)
        # signature + transfer accounting: each counter counts the
        # distinct signatures its program met, where the reference counts
        # its jit specializations (see the module docstring);
        # cols_in/cols_out count host↔device column transfers (admitted /
        # retired columns only).
        self.compile_counts = {"step": 0, "admit": 0, "gather": 0,
                               "evict": 0, "sync": 0}
        self._signatures: Dict[str, set] = {k: set()
                                            for k in self.compile_counts}
        self.cols_in = 0
        self.cols_out = 0
        # padding-tax telemetry (see EngineStats)
        self.sweeps_skipped = 0
        self.sweep_elements = 0
        self.fleet_resyncs = 0

        # -- observability (repro.obs) — instruments pre-bound here so
        # the tick loop only ever calls inc/set/observe on a child
        # (no-op children when metrics is None); tracer gates the
        # first-tick stamping loop entirely
        reg = metrics if metrics is not None else _NULL_METRICS
        self.metrics = metrics
        self.tracer = tracer
        self._obs_replica = obs_replica
        self._obs_device = obs_device
        rep = str(obs_replica) if obs_replica >= 0 else "solo"
        self._m_ticks = reg.counter(
            "repro_engine_ticks_total", "engine ticks executed",
            labels=("replica",)).labels(replica=rep)
        self._m_tick_s = reg.histogram(
            "repro_engine_tick_seconds", "wall seconds per engine tick",
            labels=("replica",)).labels(replica=rep)
        self._m_queue = reg.gauge(
            "repro_engine_queue_depth", "requests waiting for lanes",
            labels=("replica",)).labels(replica=rep)
        self._m_lanes = reg.gauge(
            "repro_engine_active_lanes", "lanes currently occupied",
            labels=("replica",)).labels(replica=rep)
        self._m_admitted = reg.counter(
            "repro_engine_admitted_total", "requests granted lanes",
            labels=("replica",)).labels(replica=rep)
        self._m_done = reg.counter(
            "repro_engine_completed_total",
            "requests retired, by terminal status",
            labels=("replica", "status"))
        self._m_latency = reg.histogram(
            "repro_engine_latency_seconds",
            "end-to-end request latency (submit to finish)",
            labels=("replica",)).labels(replica=rep)
        self._m_qwait = reg.histogram(
            "repro_engine_queue_wait_seconds",
            "admission queue wait (submit to lane grant)",
            labels=("replica",)).labels(replica=rep)
        self._obs_rep_label = rep
        # flight recorder + health monitor ride the same pre-bound
        # pattern: no-op callables when absent, one dict build per event
        # when present — never a device sync either way
        fl = flight if flight is not None else NULL_FLIGHT
        self.flight = flight
        self.health = health
        self._ev_admit = fl.bind("admit", replica=rep)
        self._ev_retire = fl.bind("retire", replica=rep)
        self._ev_evict = fl.bind("evict", replica=rep)
        self._step_fn = _step_program

    def _signature(self, program: str, sig) -> None:
        """Count ``sig`` if ``program`` meets it for the first time."""
        seen = self._signatures[program]
        if sig not in seen:
            seen.add(sig)
            self.compile_counts[program] += 1

    @staticmethod
    def _statics(fleet: FactorFleet) -> tuple:
        return (fleet.f_levels, fleet.b_levels, fleet.kind)

    @staticmethod
    def _plans(fleet: FactorFleet, handles) -> dict:
        """The bucket's sweep plans cut to the deepest of ``handles`` (the
        factors of the lanes a call serves; host ints, no device read)."""
        f_plan, b_plan = fleet.plans(
            max(h.n_levels_fwd for h in handles),
            max(h.n_levels_bwd for h in handles))
        return dict(f_plan=f_plan, b_plan=b_plan)

    # -- request lifecycle --------------------------------------------------
    def submit(self, req: SolveRequest) -> None:
        """Queue a request (validates routing and lane fit up front; the
        handle is pinned only once the request is actually accepted).
        The *cached* handle is preferred — a graph_id re-attached to a
        new factor routes new requests to the new factor immediately —
        with the pinned handle as fallback so an evicted-mid-flight
        graph keeps accepting work until it goes idle."""
        try:
            handle = self.cache.get(req.graph_id)  # raises on unknown graph
        except KeyError:
            # fallbacks, in order: a handle pinned by earlier traffic on
            # this graph, then a handle pre-pinned on the request itself
            # (a cluster router pins the routed factor so a TTL expiry /
            # LRU eviction between routing and this driver-side submit
            # cannot fail the request)
            handle = self._pinned.get(req.graph_id)
            if handle is None:
                handle = req._handle
            if handle is None:
                raise
        b = np.asarray(req.b)
        if b.ndim not in (1, 2) or b.shape[-1] != handle.n:
            raise ValueError(
                f"rhs must be (n,) or (nrhs, n) with n={handle.n}, "
                f"got {b.shape}")
        if not 1 <= req.nrhs <= self.slots:
            raise ValueError(
                f"request rid={req.rid} needs {req.nrhs} lanes but the "
                f"engine has {self.slots} slots")
        req._handle = handle
        self._pinned[req.graph_id] = handle
        if req.submit_time == 0.0:     # a frontend may pre-stamp at ingress
            req.submit_time = self._clock()
        req.submit_tick = self.ticks
        req._seq = self._seq
        self._seq += 1
        if req.deadline_s is not None:
            req._deadline_abs = req.submit_time + req.deadline_s
        self.queue.append(req)
        self.queue_peak = max(self.queue_peak, len(self.queue))

    def _bucket(self, fleet: FactorFleet) -> _BucketLanes:
        """Lane group for one ``(family, shape-bucket, K-tier)`` fleet.
        Keying by family keeps each family on its own step (the apply
        ``kind`` and level ceilings are part of its signature); keying by
        K-tier follows the cache's fleet sub-bucketing, so a hub-heavy
        factor's wide panels never ride in (and so never inflate) a
        narrow tier's step.  Every factor *within* a family-shape-tier
        still shares one step."""
        key = (fleet.family, fleet.n_pad, fleet.k_tier)
        bl = self._buckets.get(key)
        if bl is None:
            bl = self._buckets[key] = _BucketLanes(fleet, self.slots)
        return bl

    def _resync_buckets(self) -> None:
        """Catch up buckets whose fleet compacted since their resident
        ``fidx`` values were written: one write per affected bucket
        rewrites occupied lanes' factor indices from their handles (which
        compaction already updated) and points unoccupied lanes at row 0
        — their ``active`` flags are False, so the masked step discards
        whatever row they read, but the row must exist."""
        for bl in self._buckets.values():
            if bl.generation == bl.fleet.generation:
                continue
            fidx = np.zeros(self.slots, np.int32)
            occ = [i for i, lane in enumerate(self.lanes)
                   if lane is not None and lane.bucket is bl]
            for i in occ:
                fidx[i] = self.lanes[i].req._handle.fleet_row
            self._signature("sync", _shapes(bl.state)
                            + (_next_pow2(max(len(occ), 1)),))
            _sync_program(bl.state,
                          torch.from_numpy(fidx).to(bl.fleet.device))
            bl.generation = bl.fleet.generation
            self.fleet_resyncs += 1

    def _admit(self) -> None:
        """Scheduler-driven admission: the policy orders the waiting
        queue and decides which requests start this round (FIFO default:
        strict order with head-of-line blocking; backfill policies let
        narrow requests skip a blocked wide head, bounded by
        ``max_skips``).  One initialization and one row write per field
        per admitted request; host→device traffic is the request's rhs
        columns (the reference pads them to ``pow2(nrhs)`` rows and drops
        the pads in its scatter; torch has no drop mode, so the port
        writes the ``nrhs`` real columns only — a lane's iterates do not
        depend on the batch it is initialized in)."""
        free = [i for i, lane in enumerate(self.lanes) if lane is None]
        if not self.queue or not free:
            return
        # per-occupied-lane worst-case remaining ticks (a lane retires by
        # its maxiter budget; active lanes advance exactly iters_per_tick
        # iterations per tick) — the work-conserving seal path proves
        # candidates short against these bounds
        ipt = self.iters_per_tick
        busy = []
        for lane in self.lanes:
            if lane is not None:
                done = (self.ticks - lane.req.admit_tick) * ipt
                busy.append(-(-max(lane.req.maxiter - done, 1) // ipt))
        picked = self.admission.select(list(self.queue), len(free),
                                       now=self._clock(),
                                       busy_bounds=tuple(busy),
                                       iters_per_tick=ipt)
        for req in picked:
            if req.nrhs > len(free):   # defensive: policy overcommitted
                raise RuntimeError(
                    f"admission policy {self.admission.name!r} admitted "
                    f"rid={req.rid} ({req.nrhs} lanes) with only "
                    f"{len(free)} free")
            self.queue.remove(req)     # identity match (eq=False)
            self.admitted_reqs += 1
            self._m_admitted.inc()
            handle = req._handle       # fixed at submit: re-attaching the
            fleet = handle.fleet       # graph_id cannot hijack this request
            bl = self._bucket(fleet)
            j = req.nrhs
            rows = [free.pop(0) for _ in range(j)]
            dev = fleet.device
            B = np.zeros((j, fleet.n_pad), np.float32)
            B[:, :handle.n] = np.atleast_2d(np.asarray(req.b, np.float32))
            self._signature("admit", _shapes(fleet.arrays, bl.state)
                            + (_next_pow2(j),) + self._statics(fleet))
            act0 = _admit_program(
                fleet.arrays, bl.state,
                torch.tensor(rows, dtype=torch.int64, device=dev),
                torch.from_numpy(B).to(dev),
                torch.full((j,), handle.fleet_row, dtype=torch.int32,
                           device=dev),
                torch.full((j,), req.tol, dtype=torch.float32, device=dev),
                torch.full((j,), req.maxiter, dtype=torch.int32,
                           device=dev),
                **self._plans(fleet, [handle]), kind=fleet.kind)
            bl.n_active += int(act0.sum())
            self.cols_in += j
            req.admit_tick = self.ticks
            req.admit_time = self._clock()
            self._ev_admit(rid=req.rid, trace_id=req.trace_id,
                           gid=req.graph_id, nrhs=j, tick=self.ticks)
            for col, lane_i in enumerate(rows):
                self.lanes[lane_i] = _LaneRef(req, col, bl)

    # -- one engine tick ----------------------------------------------------
    def tick(self) -> List[SolveRequest]:
        """Admit, advance every bucket with active lanes by
        ``iters_per_tick`` PCG iterations (one step per bucket — all
        factors in the bucket ride the same call), retire finished lanes.
        Returns requests completed this tick."""
        with span("engine.tick") as sp:
            t_tick0 = self._clock()
            admitted0 = self.admitted_reqs
            with span("engine.resync"):
                self._resync_buckets()
            with span("engine.admit"):
                self._admit()
            if self.admission.evict_hopeless:
                self._evict_hopeless()
            done: List[SolveRequest] = []
            stepped = 0
            for bkey in sorted(self._buckets):
                bl = self._buckets[bkey]
                occ = [i for i, lane in enumerate(self.lanes)
                       if lane is not None and lane.bucket is bl]
                if not occ:
                    continue
                if bl.n_active > 0:
                    fl = bl.fleet
                    self._signature("step", _shapes(fl.arrays, bl.state)
                                    + self._statics(fl))
                    handles = [self.lanes[i].req._handle for i in occ]
                    with span("engine.step"):
                        bl.state = self._step_fn(
                            fl.arrays, bl.state, k=self.iters_per_tick,
                            **self._plans(fl, handles), kind=fl.kind)
                    stepped += 1
                    self._account_sweeps(bl, handles)
                with span("engine.flags"):
                    active = bl.state.active.cpu().numpy()  # (slots,) only
                frozen = [i for i in occ if not active[i]]
                bl.n_active = int(active[occ].sum())
                if frozen:
                    with span("engine.retire"):
                        done.extend(self._retire(bl, frozen))
            self._unpin_idle()
            self.ticks += 1
            self.cache.advance_ticks(1)
            if self.tracer is not None:
                # first host-side timestamp after a lane's first step call —
                # only when tracing is on (the stamp loop is pure host work,
                # but a trace nobody asked for is still overhead)
                t_first = self._clock()
                for lane in self.lanes:
                    if lane is not None and lane.req.first_tick_time == 0.0:
                        lane.req.first_tick_time = t_first
            # running *minimum* tick duration — the deadline-eviction lower
            # bound for "one more tick".  A minimum (not a mean) is the
            # safe estimator: compile-heavy first ticks must not inflate it
            # and spuriously evict meetable requests; underestimating only
            # delays eviction until the deadline has truly passed.  (An
            # injected constant clock keeps this at 0, so tests evict
            # exactly when the deadline passes.)
            dur = self._clock() - t_tick0
            self._est_tick_s = dur if self._est_tick_s == 0.0 else \
                min(self._est_tick_s, dur)
            self._m_ticks.inc()
            self._m_tick_s.observe(dur)
            self._m_queue.set(len(self.queue))
            self._m_lanes.set(sum(l is not None for l in self.lanes))
            if self.metrics is not None:
                self.metrics.maybe_sample(self._clock())
            if sp:
                sp.set(stepped=stepped, retired=len(done),
                       admitted=self.admitted_reqs - admitted0,
                       lanes=sum(l is not None for l in self.lanes))
            return done

    def _account_sweeps(self, bl: _BucketLanes, handles) -> None:
        """Host-side mirror of one stepped bucket's trisolve sweep work,
        in the reference's terms so the counters compare with it.

        ``sweep_elements`` counts the padded panel elements one
        preconditioner apply sweeps across the bucket's occupied lanes —
        ``lanes × n_pad × (Kf · fwd sweeps + Kb · bwd sweeps)`` for
        factor kinds (a level loop runs ``live_levels − 1`` sweeps over
        the full ``(n_pad, K)`` panel), ``lanes × n_pad × Kf`` for spmv
        kinds.  This is the padding tax K-tiering shrinks: untiered, a
        hub-heavy bucket-mate inflates ``Kf``/``Kb`` for every lane
        here.  ``sweeps_skipped`` counts the level sweeps the dynamic
        per-lane bounds elided vs the static bucket ceilings.  The port's
        sweeps read each level's rows and their live slots only, so
        ``sweep_elements`` counts the padded panel the reference sweeps,
        not the elements the port's kernel reads.  ``handles``: the
        occupied lanes' factors."""
        fl = bl.fleet
        if fl.kind == "factor":
            live_f = max(h.n_levels_fwd for h in handles)
            live_b = max(h.n_levels_bwd for h in handles)
            self.sweeps_skipped += (fl.f_levels - live_f) \
                + (fl.b_levels - live_b)
            per_lane = fl.n_pad * (fl.Kf * max(live_f - 1, 0)
                                   + fl.Kb * max(live_b - 1, 0))
        else:
            per_lane = fl.n_pad * fl.Kf
        self.sweep_elements += len(handles) * per_lane

    def _evict_hopeless(self) -> None:
        """Deadline eviction: a lane is *hopeless* once even an
        immediately-converging column could not retire before its
        deadline — it still needs at least one more tick, so
        ``now + est_tick_s`` (``est_tick_s`` = minimum observed tick
        duration, a lower bound) crossing the deadline proves the miss.
        Hopeless lanes are force-frozen on device (one flag write per
        bucket) and retire through the normal gather this
        same tick with ``status == "deadline_missed"``, freeing their
        fleet slots instead of iterating on to maxiter."""
        now = self._clock()
        doomed: Dict[_BucketLanes, List[int]] = {}
        for i, lane in enumerate(self.lanes):
            if lane is None:
                continue
            dl = lane.req._deadline_abs
            if dl is None:
                continue
            if lane.req._evicted or now + self._est_tick_s > dl:
                if not lane.req._evicted:
                    lane.req._evicted = True
                    self.deadline_evictions += 1
                    self._ev_evict(rid=lane.req.rid,
                                   trace_id=lane.req.trace_id,
                                   gid=lane.req.graph_id,
                                   reason="deadline")
                doomed.setdefault(lane.bucket, []).append(i)
        for bl, rows in doomed.items():
            self._signature("evict", _shapes(bl.state)
                            + (_next_pow2(len(rows)),))
            _evict_program(bl.state, torch.tensor(
                rows, dtype=torch.int64, device=bl.fleet.device))

    def _retire(self, bl: _BucketLanes,
                rows: List[int]) -> List[SolveRequest]:
        """Gather the finished columns (one gather; device→host traffic
        is exactly the retired columns), free their lanes, and complete
        requests whose last column retired."""
        j = len(rows)
        self._signature("gather", _shapes(bl.state) + (_next_pow2(j),))
        X, it, relres = _gather_program(bl.state, torch.tensor(
            rows, dtype=torch.int64, device=bl.fleet.device))
        X = X.cpu().numpy()
        it = it.cpu().numpy()
        relres = relres.cpu().numpy()
        self.cols_out += j
        done: List[SolveRequest] = []
        for k, lane_i in enumerate(rows):
            lane = self.lanes[lane_i]
            req = lane.req
            n = int(np.shape(req.b)[-1])
            req._partial[lane.col] = (X[k][:n], int(it[k]),
                                      float(relres[k]))
            self.lanes[lane_i] = None
            if len(req._partial) == req.nrhs:
                cols = [req._partial[c] for c in range(req.nrhs)]
                Xr = np.stack([c[0] for c in cols])
                req.iters = np.array([c[1] for c in cols])
                req.relres = np.array([c[2] for c in cols])
                req.converged = bool(np.all(req.relres <= req.tol))
                req.x = Xr[0] if np.ndim(req.b) == 1 else Xr
                req.finish_time = self._clock()
                req.finish_tick = self.ticks
                if req.converged:
                    req.status = "converged"
                elif req._evicted or (
                        req._deadline_abs is not None
                        and req.finish_time > req._deadline_abs):
                    # hopeless lane retired early, or a deadline request
                    # that ran its maxiter budget out past the deadline
                    req.status = "deadline_missed"
                else:
                    req.status = "maxiter"
                self._m_done.labels(replica=self._obs_rep_label,
                                    status=req.status).inc()
                self._m_latency.observe(req.latency_s)
                self._m_qwait.observe(req.queue_wait_s)
                it_max = int(req.iters.max())
                rr_max = float(req.relres.max())
                self._ev_retire(rid=req.rid, trace_id=req.trace_id,
                                gid=req.graph_id, status=req.status,
                                iters=it_max, relres=rr_max)
                if self.health is not None:
                    self.health.observe_retirement(
                        gid=req.graph_id, family=bl.fleet.family,
                        iters=it_max, relres=rr_max, status=req.status,
                        deadline_missed=req.status == "deadline_missed")
                if self.tracer is not None:
                    self.tracer.record(trace_from_request(
                        req, family=bl.fleet.family,
                        policy=self.admission.name,
                        replica=self._obs_replica,
                        device=self._obs_device))
                # release the factor ref: a completed request sitting in
                # the bounded history must not keep an evicted handle's
                # fleet row claimed (row recycling is weakref-driven)
                req._handle = None
                self.completed.append(req)
                self.n_completed += 1
                done.append(req)
        return done

    def _unpin_idle(self) -> None:
        """Release pins for graphs with no queued or active work.  The
        pinned handle is what keeps an evicted factor's fleet row (and
        with it the stacked device arrays) claimed, so dropping idle
        pins is also what lets the fleet recycle dead rows."""
        in_use = {r.graph_id for r in self.queue}
        in_use.update(lane.req.graph_id for lane in self.lanes
                      if lane is not None)
        for gid in [g for g in self._pinned if g not in in_use]:
            del self._pinned[gid]

    # -- driving loops ------------------------------------------------------
    @property
    def busy(self) -> bool:
        """True while any request is queued or holding lanes."""
        return bool(self.queue) or any(l is not None for l in self.lanes)

    def run_until_drained(self, max_ticks: int = 100_000
                          ) -> List[SolveRequest]:
        """Tick until queue and lanes are empty; returns every request
        completed during the drain, in completion order."""
        done: List[SolveRequest] = []
        for _ in range(max_ticks):
            if not self.busy:
                break
            done.extend(self.tick())
        return done

    def stats(self) -> EngineStats:
        """Point-in-time :class:`EngineStats` snapshot — scheduler
        counters, signature counts (the reference's compile counts) and
        host↔device column traffic (the counter glossary lives in
        ``docs/serving.md``)."""
        active = sum(l is not None for l in self.lanes)
        in_flight = len({id(l.req) for l in self.lanes if l is not None})
        sched = self.admission.counters()
        return EngineStats(
            ticks=self.ticks, completed=self.n_completed,
            queued=len(self.queue), active_lanes=active, slots=self.slots,
            factors=len(self.cache), buckets=len(self._buckets),
            families=len({fam for fam, _, _ in self._buckets}),
            step_compiles=self.compile_counts["step"],
            admit_compiles=self.compile_counts["admit"],
            gather_compiles=self.compile_counts["gather"],
            cols_in=self.cols_in, cols_out=self.cols_out,
            sweeps_skipped=self.sweeps_skipped,
            sweep_elements=self.sweep_elements,
            fleet_resyncs=self.fleet_resyncs,
            policy=self.admission.name,
            max_skips=self.admission.max_skips,
            admitted_reqs=self.admitted_reqs,
            in_flight_reqs=in_flight,
            sched_rounds=sched["sched_rounds"],
            backfill_skips=sched["backfill_skips"],
            skipped_reqs=sched["skipped_reqs"],
            barrier_rounds=sched["barrier_rounds"],
            sealed_backfills=sched.get("sealed_backfills", 0),
            deadline_evictions=self.deadline_evictions,
            queue_peak=self.queue_peak)
