"""``FactorCache`` / ``Solver`` — the factor→solve pipeline as a
multi-tenant API over the preconditioner families.

    cache = FactorCache(memory_budget_bytes=1 << 30)
    gid = cache.factor(graph, key_from_seed(0)).graph_id
    res = cache.solve(gid, b)        # (n,) or (nrhs, n) → fleet PCG

``factor`` runs the wavefront engine, derives both triangular schedules
on the device, and **admits the factor to its shape-bucket fleet**: a
:class:`FactorFleet` keyed by ``(family, n_pad = pow2(n), K-tier)`` that
stacks every member's padded Laplacian adjacency rows, row-indexed trisolve
panels and D⁻¹ into one :class:`pcg.FleetArrays`.  Solves read the stack
through each lane's row index, so factors of one bucket share the same
kernels and nothing is copied per solve.  The cache is an LRU keyed by a
content fingerprint of ``(graph, key)`` that evicts whole handles when
the device-memory budget or the handle count is exceeded, and supports
per-handle staleness (``ttl_s`` wall-clock / ``max_age_ticks`` service
ticks, clock injectable for tests).  A fleet compacts to its live rows
once enough of them died (``compact_threshold``).

Preconditioner families register by name (:func:`register_family`), as
the reference's do: ``"ac"`` (the randomized factor) and ``"ichol"``
(incomplete Cholesky as ``(G, D)``) of the ``"factor"`` kind, applied by
two level-swept triangular solves; ``"amg"`` (the flattened V-cycle) and
``"spai"`` (factored SPAI, ``M = GᵀG``) of the ``"spmv"`` kind, whose
materialized operator rides the forward panel and is applied by one
full-row ``ell_spmv_fleet`` launch.  An unregistered name raises
``KeyError``.

``Solver`` keeps the single-tenant surface (``factor`` then ``solve(B)``
against the most recent handle).
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.runtime import pad_k, resolve_device
from ..obs.flight import NULL_FLIGHT
from .laplacian import Graph, laplacian_adjacency
from .ref_ac import ACFactor, DeviceFactor
from .parac import factorize_wavefront, factorize_batched, _next_pow2
from .trisolve import PackedSchedule, build_schedules_batched
from .ichol import ichol_device_factor
from .amg import amg_ell_precond
from .spai import EllPrecond, spai_ell_precond
from .pcg import (PCGResult, FleetArrays, fleet_matvec, fleet_precondition,
                  pcg_fleet_solve, pcg_fleet_result)


_UNSET = object()


def graph_fingerprint(g: Graph, key=None, *, family: str = "ac",
                      params: Optional[Dict] = None) -> str:
    """Content hash of a graph and (optionally) the factorization key,
    preconditioner family and construction params — the cache identity
    of a preconditioner (the reference's bytes: n, src, dst, w, the raw
    uint32[2] key, then family and params unless ``"ac"`` without
    params)."""
    h = hashlib.blake2b(digest_size=12)
    h.update(np.int64(g.n).tobytes())
    h.update(np.ascontiguousarray(g.src).tobytes())
    h.update(np.ascontiguousarray(g.dst).tobytes())
    h.update(np.ascontiguousarray(g.w).tobytes())
    if key is not None:
        h.update(np.ascontiguousarray(np.asarray(key, np.uint32)).tobytes())
    if family != "ac" or params:
        h.update(family.encode())
        h.update(repr(sorted((params or {}).items())).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Preconditioner family registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrecondFamily:
    """One registered preconditioner family.  ``kind`` selects the
    fleet's apply (``"factor"``: two level-swept triangular solves over
    a ``(G, D)`` factor; ``"spmv"``: one lane-batched SpMV of a
    materialized approximate inverse); ``build`` constructs the payload,
    ``build(g, key, dtype=..., **params)`` — an ``ACFactor`` or
    ``DeviceFactor`` for the factor kind, an
    :class:`~repro_torch.core.spai.EllPrecond` for the spmv kind."""

    name: str
    kind: str
    build: Callable


PRECOND_FAMILIES: Dict[str, PrecondFamily] = {}


def register_family(name: str, kind: str, build: Callable) -> PrecondFamily:
    """Register (or replace) a preconditioner family; raises
    ``ValueError`` for an unknown ``kind``."""
    if kind not in ("factor", "spmv"):
        raise ValueError(f"unknown apply kind {kind!r}")
    fam = PrecondFamily(name=name, kind=kind, build=build)
    PRECOND_FAMILIES[name] = fam
    return fam


def get_family(name: str) -> PrecondFamily:
    """Look up a registered family; ``KeyError`` if there is none."""
    fam = PRECOND_FAMILIES.get(name)
    if fam is None:
        raise KeyError(f"unknown preconditioner family {name!r} "
                       f"(registered: {sorted(PRECOND_FAMILIES)})")
    return fam


register_family(
    "ac", "factor",
    # ``FactorCache.factor`` calls ``factorize_wavefront`` itself (and
    # ``factor_batched`` the batched engine); this is the single-graph
    # builder for callers that go through the registry
    lambda g, key, *, dtype=np.float32, chunk=64, fill_slack=32,
    strict=True, max_retries=3, device=None: factorize_wavefront(
        g, key, chunk=chunk, fill_slack=fill_slack, strict=strict,
        max_retries=max_retries, dtype=dtype, device=device))
register_family(
    "ichol", "factor",
    lambda g, key, *, dtype=np.float32, droptol=0.0, max_shift_tries=8:
    ichol_device_factor(g, droptol=droptol,
                        max_shift_tries=max_shift_tries, dtype=dtype))
register_family(
    "amg", "spmv",
    lambda g, key, *, dtype=np.float32, droptol=1e-3:
    amg_ell_precond(g, droptol=droptol, dtype=dtype))
register_family(
    "spai", "spmv",
    lambda g, key, *, dtype=np.float32, droptol=0.0:
    spai_ell_precond(g, droptol=droptol, dtype=dtype))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _grow(x: torch.Tensor, shape: Tuple[int, ...],
          value: int = 0) -> torch.Tensor:
    """Pad ``x`` with ``value`` (zeros by default) up to ``shape`` (every
    axis grows or stays)."""
    if tuple(x.shape) == tuple(shape):
        return x
    pad = []
    for s, t in reversed(list(zip(x.shape, shape))):
        pad += [0, t - s]
    return torch.nn.functional.pad(x, pad, value=value)


def _level_lists(level_of: torch.Tensor, n_levels: int, width: int):
    """One triangular solve's level row list: its rows sorted stably by
    level, each level's start offset in that list (``width`` entries,
    ``n`` from the end of the last level on, so every level past it is
    empty) and the row count per level (host ints)."""
    n = level_of.shape[0]
    rows = torch.sort(level_of, stable=True).indices.to(torch.int32)
    counts = torch.bincount(level_of.long(), minlength=n_levels)
    start = torch.full((width,), n, dtype=torch.int32,
                       device=level_of.device)
    start[0] = 0
    start[1:n_levels + 1] = torch.cumsum(counts, 0).to(torch.int32)
    return rows, start, counts.tolist()


def _max_rows(a: List[int], b: List[int]) -> List[int]:
    """Elementwise maximum of two per-level row counts."""
    n = max(len(a), len(b))
    a, b = a + [0] * (n - len(a)), b + [0] * (n - len(b))
    return [max(x, y) for x, y in zip(a, b)]


class _PaddedFactor:
    """One preconditioner's bucket-padded device arrays, ready for fleet
    admission: Laplacian adjacency rows, forward/backward
    :class:`PackedSchedule` panels and the padded inverse diagonal.

    ``"spmv"``-kind members reuse the container (:meth:`from_ell`): the
    approximate inverse's ELL rows ride in the forward panel, one level
    holding every row (the SpMV apply never sweeps), the backward panel
    is inert and 1 wide and ``dinv`` is zero."""

    __slots__ = ("n", "n_pad", "lnbr", "lw", "fwd", "bwd", "dinv")

    def __init__(self, g: Graph, dev: DeviceFactor, fwd: PackedSchedule,
                 bwd: PackedSchedule):
        self.n = g.n
        self.n_pad = fwd.n_pad
        nbr, w = laplacian_adjacency(g, n_rows=self.n_pad)
        d = dev.D.device
        self.lnbr = torch.from_numpy(nbr).to(d)
        self.lw = torch.from_numpy(w).to(d)
        D = dev.D
        dinv = torch.where(D > 0, 1.0 / torch.where(D > 0, D, 1.0), 0.0)
        self.dinv = _grow(dinv, (self.n_pad,))
        self.fwd = fwd
        self.bwd = bwd

    @classmethod
    def from_ell(cls, g: Graph, op: EllPrecond, device) -> "_PaddedFactor":
        """The fleet-admissible view of a materialized approximate inverse
        on ``device``: its ELL rows become a 1-level forward panel whose
        padding rows and slots hold zero values, so they add exactly zero
        to the lane-batched SpMV.  Every true row's live length is the
        panel width K (the full-row apply reads all of it)."""
        n_pad = max(_next_pow2(g.n), 1)
        cols = _grow(torch.as_tensor(op.cols, dtype=torch.int32,
                                     device=device), (n_pad, op.K))
        vals = _grow(torch.as_tensor(op.vals, device=device), (n_pad, op.K))
        zeros_n = torch.zeros((n_pad,), dtype=torch.int32, device=device)
        row_len = zeros_n.clone()
        row_len[:g.n] = op.K
        fwd = PackedSchedule(n=g.n, n_pad=n_pad, n_levels=1, K=op.K,
                             cols=cols, vals=vals, level_of=zeros_n,
                             row_len=row_len)
        bwd = PackedSchedule(
            n=g.n, n_pad=n_pad, n_levels=1, K=1,
            cols=torch.zeros((n_pad, 1), dtype=torch.int32, device=device),
            vals=torch.zeros((n_pad, 1), dtype=vals.dtype, device=device),
            level_of=zeros_n, row_len=zeros_n)
        dev = DeviceFactor(
            col_ptr=torch.zeros((g.n + 1,), dtype=torch.int32,
                                device=device),
            rows=torch.zeros((0,), dtype=torch.int32, device=device),
            vals=torch.zeros((0,), dtype=vals.dtype, device=device),
            D=torch.zeros((g.n,), dtype=vals.dtype, device=device))
        return cls(g, dev, fwd, bwd)


class FactorFleet:
    """Stacked, bucket-padded factors of one ``(family, n_pad, k_tier)``,
    plus the row bookkeeping that lets handles come and go.  ``arrays``
    is the live :class:`pcg.FleetArrays` stack; ``f_rows``/``b_rows``
    keep on the host the largest row count per level of any member
    admitted, forward and backward (the level sweeps' launch grids; their
    lengths are the bucket's level ceilings).  Rows are claimed by
    weak reference: a row frees itself onto a min-heap when its handle
    dies, and admission reuses dead rows (lowest first) before growing
    the stack.  Growth along any axis zero-pads — padding Laplacian slots
    and panel slots carry zero weights — and pads level starts with
    ``n_pad`` (an empty level), so members' solves are unchanged by it.
    :meth:`compact` is the inverse: it rebuilds the stack to the live
    rows and bumps ``generation`` so an engine holding lane state keyed
    by old row indices re-syncs them."""

    def __init__(self, n_pad: int, family: str = "ac", kind: str = "factor",
                 k_tier: int = 0, device=None):
        self.n_pad = n_pad
        self.family = family
        self.kind = kind
        self.k_tier = k_tier
        self.device = device
        self.Kl = 1
        self.Kf = 1
        self.Kb = 1
        self.f_rows: List[int] = [0]   # per-level row maxima (host)
        self.b_rows: List[int] = [0]
        self.generation = 0        # bumped by compact(): row indices moved
        self.compactions = 0
        self.arrays: Optional[FleetArrays] = None
        self._rows: List[Optional[weakref.ref]] = []
        self._free: List[int] = []
        self._ref2row: Dict[weakref.ref, int] = {}

    @property
    def f_levels(self) -> int:
        """Bucket-wide forward level ceiling."""
        return len(self.f_rows)

    @property
    def b_levels(self) -> int:
        """Bucket-wide backward level ceiling."""
        return len(self.b_rows)

    @property
    def capacity(self) -> int:
        return 0 if self.arrays is None else int(self.arrays.nvalid.shape[0])

    @property
    def live_rows(self) -> int:
        return sum(r is not None and r() is not None for r in self._rows)

    @property
    def free_rows(self) -> int:
        """Rows admittable without growing the stack: dead rows awaiting
        reuse plus the capacity past the current end."""
        return len(self._free) + max(self.capacity - len(self._rows), 0)

    @property
    def bytes_per_row(self) -> int:
        if self.arrays is None:
            return 0
        return sum(_nbytes(x) // x.shape[0] for x in self.arrays)

    @property
    def device_bytes(self) -> int:
        """The whole stack, dead rows and capacity slack included."""
        return 0 if self.arrays is None else \
            sum(_nbytes(x) for x in self.arrays)

    @property
    def resident_device(self) -> Optional[str]:
        """Where the stack lives, read from its arrays (the pinned
        device before the first admission)."""
        if self.arrays is None:
            return None if self.device is None else str(self.device)
        return str(self.arrays.lnbr.device)

    def _row_died(self, ref: weakref.ref) -> None:
        row = self._ref2row.pop(ref, None)
        if row is not None and row < len(self._rows) \
                and self._rows[row] is ref:
            self._rows[row] = None
            heapq.heappush(self._free, row)

    def _claim_rows(self, k: int) -> List[int]:
        rows: List[int] = []
        while len(rows) < k and self._free:
            rows.append(heapq.heappop(self._free))
        nxt = len(self._rows)
        while len(rows) < k:
            rows.append(nxt)
            nxt += 1
        return rows

    def admit_many(self, pairs: Sequence[Tuple["PreconditionerHandle",
                                               _PaddedFactor]]) -> List[int]:
        """Admit ``B`` factors in one stack update: the stack grows once to
        the batch-wide ``(capacity, K)`` envelope and every new row lands
        in one indexed write per field.  Returns the claimed rows, in
        ``pairs`` order."""
        if not pairs:
            return []
        assert all(pf.n_pad == self.n_pad for _, pf in pairs)
        Kl = max(self.Kl, *(pf.lnbr.shape[1] for _, pf in pairs))
        Kf = max(self.Kf, *(pf.fwd.K for _, pf in pairs))
        Kb = max(self.Kb, *(pf.bwd.K for _, pf in pairs))
        pfs = [pf for _, pf in pairs]
        Lf = max(self.f_levels, *(p.fwd.n_levels for p in pfs))
        Lb = max(self.b_levels, *(p.bwd.n_levels for p in pfs))
        rows = self._claim_rows(len(pairs))
        F = max(_next_pow2(max(rows) + 1), self.capacity)
        np_ = self.n_pad
        dev = self.device
        i32, f32 = torch.int32, torch.float32
        a = self.arrays
        if a is None:
            def z(shape, dt):
                return torch.zeros(shape, dtype=dt, device=dev)
            a = FleetArrays(
                lnbr=z((F, np_, Kl), i32), lw=z((F, np_, Kl), f32),
                fcols=z((F, np_, Kf), i32), fvals=z((F, np_, Kf), f32),
                flen=z((F, np_), i32),
                frows=z((F, np_), i32),
                fstart=torch.full((F, Lf + 1), np_, dtype=i32, device=dev),
                bcols=z((F, np_, Kb), i32), bvals=z((F, np_, Kb), f32),
                blen=z((F, np_), i32),
                brows=z((F, np_), i32),
                bstart=torch.full((F, Lb + 1), np_, dtype=i32, device=dev),
                dinv=z((F, np_), f32),
                nvalid=z((F,), i32), fnlv=torch.ones(F, dtype=i32, device=dev),
                bnlv=torch.ones(F, dtype=i32, device=dev))
        else:
            a = FleetArrays(
                lnbr=_grow(a.lnbr, (F, np_, Kl)),
                lw=_grow(a.lw, (F, np_, Kl)),
                fcols=_grow(a.fcols, (F, np_, Kf)),
                fvals=_grow(a.fvals, (F, np_, Kf)),
                flen=_grow(a.flen, (F, np_)),
                frows=_grow(a.frows, (F, np_)),
                fstart=_grow(a.fstart, (F, Lf + 1), value=np_),
                bcols=_grow(a.bcols, (F, np_, Kb)),
                bvals=_grow(a.bvals, (F, np_, Kb)),
                blen=_grow(a.blen, (F, np_)),
                brows=_grow(a.brows, (F, np_)),
                bstart=_grow(a.bstart, (F, Lb + 1), value=np_),
                dinv=_grow(a.dinv, (F, np_)),
                nvalid=_grow(a.nvalid, (F,)),
                fnlv=torch.clamp(_grow(a.fnlv, (F,)), min=1),
                bnlv=torch.clamp(_grow(a.bnlv, (F,)), min=1))
        ix = torch.tensor(rows, dtype=torch.int64, device=dev)
        flists = [_level_lists(p.fwd.level_of, p.fwd.n_levels, Lf + 1)
                  for p in pfs]
        blists = [_level_lists(p.bwd.level_of, p.bwd.n_levels, Lb + 1)
                  for p in pfs]

        def put(x, vals):
            x[ix] = torch.stack([v.to(dev) for v in vals])

        put(a.lnbr, [_grow(p.lnbr, (np_, Kl)) for p in pfs])
        put(a.lw, [_grow(p.lw, (np_, Kl)) for p in pfs])
        put(a.fcols, [_grow(p.fwd.cols, (np_, Kf)) for p in pfs])
        put(a.fvals, [_grow(p.fwd.vals, (np_, Kf)) for p in pfs])
        put(a.flen, [p.fwd.row_len for p in pfs])
        put(a.frows, [r for r, _, _ in flists])
        put(a.fstart, [st for _, st, _ in flists])
        put(a.bcols, [_grow(p.bwd.cols, (np_, Kb)) for p in pfs])
        put(a.bvals, [_grow(p.bwd.vals, (np_, Kb)) for p in pfs])
        put(a.blen, [p.bwd.row_len for p in pfs])
        put(a.brows, [r for r, _, _ in blists])
        put(a.bstart, [st for _, st, _ in blists])
        put(a.dinv, [p.dinv for p in pfs])
        a.nvalid[ix] = torch.tensor([p.n for p in pfs], dtype=i32, device=dev)
        a.fnlv[ix] = torch.tensor([p.fwd.n_levels for p in pfs], dtype=i32,
                                  device=dev)
        a.bnlv[ix] = torch.tensor([p.bwd.n_levels for p in pfs], dtype=i32,
                                  device=dev)
        self.arrays = a
        self.Kl, self.Kf, self.Kb = Kl, Kf, Kb
        for _, _, counts in flists:
            self.f_rows = _max_rows(self.f_rows, counts)
        for _, _, counts in blists:
            self.b_rows = _max_rows(self.b_rows, counts)
        for (handle, _), row in zip(pairs, rows):
            ref = weakref.ref(handle, self._row_died)
            self._ref2row[ref] = row
            if row == len(self._rows):
                self._rows.append(ref)
            else:
                self._rows[row] = ref
        return rows

    def compact(self) -> int:
        """Rebuild the stack to its live rows: one gather per field down
        to the live set, capacity re-padded to ``pow2(live)``.  Live
        handles' ``fleet_row`` is rewritten and ``generation`` bumped so
        an engine re-syncs its lanes' factor indices before its next
        step.  Row contents are copied verbatim, so every live handle's
        solve is bit-identical before and after.  ``f_rows``/``b_rows``
        (the per-level row maxima) keep the values of every member ever
        admitted, as the reference keeps its level ceilings: a sweep then
        may launch rows for which no live member has work, which changes
        no result.  Returns the number of freed stack rows."""
        if self.arrays is None:
            return 0
        live: List[Tuple[int, "PreconditionerHandle"]] = []
        for i, r in enumerate(self._rows):
            h = r() if r is not None else None
            if h is not None:
                live.append((i, h))
        old_cap = self.capacity
        new_cap = max(_next_pow2(len(live)), 1)
        if new_cap >= old_cap:
            return 0
        a = self.arrays
        ix = torch.tensor([i for i, _ in live], dtype=torch.int64,
                          device=a.lnbr.device)
        fill = dict(fstart=self.n_pad, bstart=self.n_pad, fnlv=1, bnlv=1)
        self.arrays = FleetArrays(**{
            name: _grow(x[ix], (new_cap,) + tuple(x.shape[1:]),
                        value=fill.get(name, 0))
            for name, x in zip(a._fields, a)})
        freed = old_cap - new_cap
        self._ref2row.clear()               # retire old refs (their
        self._free = []                     # callbacks become no-ops)
        self._rows = []
        for new_row, (_, h) in enumerate(live):
            h.fleet_row = new_row
            ref = weakref.ref(h, self._row_died)
            self._ref2row[ref] = new_row
            self._rows.append(ref)
        self.generation += 1
        self.compactions += 1
        return freed


@dataclasses.dataclass(eq=False)
class PreconditionerHandle:
    """A constructed preconditioner ready to serve solves — the one
    interface every family presents to the cache, the engine and direct
    callers.  Its data lives in its bucket's :class:`FactorFleet`
    (``fleet`` + ``fleet_row``); ``factor`` is the family payload
    (``ACFactor`` / ``DeviceFactor`` / ``EllPrecond``)."""

    graph: Graph
    factor: object
    fleet: FactorFleet
    fleet_row: int
    n_levels_fwd: int
    n_levels_bwd: int
    graph_id: str = ""
    family: str = "ac"
    construct_s: float = 0.0
    born_s: float = 0.0
    born_tick: int = 0
    ttl_s: Optional[float] = None
    max_age_ticks: Optional[int] = None

    @property
    def n(self) -> int:
        return self.graph.n

    @property
    def n_pad(self) -> int:
        return self.fleet.n_pad

    @property
    def kind(self) -> str:
        return self.fleet.kind

    @property
    def n_levels(self) -> int:
        """Forward critical-path length (levels; 1 for ``"spmv"``
        families, whose apply is level-free)."""
        return self.n_levels_fwd

    @property
    def device(self) -> torch.device:
        return self.fleet.device

    @property
    def device_bytes(self) -> int:
        """The handle's row of the fleet stack plus, for factor kinds, its
        compact device factor (resident on the cache's device beside the
        stack; an spmv payload is host-side: its device copy is the fleet
        row)."""
        f = self.factor
        own = sum(_nbytes(t) for t in f.to_device()) \
            if isinstance(f, (ACFactor, DeviceFactor)) else 0
        return own + self.fleet.bytes_per_row

    def _fidx(self, L: int) -> torch.Tensor:
        return torch.full((L,), self.fleet_row, dtype=torch.int32,
                          device=self.device)

    def _pad(self, B: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((B.shape[0], self.n_pad), dtype=torch.float32,
                          device=self.device)
        out[:, :self.n] = B
        return out

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``L x`` through the handle's fleet row (the adjacency rows
        already in the bucket stack)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return fleet_matvec(self.fleet.arrays, self._fidx(1),
                            self._pad(x[None]))[0, :self.n]

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        """``r -> (G D Gᵀ)⁺ r`` for factor kinds, ``r -> M r`` for spmv
        kinds, for ``r`` of shape ``(n,)`` or ``(n, nrhs)`` (columns
        become lanes)."""
        r = torch.as_tensor(r, dtype=torch.float32, device=self.device)
        R = r[None] if r.dim() == 1 else r.T
        out = fleet_precondition(self.fleet.arrays, self._fidx(R.shape[0]),
                                 self._pad(R), f_rows=self.fleet.f_rows,
                                 b_rows=self.fleet.b_rows,
                                 kind=self.fleet.kind)[:, :self.n]
        return out[0] if r.dim() == 1 else out.T

    def solve(self, B, *, tol: float = 1e-6, maxiter: int = 1000,
              project: bool = True) -> PCGResult:
        """PCG-solve ``L x = b``: ``B`` is ``(n,)`` for one rhs or
        ``(nrhs, n)`` for a batch (every column a lane of this factor)."""
        B = torch.as_tensor(B, dtype=torch.float32, device=self.device)
        if B.dim() not in (1, 2) or B.shape[-1] != self.n:
            raise ValueError(f"rhs must be (n,) or (nrhs, n) with n={self.n}, "
                             f"got {tuple(B.shape)}")
        B2 = B[None] if B.dim() == 1 else B
        L = B2.shape[0]
        state = pcg_fleet_solve(
            self.fleet.arrays, self._fidx(L), self._pad(B2),
            torch.full((L,), tol, dtype=torch.float32, device=self.device),
            torch.full((L,), maxiter, dtype=torch.int32, device=self.device),
            f_rows=self.fleet.f_rows, b_rows=self.fleet.b_rows,
            kind=self.fleet.kind, project=project)
        res = pcg_fleet_result(state, self.n)
        if B.dim() == 1:
            return PCGResult(x=res.x[0], iters=res.iters[0],
                             relres=res.relres[0],
                             converged=res.converged[0])
        return res


FactorHandle = PreconditionerHandle


class FactorCache:
    """Multi-tenant factor-once / solve-many frontend.

    ``factor`` (or ``factor_batched`` / ``attach`` / ``adopt``) admits
    handles keyed by graph fingerprint; ``solve(graph_id, B)`` routes a
    rhs to its factor.  Admission evicts least-recently-used handles while
    the summed ``device_bytes`` exceeds ``memory_budget_bytes`` (or the
    handle count exceeds ``max_handles``) — the newest handle is never
    evicted.  ``k_tiering`` sub-buckets fleets by the pow2 panel width so
    one wide factor does not widen its bucket-mates' sweeps.

    Staleness: handles admitted with ``ttl_s`` (seconds, against the
    injected ``clock``) or ``max_age_ticks`` (service ticks, advanced by
    ``advance_ticks`` — a serving engine calls it once per tick) expire
    on the next lookup or admission sweep.  After evictions and expiries
    a fleet whose free rows reach ``compact_threshold`` of its capacity
    is compacted.  Everything runs on ``device`` (the GPU unless the CPU
    is asked for).
    """

    def __init__(self, *, chunk: int = 64, fill_slack: int = 32,
                 strict: bool = True, max_retries: int = 3,
                 dtype=np.float32, memory_budget_bytes: Optional[int] = None,
                 max_handles: Optional[int] = None,
                 ttl_s: Optional[float] = None,
                 max_age_ticks: Optional[int] = None,
                 k_tiering: bool = True,
                 compact_threshold: Optional[float] = 0.5,
                 device=None, clock: Optional[Callable[[], float]] = None,
                 flight=None):
        self.chunk = chunk
        self.fill_slack = fill_slack
        self.strict = strict
        self.max_retries = max_retries
        self.dtype = dtype
        self.memory_budget_bytes = memory_budget_bytes
        self.max_handles = max_handles
        self.ttl_s = ttl_s
        self.max_age_ticks = max_age_ticks
        self.k_tiering = k_tiering
        self.compact_threshold = compact_threshold
        self.device = resolve_device(device)
        self._clock = clock if clock is not None else time.monotonic
        self.now_ticks = 0
        # one-way latch: True once any handle carries a staleness policy,
        # so sweep_stale() stays O(1) for caches that never use one
        self._has_mortal = False
        self._handles: "OrderedDict[str, PreconditionerHandle]" = \
            OrderedDict()
        self._fleets: Dict[Tuple[str, int, int], FactorFleet] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
        self.compactions = 0
        self.adoptions = 0
        fl = flight if flight is not None else NULL_FLIGHT
        self._ev_cache_evict = fl.bind("cache_evict")
        self._ev_cache_expire = fl.bind("cache_expire")
        self._ev_compaction = fl.bind("compaction")
        self._ev_adopt = fl.bind("adopt")

    # -- staleness ----------------------------------------------------------
    def advance_ticks(self, k: int = 1) -> None:
        """Advance the service tick clock (engines call this per tick)."""
        self.now_ticks += k

    def _stale(self, h: PreconditionerHandle, now_s: float) -> bool:
        if h.ttl_s is not None and now_s - h.born_s > h.ttl_s:
            return True
        if h.max_age_ticks is not None and \
                self.now_ticks - h.born_tick > h.max_age_ticks:
            return True
        return False

    def _refresh_policy(self, h: PreconditionerHandle, ttl_s,
                        max_age_ticks) -> None:
        """Explicit staleness arguments on a cache hit re-admit the
        handle: its policy is replaced and its birth stamps reset."""
        if ttl_s is _UNSET and max_age_ticks is _UNSET:
            return
        if ttl_s is not _UNSET:
            h.ttl_s = ttl_s
        if max_age_ticks is not _UNSET:
            h.max_age_ticks = max_age_ticks
        h.born_s = self._clock()
        h.born_tick = self.now_ticks
        if h.ttl_s is not None or h.max_age_ticks is not None:
            self._has_mortal = True

    def sweep_stale(self) -> int:
        """Evict every expired handle; returns how many were evicted."""
        if not self._has_mortal:
            return 0
        now_s = self._clock()
        stale = [gid for gid, h in self._handles.items()
                 if self._stale(h, now_s)]
        for gid in stale:
            del self._handles[gid]
            self.expirations += 1
            self._ev_cache_expire(gid=gid)
        if stale:
            self._maybe_compact()
        return len(stale)

    def _compact_fleet(self, fleet: FactorFleet) -> bool:
        if not fleet.compact():
            return False
        self.compactions += 1
        self._ev_compaction(family=fleet.family, n_pad=fleet.n_pad,
                            k_tier=fleet.k_tier)
        return True

    def _maybe_compact(self) -> int:
        """Compact every fleet whose free-row share reached
        ``compact_threshold``; returns how many were compacted."""
        if self.compact_threshold is None:
            return 0
        return sum(self._compact_fleet(f) for f in self._fleets.values()
                   if f.capacity
                   and f.free_rows / f.capacity >= self.compact_threshold)

    def compact(self) -> int:
        """Compact every fleet to its live rows, threshold ignored;
        returns how many fleets shrank."""
        return sum(self._compact_fleet(f) for f in self._fleets.values())

    # -- admission ----------------------------------------------------------
    def factor(self, g: Graph, key, *, graph_id: Optional[str] = None,
               family: str = "ac", precond_params: Optional[Dict] = None,
               ttl_s=_UNSET, max_age_ticks=_UNSET) -> PreconditionerHandle:
        """Construct a preconditioner for ``g`` (``key``: the raw
        uint32[2] factorization key) and admit the handle — a cache hit
        if the same ``(graph, key, family, params)`` is live and fresh.
        Raises ``KeyError`` for an unregistered ``family``."""
        self.sweep_stale()
        fam = get_family(family)
        params = dict(precond_params or {})
        gid = graph_id if graph_id is not None else graph_fingerprint(
            g, key if family == "ac" else None, family=family,
            params=params)
        got = self._handles.get(gid)
        if got is not None:
            self.hits += 1
            self._handles.move_to_end(gid)
            self._refresh_policy(got, ttl_s, max_age_ticks)
            return got
        self.misses += 1
        t0 = time.perf_counter()
        if family == "ac":
            f = factorize_wavefront(
                g, key, chunk=self.chunk, fill_slack=self.fill_slack,
                strict=self.strict, max_retries=self.max_retries,
                dtype=self.dtype, device=self.device, **params)
        else:
            f = fam.build(g, key, dtype=self.dtype, **params)
        handle = self.attach(g, f, graph_id=gid, family=family,
                             ttl_s=ttl_s, max_age_ticks=max_age_ticks)
        handle.construct_s = time.perf_counter() - t0
        return handle

    def factor_batched(self, gs: Sequence[Graph], keys, *,
                       graph_ids: Optional[Sequence[str]] = None,
                       ttl_s=_UNSET, max_age_ticks=_UNSET
                       ) -> List[PreconditionerHandle]:
        """Admit a fleet: graphs not already cached factor together in one
        batched engine run, their schedules in one batched pass."""
        self.sweep_stale()
        gs = list(gs)
        keys = [np.asarray(k, np.uint32).reshape(2) for k in
                (keys if isinstance(keys, (list, tuple))
                 else np.asarray(keys).reshape(-1, 2))]
        gids = list(graph_ids) if graph_ids is not None else [
            graph_fingerprint(g, keys[i]) for i, g in enumerate(gs)]
        todo = [i for i, gid in enumerate(gids) if gid not in self._handles]
        self.hits += len(gs) - len(todo)
        self.misses += len(todo)
        for gid in set(gids) - {gids[i] for i in todo}:
            self._refresh_policy(self._handles[gid], ttl_s, max_age_ticks)
        # strong refs for the whole call: a tight budget may evict a
        # sibling mid-admission, and the caller still gets every handle
        fleet = {gid: self._handles[gid] for gid in gids
                 if gid in self._handles}
        if todo:
            fs, scheds = factorize_batched(
                [gs[i] for i in todo], [keys[i] for i in todo],
                chunk=self.chunk, fill_slack=self.fill_slack,
                strict=self.strict, max_retries=self.max_retries,
                dtype=self.dtype, with_schedules=True, device=self.device)
            fleet.update(self._attach_many(
                [(gs[i], f, sch, gids[i], "ac")
                 for i, f, sch in zip(todo, fs, scheds)],
                ttl_s=ttl_s, max_age_ticks=max_age_ticks))
        for gid in gids:
            if gid in self._handles:
                self._handles.move_to_end(gid)
        return [fleet[gid] for gid in gids]

    def attach(self, g: Graph, f, *,
               graph_id: Optional[str] = None, family: str = "ac",
               schedules: Optional[Tuple[PackedSchedule,
                                         PackedSchedule]] = None,
               ttl_s=_UNSET, max_age_ticks=_UNSET) -> PreconditionerHandle:
        """Wrap an existing family payload (the sequential oracle's
        factor, one carried across from the reference package by
        ``convert``, a pre-built ``EllPrecond``, ...) in a solve handle and
        admit it to its fleet — no re-construction."""
        gid = graph_id if graph_id is not None else graph_fingerprint(
            g, family=family)
        (_, handle), = self._attach_many([(g, f, schedules, gid, family)],
                                         ttl_s=ttl_s,
                                         max_age_ticks=max_age_ticks)
        return handle

    def adopt(self, g: Graph, f, *, graph_id: str,
              family: str = "ac",
              schedules: Optional[Tuple[PackedSchedule,
                                        PackedSchedule]] = None,
              construct_s: float = 0.0, ttl_s=_UNSET,
              max_age_ticks=_UNSET) -> PreconditionerHandle:
        """Admit a factor constructed elsewhere (another cache, another
        process, the reference package through ``convert``): transfer to
        this cache's device and fleet admission only, never a factor.  A
        live fresh handle for ``graph_id`` is a hit (adopt is
        idempotent); ``construct_s`` records the construction time
        spent where the factor was built."""
        self.sweep_stale()
        got = self._handles.get(graph_id)
        if got is not None:
            self.hits += 1
            self._handles.move_to_end(graph_id)
            self._refresh_policy(got, ttl_s, max_age_ticks)
            return got
        handle = self.attach(g, f, graph_id=graph_id, family=family,
                             schedules=schedules, ttl_s=ttl_s,
                             max_age_ticks=max_age_ticks)
        handle.construct_s = construct_s
        self.adoptions += 1
        self._ev_adopt(gid=graph_id, family=family, construct_s=construct_s)
        return handle

    def _attach_many(self, items, *, ttl_s=_UNSET, max_age_ticks=_UNSET
                     ) -> List[Tuple[str, PreconditionerHandle]]:
        """Admit ``(graph, payload, schedules|None, gid, family)`` items,
        grouped by fleet so each stack grows once; the budget sweep runs
        at the end."""
        built = []
        for g, f, schedules, gid, family in items:
            fam = get_family(family)
            if fam.kind == "spmv":
                pf = _PaddedFactor.from_ell(g, f, self.device)
                fwd, bwd = pf.fwd, pf.bwd
            else:
                dev = f.to_device(self.device)
                if isinstance(f, DeviceFactor):
                    f = dev     # the compact factor stays resident
                if schedules is None:
                    schedules = build_schedules_batched([dev])[0]
                fwd, bwd = schedules
                pf = _PaddedFactor(g, dev, fwd, bwd)
            k_tier = pad_k(max(fwd.K, bwd.K)) if self.k_tiering else 0
            fkey = (family, pf.n_pad, k_tier)
            fleet = self._fleets.get(fkey)
            if fleet is None:
                fleet = self._fleets[fkey] = FactorFleet(
                    pf.n_pad, family=family, kind=fam.kind, k_tier=k_tier,
                    device=self.device)
            handle = PreconditionerHandle(
                graph=g, factor=f, fleet=fleet, fleet_row=-1,
                n_levels_fwd=fwd.n_levels, n_levels_bwd=bwd.n_levels,
                graph_id=gid, family=family, born_s=self._clock(),
                born_tick=self.now_ticks,
                ttl_s=self.ttl_s if ttl_s is _UNSET else ttl_s,
                max_age_ticks=(self.max_age_ticks if max_age_ticks is _UNSET
                               else max_age_ticks))
            built.append((fleet, handle, pf, gid))
        by_fleet: Dict[Tuple[str, int, int], list] = {}
        for fleet, handle, pf, _ in built:
            by_fleet.setdefault((fleet.family, fleet.n_pad, fleet.k_tier),
                                []).append((handle, pf))
        for fkey, pairs in by_fleet.items():
            for (handle, _), row in zip(pairs,
                                        self._fleets[fkey].admit_many(pairs)):
                handle.fleet_row = row
        out = []
        for _, handle, _, gid in built:
            if handle.ttl_s is not None or handle.max_age_ticks is not None:
                self._has_mortal = True
            self._handles[gid] = handle
            self._handles.move_to_end(gid)
            out.append((gid, handle))
        self._shrink()
        return out

    def _shrink(self) -> None:
        """Evict LRU handles until the budget/count bounds hold (the newest
        handle always survives)."""
        evicted = False
        while len(self._handles) > 1 and (
                (self.max_handles is not None
                 and len(self._handles) > self.max_handles)
                or (self.memory_budget_bytes is not None
                    and self.device_bytes > self.memory_budget_bytes)):
            gid, _ = self._handles.popitem(last=False)
            self.evictions += 1
            self._ev_cache_evict(gid=gid, reason="budget")
            evicted = True
        if evicted:
            self._maybe_compact()

    # -- lookup / routing ---------------------------------------------------
    def peek(self, graph_id: str) -> Optional[PreconditionerHandle]:
        """Lookup that neither sweeps staleness nor touches LRU order."""
        return self._handles.get(graph_id)

    def fresh(self, graph_id: str) -> bool:
        """True iff ``graph_id`` has a live handle that the next lookup
        would not sweep as stale (reads only)."""
        h = self._handles.get(graph_id)
        return h is not None and not self._stale(h, self._clock())

    def capacity_probe(self) -> Dict[str, Optional[int]]:
        """Read-only headroom snapshot: how much more factor state this
        cache admits before evicting (``None`` where a bound is unset) and
        the fleet rows reusable without growing a stack."""
        handles = list(self._handles.values())
        fleets = list(self._fleets.values())
        used = sum(h.device_bytes for h in handles)
        free_bytes = None if self.memory_budget_bytes is None else \
            max(self.memory_budget_bytes - used, 0)
        free_handles = None if self.max_handles is None else \
            max(self.max_handles - len(handles), 0)
        return dict(handles=len(handles), free_handles=free_handles,
                    device_bytes=used, free_bytes=free_bytes,
                    fleet_free_rows=sum(f.free_rows for f in fleets))

    def get(self, graph_id: str) -> PreconditionerHandle:
        self.sweep_stale()
        handle = self._handles.get(graph_id)
        if handle is None:
            raise KeyError(f"no live factor for graph_id={graph_id!r} "
                           f"({len(self._handles)} cached)")
        self._handles.move_to_end(graph_id)
        return handle

    def __contains__(self, graph_id: str) -> bool:
        return graph_id in self._handles

    def __len__(self) -> int:
        return len(self._handles)

    @property
    def graph_ids(self) -> List[str]:
        return list(self._handles)

    @property
    def device_bytes(self) -> int:
        return sum(h.device_bytes for h in self._handles.values())

    @property
    def fleets(self) -> Dict[Tuple[str, int, int], FactorFleet]:
        """Live fleets keyed by ``(family, n_pad, k_tier)`` (a copy)."""
        return dict(self._fleets)

    def evict(self, graph_id: str) -> None:
        if self._handles.pop(graph_id, None) is not None:
            self.evictions += 1
            self._ev_cache_evict(gid=graph_id, reason="explicit")
            self._maybe_compact()

    def clear(self) -> None:
        self._handles.clear()

    def stats(self) -> Dict:
        """Cache counters and device-memory accounting: totals, per
        family and per device the stack actually lives on, and the live
        floor a compaction shrinks toward (``fleet_live_bytes``)."""
        handles = list(self._handles.values())
        fleet_items = list(self._fleets.items())
        by_family_bytes: Dict[str, int] = {}
        by_family_handles: Dict[str, int] = {}
        for h in handles:
            by_family_bytes[h.family] = \
                by_family_bytes.get(h.family, 0) + h.device_bytes
            by_family_handles[h.family] = \
                by_family_handles.get(h.family, 0) + 1
        fleet_by_family: Dict[str, int] = {}
        fleet_by_device: Dict[str, int] = {}
        for (family, _, _), f in fleet_items:
            fleet_by_family[family] = \
                fleet_by_family.get(family, 0) + f.device_bytes
            dev = f.resident_device
            if dev is not None and f.device_bytes:
                fleet_by_device[dev] = \
                    fleet_by_device.get(dev, 0) + f.device_bytes
        return dict(handles=len(handles), hits=self.hits,
                    misses=self.misses, evictions=self.evictions,
                    expirations=self.expirations,
                    compactions=self.compactions,
                    adoptions=self.adoptions,
                    device=str(self.device),
                    fleet_device_bytes_by_device=fleet_by_device,
                    fleets=len(fleet_items),
                    device_bytes=sum(h.device_bytes for h in handles),
                    fleet_device_bytes=sum(f.device_bytes
                                           for _, f in fleet_items),
                    fleet_live_bytes=sum(f.live_rows * f.bytes_per_row
                                         for _, f in fleet_items),
                    handles_by_family=by_family_handles,
                    device_bytes_by_family=by_family_bytes,
                    fleet_device_bytes_by_family=fleet_by_family)

    def solve(self, graph_id: str, B, **kw) -> PCGResult:
        return self.get(graph_id).solve(B, **kw)


class Solver(FactorCache):
    """Single-tenant surface over :class:`FactorCache`: ``factor``/
    ``attach`` remember the most recent handle and ``solve`` takes just
    the rhs.  Defaults to ``max_handles=1``."""

    def __init__(self, **kw):
        kw.setdefault("max_handles", 1)
        super().__init__(**kw)
        self.handle: Optional[PreconditionerHandle] = None

    def factor(self, g: Graph, key, **kw) -> PreconditionerHandle:
        self.handle = super().factor(g, key, **kw)
        return self.handle

    def attach(self, g: Graph, f, **kw) -> PreconditionerHandle:
        self.handle = super().attach(g, f, **kw)
        return self.handle

    def solve(self, B, **kw) -> PCGResult:
        if self.handle is None:
            raise RuntimeError("Solver.solve before Solver.factor")
        return self.handle.solve(B, **kw)
