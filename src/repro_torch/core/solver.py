"""``FactorCache`` / ``Solver`` — the factor→solve pipeline as a
multi-tenant API (randomized AC family).

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
the device-memory budget or the handle count is exceeded.

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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.runtime import pad_k, resolve_device
from .laplacian import Graph, laplacian_adjacency
from .ref_ac import ACFactor, DeviceFactor
from .parac import factorize_wavefront, factorize_batched, _next_pow2
from .trisolve import PackedSchedule, build_schedules_batched
from .pcg import (PCGResult, FleetArrays, fleet_precondition, pcg_fleet_solve,
                  pcg_fleet_result)


def graph_fingerprint(g: Graph, key=None) -> str:
    """Content hash of a graph and (optionally) the factorization key —
    the cache identity of an AC factor (the same bytes as the reference's
    AC fingerprint: n, src, dst, w, then the raw uint32[2] key)."""
    h = hashlib.blake2b(digest_size=12)
    h.update(np.int64(g.n).tobytes())
    h.update(np.ascontiguousarray(g.src).tobytes())
    h.update(np.ascontiguousarray(g.dst).tobytes())
    h.update(np.ascontiguousarray(g.w).tobytes())
    if key is not None:
        h.update(np.ascontiguousarray(np.asarray(key, np.uint32)).tobytes())
    return h.hexdigest()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _grow(x: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Zero-pad ``x`` up to ``shape`` (every axis grows or stays)."""
    if tuple(x.shape) == tuple(shape):
        return x
    pad = []
    for s, t in reversed(list(zip(x.shape, shape))):
        pad += [0, t - s]
    return torch.nn.functional.pad(x, pad)


class _PaddedFactor:
    """One factor's bucket-padded device arrays, ready for fleet
    admission: Laplacian adjacency rows, forward/backward
    :class:`PackedSchedule` panels and the padded inverse diagonal."""

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


class FactorFleet:
    """Stacked, bucket-padded factors of one ``(family, n_pad, k_tier)``,
    plus the row bookkeeping that lets handles come and go.  ``arrays``
    is the live :class:`pcg.FleetArrays` stack.  Rows are claimed by
    weak reference: a row frees itself onto a min-heap when its handle
    dies, and admission reuses dead rows (lowest first) before growing
    the stack.  Growth along any axis zero-pads — padding Laplacian slots
    and panel slots carry zero weights — so members' solves are unchanged
    by it."""

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
        self.f_levels = 1          # bucket-wide level ceilings
        self.b_levels = 1
        self.arrays: Optional[FleetArrays] = None
        self._rows: List[Optional[weakref.ref]] = []
        self._free: List[int] = []
        self._ref2row: Dict[weakref.ref, int] = {}

    @property
    def capacity(self) -> int:
        return 0 if self.arrays is None else int(self.arrays.nvalid.shape[0])

    @property
    def live_rows(self) -> int:
        return sum(r is not None and r() is not None for r in self._rows)

    @property
    def bytes_per_row(self) -> int:
        if self.arrays is None:
            return 0
        return sum(_nbytes(x) // x.shape[0] for x in self.arrays)

    @property
    def device_bytes(self) -> int:
        return 0 if self.arrays is None else \
            sum(_nbytes(x) for x in self.arrays)

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
                flevel=z((F, np_), i32),
                bcols=z((F, np_, Kb), i32), bvals=z((F, np_, Kb), f32),
                blevel=z((F, np_), i32), dinv=z((F, np_), f32),
                nvalid=z((F,), i32), fnlv=torch.ones(F, dtype=i32, device=dev),
                bnlv=torch.ones(F, dtype=i32, device=dev))
        else:
            a = FleetArrays(
                lnbr=_grow(a.lnbr, (F, np_, Kl)),
                lw=_grow(a.lw, (F, np_, Kl)),
                fcols=_grow(a.fcols, (F, np_, Kf)),
                fvals=_grow(a.fvals, (F, np_, Kf)),
                flevel=_grow(a.flevel, (F, np_)),
                bcols=_grow(a.bcols, (F, np_, Kb)),
                bvals=_grow(a.bvals, (F, np_, Kb)),
                blevel=_grow(a.blevel, (F, np_)),
                dinv=_grow(a.dinv, (F, np_)),
                nvalid=_grow(a.nvalid, (F,)),
                fnlv=torch.clamp(_grow(a.fnlv, (F,)), min=1),
                bnlv=torch.clamp(_grow(a.bnlv, (F,)), min=1))
        ix = torch.tensor(rows, dtype=torch.int64, device=dev)
        pfs = [pf for _, pf in pairs]

        def put(x, vals):
            x[ix] = torch.stack([v.to(dev) for v in vals])

        put(a.lnbr, [_grow(p.lnbr, (np_, Kl)) for p in pfs])
        put(a.lw, [_grow(p.lw, (np_, Kl)) for p in pfs])
        put(a.fcols, [_grow(p.fwd.cols, (np_, Kf)) for p in pfs])
        put(a.fvals, [_grow(p.fwd.vals, (np_, Kf)) for p in pfs])
        put(a.flevel, [p.fwd.level_of for p in pfs])
        put(a.bcols, [_grow(p.bwd.cols, (np_, Kb)) for p in pfs])
        put(a.bvals, [_grow(p.bwd.vals, (np_, Kb)) for p in pfs])
        put(a.blevel, [p.bwd.level_of for p in pfs])
        put(a.dinv, [p.dinv for p in pfs])
        a.nvalid[ix] = torch.tensor([p.n for p in pfs], dtype=i32, device=dev)
        a.fnlv[ix] = torch.tensor([p.fwd.n_levels for p in pfs], dtype=i32,
                                  device=dev)
        a.bnlv[ix] = torch.tensor([p.bwd.n_levels for p in pfs], dtype=i32,
                                  device=dev)
        self.arrays = a
        self.Kl, self.Kf, self.Kb = Kl, Kf, Kb
        self.f_levels = max(self.f_levels, *(p.fwd.n_levels for p in pfs))
        self.b_levels = max(self.b_levels, *(p.bwd.n_levels for p in pfs))
        for (handle, _), row in zip(pairs, rows):
            ref = weakref.ref(handle, self._row_died)
            self._ref2row[ref] = row
            if row == len(self._rows):
                self._rows.append(ref)
            else:
                self._rows[row] = ref
        return rows


@dataclasses.dataclass(eq=False)
class PreconditionerHandle:
    """A constructed factor ready to serve solves.  Its data lives in its
    bucket's :class:`FactorFleet` (``fleet`` + ``fleet_row``)."""

    graph: Graph
    factor: ACFactor
    fleet: FactorFleet
    fleet_row: int
    n_levels_fwd: int
    n_levels_bwd: int
    graph_id: str = ""
    family: str = "ac"
    construct_s: float = 0.0

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
        """Forward critical-path length (levels)."""
        return self.n_levels_fwd

    @property
    def device(self) -> torch.device:
        return self.fleet.device

    @property
    def device_bytes(self) -> int:
        """The handle's row of the fleet stack plus its compact device
        factor."""
        dev = self.factor.to_device()
        return sum(_nbytes(t) for t in dev) + self.fleet.bytes_per_row

    def _fidx(self, L: int) -> torch.Tensor:
        return torch.full((L,), self.fleet_row, dtype=torch.int32,
                          device=self.device)

    def _pad(self, B: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((B.shape[0], self.n_pad), dtype=torch.float32,
                          device=self.device)
        out[:, :self.n] = B
        return out

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        """``r -> (G D Gᵀ)⁺ r`` for ``r`` of shape ``(n,)`` or
        ``(n, nrhs)`` (columns become lanes)."""
        r = torch.as_tensor(r, dtype=torch.float32, device=self.device)
        R = r[None] if r.dim() == 1 else r.T
        out = fleet_precondition(self.fleet.arrays, self._fidx(R.shape[0]),
                                 self._pad(R), f_levels=self.fleet.f_levels,
                                 b_levels=self.fleet.b_levels,
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
            f_levels=self.fleet.f_levels, b_levels=self.fleet.b_levels,
            kind=self.fleet.kind, project=project)
        res = pcg_fleet_result(state, self.n)
        if B.dim() == 1:
            return PCGResult(x=res.x[0], iters=res.iters[0],
                             relres=res.relres[0],
                             converged=res.converged[0])
        return res


FactorHandle = PreconditionerHandle


class FactorCache:
    """Multi-tenant factor-once / solve-many frontend (AC family).

    ``factor`` (or ``factor_batched`` / ``attach``) admits handles keyed
    by graph fingerprint; ``solve(graph_id, B)`` routes a rhs to its
    factor.  Admission evicts least-recently-used handles while the summed
    ``device_bytes`` exceeds ``memory_budget_bytes`` (or the handle count
    exceeds ``max_handles``) — the newest handle is never evicted.
    ``k_tiering`` sub-buckets fleets by the pow2 panel width so one wide
    factor does not widen its bucket-mates' sweeps.  Everything runs on
    ``device`` (the GPU unless the CPU is asked for).
    """

    def __init__(self, *, chunk: int = 64, fill_slack: int = 32,
                 strict: bool = True, max_retries: int = 3,
                 dtype=np.float32, memory_budget_bytes: Optional[int] = None,
                 max_handles: Optional[int] = None, k_tiering: bool = True,
                 device=None):
        self.chunk = chunk
        self.fill_slack = fill_slack
        self.strict = strict
        self.max_retries = max_retries
        self.dtype = dtype
        self.memory_budget_bytes = memory_budget_bytes
        self.max_handles = max_handles
        self.k_tiering = k_tiering
        self.device = resolve_device(device)
        self._handles: "OrderedDict[str, PreconditionerHandle]" = \
            OrderedDict()
        self._fleets: Dict[Tuple[str, int, int], FactorFleet] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- admission ----------------------------------------------------------
    def factor(self, g: Graph, key, *,
               graph_id: Optional[str] = None) -> PreconditionerHandle:
        """Factor ``g`` with the raw uint32[2] ``key`` and admit the handle
        (a cache hit if the same ``(graph, key)`` is live)."""
        gid = graph_id if graph_id is not None else graph_fingerprint(g, key)
        got = self._handles.get(gid)
        if got is not None:
            self.hits += 1
            self._handles.move_to_end(gid)
            return got
        self.misses += 1
        t0 = time.perf_counter()
        f = factorize_wavefront(g, key, chunk=self.chunk,
                                fill_slack=self.fill_slack,
                                strict=self.strict,
                                max_retries=self.max_retries,
                                dtype=self.dtype, device=self.device)
        handle = self.attach(g, f, graph_id=gid)
        handle.construct_s = time.perf_counter() - t0
        return handle

    def factor_batched(self, gs: Sequence[Graph], keys, *,
                       graph_ids: Optional[Sequence[str]] = None
                       ) -> List[PreconditionerHandle]:
        """Admit a fleet: graphs not already cached factor together in one
        batched engine run, their schedules in one batched pass."""
        gs = list(gs)
        keys = [np.asarray(k, np.uint32).reshape(2) for k in
                (keys if isinstance(keys, (list, tuple))
                 else np.asarray(keys).reshape(-1, 2))]
        gids = list(graph_ids) if graph_ids is not None else [
            graph_fingerprint(g, keys[i]) for i, g in enumerate(gs)]
        todo = [i for i, gid in enumerate(gids) if gid not in self._handles]
        self.hits += len(gs) - len(todo)
        self.misses += len(todo)
        fleet = {gid: self._handles[gid] for gid in gids
                 if gid in self._handles}
        if todo:
            fs, scheds = factorize_batched(
                [gs[i] for i in todo], [keys[i] for i in todo],
                chunk=self.chunk, fill_slack=self.fill_slack,
                strict=self.strict, max_retries=self.max_retries,
                dtype=self.dtype, with_schedules=True, device=self.device)
            fleet.update(self._attach_many(
                [(gs[i], f, sch, gids[i])
                 for i, f, sch in zip(todo, fs, scheds)]))
        for gid in gids:
            if gid in self._handles:
                self._handles.move_to_end(gid)
        return [fleet[gid] for gid in gids]

    def attach(self, g: Graph, f: ACFactor, *,
               graph_id: Optional[str] = None,
               schedules: Optional[Tuple[PackedSchedule,
                                         PackedSchedule]] = None
               ) -> PreconditionerHandle:
        """Wrap an existing factor (the sequential oracle's, one carried
        across from the reference package by ``convert``, ...) in a solve
        handle and admit it to its fleet — no re-construction."""
        gid = graph_id if graph_id is not None else graph_fingerprint(g)
        (_, handle), = self._attach_many([(g, f, schedules, gid)])
        return handle

    def _attach_many(self, items) -> List[Tuple[str, PreconditionerHandle]]:
        """Admit ``(graph, factor, schedules|None, gid)`` items, grouped by
        fleet so each stack grows once; the budget sweep runs at the end."""
        built = []
        for g, f, schedules, gid in items:
            dev = f.to_device(self.device)
            if schedules is None:
                schedules = build_schedules_batched([dev])[0]
            fwd, bwd = schedules
            pf = _PaddedFactor(g, dev, fwd, bwd)
            k_tier = pad_k(max(fwd.K, bwd.K)) if self.k_tiering else 0
            fkey = ("ac", pf.n_pad, k_tier)
            fleet = self._fleets.get(fkey)
            if fleet is None:
                fleet = self._fleets[fkey] = FactorFleet(
                    pf.n_pad, k_tier=k_tier, device=self.device)
            handle = PreconditionerHandle(
                graph=g, factor=f, fleet=fleet, fleet_row=-1,
                n_levels_fwd=fwd.n_levels, n_levels_bwd=bwd.n_levels,
                graph_id=gid)
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
            self._handles[gid] = handle
            self._handles.move_to_end(gid)
            out.append((gid, handle))
        self._shrink()
        return out

    def _shrink(self) -> None:
        """Evict LRU handles until the budget/count bounds hold (the newest
        handle always survives)."""
        while len(self._handles) > 1 and (
                (self.max_handles is not None
                 and len(self._handles) > self.max_handles)
                or (self.memory_budget_bytes is not None
                    and self.device_bytes > self.memory_budget_bytes)):
            self._handles.popitem(last=False)
            self.evictions += 1

    # -- lookup / routing ---------------------------------------------------
    def get(self, graph_id: str) -> PreconditionerHandle:
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

    def evict(self, graph_id: str) -> None:
        if self._handles.pop(graph_id, None) is not None:
            self.evictions += 1

    def stats(self) -> Dict:
        """Cache counters and device-memory accounting."""
        fleets = list(self._fleets.values())
        return dict(handles=len(self._handles), hits=self.hits,
                    misses=self.misses, evictions=self.evictions,
                    device=str(self.device), fleets=len(fleets),
                    device_bytes=self.device_bytes,
                    fleet_device_bytes=sum(f.device_bytes for f in fleets),
                    fleet_live_bytes=sum(f.live_rows * f.bytes_per_row
                                         for f in fleets))

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

    def attach(self, g: Graph, f: ACFactor, **kw) -> PreconditionerHandle:
        self.handle = super().attach(g, f, **kw)
        return self.handle

    def solve(self, B, **kw) -> PCGResult:
        if self.handle is None:
            raise RuntimeError("Solver.solve before Solver.factor")
        return self.handle.solve(B, **kw)
