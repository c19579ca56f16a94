"""Level-scheduled sparse triangular solves for the G D Gᵀ preconditioner.

Rows are grouped by dependency level (level(i) = 1 + max level over
in-neighbours); each level is one data-parallel sweep.  Three builders:

* ``build_schedules`` / ``_levels_from_edges`` — host (numpy)
  construction, kept as the test oracle (``solve_levels_np`` solves over
  it in float64, ``make_solver`` on a device, one scatter-add a level);
* ``build_schedules_batched`` — the Solver's path: level propagation by
  relaxation on the device for a whole fleet at once, then row-indexed
  ELL panels (:class:`PackedSchedule`) that the masked fleet trisolve
  reads in place;
* ``build_schedules_device`` — the library path (``make_preconditioner``):
  level-sorted ELL panels (:class:`DeviceSchedule`) whose level slabs the
  sweep kernels read in place, one launch per triangular solve that walks
  the levels on the card.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Tuple, Union

import numpy as np
import torch

from ..kernels import ops
from ..kernels.spmv import SweepWalk, sweep_walk
from ..kernels.runtime import resolve_device
from .ref_ac import ACFactor, DeviceFactor
from .parac import _next_pow2, _run_ranks
from ..obs.tracing import span

I64 = torch.int64


@dataclasses.dataclass
class LevelSchedule:
    """COO edges of a unit-triangular solve, grouped by target-row level."""

    n: int
    n_levels: int
    level_ptr: np.ndarray  # int64[n_levels+1] into the edge arrays
    e_dst: np.ndarray      # int32[nnz] — row being solved
    e_src: np.ndarray      # int32[nnz] — already-solved row it reads
    e_val: np.ndarray      # f32[nnz]
    level_of: np.ndarray   # int32[n]


def _levels_from_edges(n: int, dst: np.ndarray, src: np.ndarray,
                       val: np.ndarray) -> LevelSchedule:
    """Group solve edges by level (longest-path levels by level-synchronous
    relaxation, one vectorized pass per level)."""
    level = np.zeros(n, np.int32)
    while True:
        cand = np.zeros(n, np.int32)
        np.maximum.at(cand, dst, level[src] + 1)
        new = np.maximum(level, cand)
        if np.array_equal(new, level):
            break
        level = new
    n_levels = int(level.max()) + 1 if n else 1
    edge_level = level[dst]
    eorder = np.argsort(edge_level, kind="stable")
    e_dst, e_src, e_val = dst[eorder], src[eorder], val[eorder]
    counts = np.bincount(edge_level[eorder], minlength=n_levels)
    level_ptr = np.zeros(n_levels + 1, np.int64)
    np.cumsum(counts, out=level_ptr[1:])
    return LevelSchedule(n=n, n_levels=n_levels, level_ptr=level_ptr,
                         e_dst=e_dst.astype(np.int32),
                         e_src=e_src.astype(np.int32),
                         e_val=e_val, level_of=level)


def build_schedules(f: ACFactor) -> Tuple[LevelSchedule, LevelSchedule]:
    """Forward (G y = r) and backward (Gᵀ x = z) host level schedules.
    CSC entry (i ∈ col k) is forward edge dst=i/src=k; the backward solve
    runs in flipped index space (dst = n-1-k, src = n-1-i)."""
    n = f.n
    cols = np.repeat(np.arange(n, dtype=np.int32),
                     np.diff(f.col_ptr).astype(np.int64))
    fwd = _levels_from_edges(n, f.rows.astype(np.int32), cols, f.vals)
    bwd = _levels_from_edges(n, (n - 1) - cols,
                             (n - 1) - f.rows.astype(np.int32), f.vals)
    return fwd, bwd


def solve_levels_np(sched: LevelSchedule, b: np.ndarray,
                    flip: bool = False) -> np.ndarray:
    """Host reference solve (numpy, float64)."""
    y = (b[::-1] if flip else b).astype(np.float64).copy()
    for lv in range(sched.n_levels):
        lo, hi = sched.level_ptr[lv], sched.level_ptr[lv + 1]
        if hi == lo:
            continue
        contrib = np.zeros(sched.n, np.float64)
        np.add.at(contrib, sched.e_dst[lo:hi],
                  sched.e_val[lo:hi].astype(np.float64)
                  * y[sched.e_src[lo:hi]])
        y -= contrib
    return y[::-1] if flip else y


def make_solver(sched: LevelSchedule, flip: bool = False, device=None):
    """A ``b -> y`` unit-triangular solve over a host
    :class:`LevelSchedule`, one scatter-add (``index_add_``) per non-empty
    level, on ``device`` (the GPU unless the CPU is asked for; ``b`` is
    moved there).  ``flip`` for the backward schedule (its indices are
    stored flipped).  On CUDA the float scatter-add is atomic, so the
    last bits may vary run to run; the level-swept paths
    (``make_preconditioner``, the fleet) are the deterministic ones."""
    dev = resolve_device(device)
    per_level = []
    for lv in range(sched.n_levels):
        lo, hi = int(sched.level_ptr[lv]), int(sched.level_ptr[lv + 1])
        if hi == lo:
            continue
        per_level.append(tuple(
            torch.as_tensor(a[lo:hi], device=dev)
            for a in (sched.e_dst.astype(np.int64),
                      sched.e_src.astype(np.int64), sched.e_val)))

    def solve(b: torch.Tensor) -> torch.Tensor:
        b = torch.as_tensor(b, device=dev)
        y = b.flip(0) if flip else b
        for dst, src, val in per_level:
            contrib = torch.zeros_like(y).index_add_(
                0, dst, val.to(y.dtype) * y[src])
            y = y - contrib
        return y.flip(0) if flip else y

    return solve


def precond_apply_np(f: ACFactor, r: np.ndarray) -> np.ndarray:
    fwd, bwd = build_schedules(f)
    y = solve_levels_np(fwd, r)
    dinv = np.where(f.D > 0, 1.0 / np.where(f.D > 0, f.D, 1.0), 0.0)
    return solve_levels_np(bwd, y * dinv, flip=True)


# ---------------------------------------------------------------------------
# Batched (fleet) schedule construction — row-indexed panels
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedSchedule:
    """One triangular solve as **row-indexed** ELL panels: row ``i``'s
    in-edges occupy row ``i`` of ``cols``/``vals`` (zero-padded to K),
    ``level_of[i]`` is its dependency level.  The backward schedule stays
    in original index space (the level loop needs no topological index
    order).  Rows are left-packed: row ``i``'s live slots are its first
    ``row_len[i]`` (its in-degree)."""

    n: int                  # true rows (rows n..n_pad are phantom)
    n_pad: int
    n_levels: int           # this factor's own level count
    K: int
    cols: torch.Tensor      # int32[n_pad, K]
    vals: torch.Tensor      # f32[n_pad, K]
    level_of: torch.Tensor  # int32[n_pad] (0 for phantom rows)
    row_len: torch.Tensor   # int32[n_pad] — live slots per row

    @property
    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.cols, self.vals, self.level_of,
                             self.row_len))


def _propagate_levels_fleet(dst: torch.Tensor, src: torch.Tensor, *, n: int,
                            check_every: int = 8) -> torch.Tensor:
    """Longest-path levels of a batch of solve-edge sets ``(S, E)`` by
    Jacobi relaxation (one level per pass), padding edges marked
    ``dst == n`` (they land in a drop column).  The host reads the
    "changed" flag every ``check_every`` passes; passes after convergence
    change nothing."""
    S = dst.shape[0]
    level = torch.zeros((S, n + 1), dtype=torch.int32, device=dst.device)
    while True:
        for _ in range(check_every):
            cand = torch.zeros_like(level).scatter_reduce_(
                1, dst, torch.gather(level, 1, src) + 1, reduce="amax")
            new = torch.maximum(level, cand)
            new[:, n] = 0
            changed = (new != level).any()
            level = new
        if not bool(changed):
            return level[:, :n]


def _pack_row_panels(dst: torch.Tensor, src: torch.Tensor, val: torch.Tensor,
                     *, n: int, K: int):
    """Row-indexed ELL packing of one edge set: edge ``e`` lands in slot
    ``(dst_e, rank_e)``, rank = position within its dst group in edge
    order.  Padding edges (``dst == n``) go to a dropped row.  Returns
    ``(cols, vals, row_len)``, ``row_len`` the live slots of each row."""
    sd, order = torch.sort(dst, stable=True)
    rank = _run_ranks(sd)
    dest = torch.where(sd < n, sd * K + rank, n * K)
    cols = torch.zeros(n * K + 1, dtype=torch.int32, device=dst.device)
    vals = torch.zeros(n * K + 1, dtype=val.dtype, device=dst.device)
    cols.scatter_(0, dest, src[order].to(torch.int32))
    vals.scatter_(0, dest, val[order])
    row_len = torch.bincount(sd[sd < n], minlength=n).to(torch.int32)
    return cols[:n * K].view(n, K), vals[:n * K].view(n, K), row_len


def build_schedules_batched(devs: List[DeviceFactor]
                            ) -> List[Tuple[PackedSchedule, PackedSchedule]]:
    """Forward/backward :class:`PackedSchedule` s for a fleet of device
    factors: level propagation runs once over a ``(2B, E_pad)`` batch of
    every factor's forward and backward solve edges; each schedule is
    then packed at its own shape (``n_pad = pow2(n)``,
    ``K = pow2(max in-degree)``), so a factor's schedule depends on its
    content alone.  Forward edges: CSC entry (i ∈ col k) ⇒ dst=i, src=k;
    backward: dst=k, src=i."""
    if not devs:
        return []
    with span("trisolve.schedules"):
        B = len(devs)
        dev = devs[0].device
        n_bat = _next_pow2(max(d.n for d in devs))
        E_bat = max(_next_pow2(max(d.nnz for d in devs)), 1)
        DST = torch.full((2 * B, E_bat), n_bat, dtype=I64, device=dev)
        SRC = torch.zeros((2 * B, E_bat), dtype=I64, device=dev)
        VAL = torch.zeros((2 * B, E_bat), dtype=torch.float32, device=dev)
        for b, d in enumerate(devs):
            counts = torch.diff(d.col_ptr.to(I64))
            cols_of = torch.repeat_interleave(
                torch.arange(d.n, dtype=I64, device=dev), counts,
                output_size=d.nnz)
            rows = d.rows.to(I64)
            DST[b, :d.nnz], SRC[b, :d.nnz] = rows, cols_of
            DST[B + b, :d.nnz], SRC[B + b, :d.nnz] = cols_of, rows
            VAL[b, :d.nnz] = VAL[B + b, :d.nnz] = d.vals
        levels = _propagate_levels_fleet(DST, SRC, n=n_bat)
        indeg = torch.zeros((2 * B, n_bat + 1), dtype=torch.int32,
                            device=dev).scatter_add_(
            1, DST, torch.ones_like(DST, dtype=torch.int32))[:, :n_bat]
        kmax = indeg.max(dim=1).values.tolist()
        nlv = levels.max(dim=1).values.tolist()
        out: List[Tuple[PackedSchedule, PackedSchedule]] = []
        for b, d in enumerate(devs):
            n_pad = _next_pow2(d.n)
            halves = []
            for row in (b, B + b):                 # forward, then backward
                K = max(_next_pow2(int(kmax[row])), 1)
                cols, vals, row_len = _pack_row_panels(
                    torch.where(DST[row] < n_pad, DST[row], n_pad), SRC[row],
                    VAL[row], n=n_pad, K=K)
                halves.append(PackedSchedule(
                    n=d.n, n_pad=n_pad, n_levels=int(nlv[row]) + 1, K=K,
                    cols=cols, vals=vals,
                    level_of=levels[row, :n_pad].contiguous(),
                    row_len=row_len))
            out.append((halves[0], halves[1]))
        return out


# ---------------------------------------------------------------------------
# Level-sorted device schedules — the library path (make_preconditioner)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceSchedule:
    """Level schedule with rows packed into **level-sorted** ELL panels,
    built on the device.  ``row_ids`` lists rows sorted by (level, row);
    level ``lv`` owns rows ``row_ids[row_ptr[lv]:row_ptr[lv+1]]`` and the
    same row range of ``cols``/``vals``, a contiguous slab that the sweep
    kernels read in place.  Row ``r`` is left-packed: its first
    ``row_len[r]`` slots are live.  ``row_ptr``, ``level_k`` and
    ``plan`` (the levels the sweep walks) live on the host, ``walk`` (the
    plan's item table for the sweep kernels) on the device.  The backward
    schedule lives in **flipped** index space (solve row ``i`` is vertex
    ``n-1-i``), unlike :class:`PackedSchedule`."""

    n: int
    n_levels: int
    K: int                  # panel width = max in-degree (>= 1), exact
    row_ids: torch.Tensor   # int32[n] — rows sorted by (level, row)
    row_ptr: np.ndarray     # int64[n_levels+1] into row_ids/cols/vals
    cols: torch.Tensor      # int32[n, K] — in-edge sources, 0-padded
    vals: torch.Tensor      # f32[n, K]   — in-edge values, 0-padded
    level_of: torch.Tensor  # int32[n]
    row_len: torch.Tensor   # int32[n] — live in-edges of each sorted row
    level_k: np.ndarray     # int64[n_levels] — longest live row per level
    plan: np.ndarray        # int32[L, 3] — (slab offset, rows, level_k)
                            # of each level >= 1 with rows, in order
    walk: SweepWalk         # the plan's device item table, built once


def _sweep_plan(row_ptr: np.ndarray, level_k: np.ndarray) -> np.ndarray:
    """The sweep's levels: (slab offset, row count, longest live row) of
    each level ``lv >= 1`` with rows (level-0 rows have no in-edges)."""
    lv = np.flatnonzero(np.diff(row_ptr)[1:] > 0) + 1
    return np.stack([row_ptr[lv], row_ptr[lv + 1] - row_ptr[lv],
                     level_k[lv]], axis=1).astype(np.int32)


def _propagate_levels(dst: torch.Tensor, src: torch.Tensor, *,
                      n: int) -> torch.Tensor:
    """Longest-path levels of one solve-edge set (int64 ``dst``/``src``):
    the fleet relaxation with one member, so the host reads the
    "changed" flag every 8 passes, not after each."""
    return _propagate_levels_fleet(dst[None], src[None], n=n)[0]


def _pack_ell_panels(dst, src, val, level, *, n: int, K: int):
    """Scatter solve edges into level-sorted ELL panels in one pass: rows
    sorted by level (stable, so by row within a level), each row's
    in-edges packed into its K slots in edge order."""
    row_ids = torch.sort(level, stable=True).indices
    row_rank = torch.empty(n, dtype=I64, device=dst.device)
    row_rank[row_ids] = torch.arange(n, dtype=I64, device=dst.device)
    sd, eorder = torch.sort(dst, stable=True)
    dest = row_rank[sd] * K + _run_ranks(sd)
    cols = torch.zeros(n * K, dtype=torch.int32, device=dst.device)
    vals = torch.zeros(n * K, dtype=val.dtype, device=dst.device)
    cols.scatter_(0, dest, src[eorder].to(torch.int32))
    vals.scatter_(0, dest, val[eorder])
    return row_ids.to(torch.int32), cols.view(n, K), vals.view(n, K)


def _schedule_from_edges_device(n: int, dst: torch.Tensor, src: torch.Tensor,
                                val: torch.Tensor) -> DeviceSchedule:
    """Device schedule from COO solve edges (``dst`` reads ``src``).  Host
    work is O(n) metadata; two host reads (K; the sorted levels with the
    live row lengths) and one copy of the walk's item table to the
    device."""
    dev = val.device
    if dst.shape[0] == 0:
        plan = np.zeros((0, 3), np.int32)
        return DeviceSchedule(
            n=n, n_levels=1, K=1,
            row_ids=torch.arange(n, dtype=torch.int32, device=dev),
            row_ptr=np.array([0, n], np.int64),
            cols=torch.zeros((n, 1), dtype=torch.int32, device=dev),
            vals=torch.zeros((n, 1), dtype=torch.float32, device=dev),
            level_of=torch.zeros(n, dtype=torch.int32, device=dev),
            row_len=torch.zeros(n, dtype=torch.int32, device=dev),
            level_k=np.zeros(1, np.int64), plan=plan,
            walk=sweep_walk(plan, dev))
    dst, src = dst.to(I64), src.to(I64)
    level = _propagate_levels(dst, src, n=n)
    indeg = torch.bincount(dst, minlength=n).to(torch.int32)
    K = max(int(indeg.max()), 1)
    row_ids, cols, vals = _pack_ell_panels(dst, src, val, level, n=n, K=K)
    row_len = indeg[row_ids.long()]
    # one read carries the sorted levels (row_ptr) and the row lengths
    # (each level's longest row)
    level_h, len_h = torch.stack(
        (level[row_ids.long()], row_len)).cpu().numpy().astype(np.int64)
    n_levels = int(level_h[-1]) + 1
    row_ptr = np.searchsorted(level_h,
                              np.arange(n_levels + 1)).astype(np.int64)
    level_k = np.zeros(n_levels, np.int64)
    held = np.flatnonzero(np.diff(row_ptr) > 0)
    level_k[held] = np.maximum.reduceat(len_h, row_ptr[held])
    plan = _sweep_plan(row_ptr, level_k)
    return DeviceSchedule(n=n, n_levels=n_levels, K=K, row_ids=row_ids,
                          row_ptr=row_ptr, cols=cols, vals=vals,
                          level_of=level, row_len=row_len, level_k=level_k,
                          plan=plan, walk=sweep_walk(plan, dev))


def build_schedules_device(f: Union[ACFactor, DeviceFactor], device=None
                           ) -> Tuple[DeviceSchedule, DeviceSchedule]:
    """Forward/backward :class:`DeviceSchedule` s straight from the factor's
    device view (``f.to_device(device)``: the cached view, else the GPU
    unless ``device`` says otherwise).  CSC entry (i ∈ col k) is forward
    edge dst=i/src=k; the backward solve runs in flipped index space so
    ascending indices stay topological."""
    dev = f.to_device(device)
    n = dev.n
    cols_of = torch.repeat_interleave(
        torch.arange(n, dtype=I64, device=dev.device),
        torch.diff(dev.col_ptr.to(I64)), output_size=dev.nnz)
    rows = dev.rows.to(I64)
    fwd = _schedule_from_edges_device(n, rows, cols_of, dev.vals)
    bwd = _schedule_from_edges_device(n, (n - 1) - cols_of, (n - 1) - rows,
                                      dev.vals)
    return fwd, bwd


def make_ell_solver(sched: DeviceSchedule, flip: bool = False):
    """Unit-triangular solve over a schedule's level slabs for a single
    rhs ``(n,)`` or a block ``(n, nrhs)``: ``ops.trisolve_panels``, one
    sweep kernel launch per solve."""
    return partial(ops.trisolve_panels, sched, flip=flip)


def make_preconditioner_from_schedules(fwd: DeviceSchedule,
                                       bwd: DeviceSchedule, D: torch.Tensor):
    """``r -> (G D Gᵀ)⁺ r`` from pre-built device schedules, for ``r`` of
    shape ``(n,)`` or ``(n, nrhs)``."""
    fsolve = make_ell_solver(fwd)
    bsolve = make_ell_solver(bwd, flip=True)
    dinv = torch.where(D > 0, 1.0 / torch.where(D > 0, D, 1.0), 0.0)

    def apply(r: torch.Tensor) -> torch.Tensor:
        y = fsolve(r)
        return bsolve(y * (dinv if y.dim() == 1 else dinv[:, None]))

    return apply


def make_preconditioner(f: Union[ACFactor, DeviceFactor], device=None):
    """``r -> (G D Gᵀ)⁺ r`` via two level-scheduled solves over device
    schedules, for ``r`` of shape ``(n,)`` or ``(n, nrhs)``.  Runs where
    ``f.to_device(device)`` puts the factor: its cached device view, else
    the GPU unless ``device`` says otherwise."""
    dev = f.to_device(device)
    fwd, bwd = build_schedules_device(dev)
    return make_preconditioner_from_schedules(fwd, bwd, dev.D)
