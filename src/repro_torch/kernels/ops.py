"""Public wrappers around the kernels: the SpMV kernels (``ell_spmv``,
``ell_spmv_multi``, ``ell_spmv_fleet``), width padding for the
elimination kernel, layout conversion, and the triangular solves built
on the SpMV
kernels — over the level rows of row-indexed fleet panels
(``trisolve_fleet``), level-masked over row-indexed panels
(``trisolve_masked``, ``trisolve_fleet_masked``), over the level slabs of
a level-sorted panel (``trisolve_panels``; ``trisolve_panels_full``, the
full-row composition it is held against) and over numpy slabs
(``trisolve_levels``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.column_math import INVALID_ID, ColumnElim
from . import sample_clique as _sc
from . import spmv as _spmv


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def sample_clique(ids, ws, fill, u) -> ColumnElim:
    """Batched vertex elimination.  ids/ws/u: ``[R, W]``; fill: ``[R]``.
    Pads W to a power of two (≥ 2) with ``INVALID_ID``/``0``/``u=0.5``
    and returns rows of the padded width (the math is padding-width
    independent)."""
    R, W = ids.shape
    W2 = max(_next_pow2(W), 2)
    if W2 != W:
        pad = (0, W2 - W)
        ids = torch.nn.functional.pad(ids, pad, value=INVALID_ID)
        ws = torch.nn.functional.pad(ws, pad)
        u = torch.nn.functional.pad(u, pad, value=0.5)
    return _sc.sample_clique(ids.contiguous(), ws.contiguous(),
                             fill.to(torch.int32).contiguous(),
                             u.contiguous())


def ell_spmv(cols, vals, x) -> torch.Tensor:
    """ELL SpMV ``y[i] = Σ_k vals[i, k]·x[cols[i, k]]``: cols int32 /
    vals float32 ``[R, K]``, x float32 ``[n]`` → ``[R]`` (the ``ell_spmv``
    kernel on a CUDA tensor, its plain version on a CPU one)."""
    return _spmv.ell_spmv(cols, vals, x)


def ell_spmv_multi(cols, vals, x) -> torch.Tensor:
    """Multi-rhs ELL SpMV; x ``[n, B]`` (row-major) → ``[R, B]``, each
    column equal to :func:`ell_spmv` of that column bit for bit."""
    return _spmv.ell_spmv_multi(cols, vals, x)


def ell_spmv_fleet(cols, vals, fidx, x) -> torch.Tensor:
    """Lane-batched ELL SpMV ``[L, R]``: lane ``l`` multiplies ``x[l]`` by
    the panel ``fidx[l]`` of the fleet stack ``cols``/``vals``
    ``[F, R, K]`` (a per-lane stack passes ``fidx = arange(L)``)."""
    return _spmv.ell_spmv_fleet(cols, vals, fidx.to(torch.int32), x)


def trisolve_fleet(cols, vals, lens, rows, starts, fidx, y, *,
                   level_rows: Sequence[int],
                   lane_levels: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Lane-batched unit-triangular solve over level rows: one
    ``ell_sweep_fleet`` launch per level ``lv = 1 .. bound-1`` updates, in
    place on a copy of ``y`` ``[L, n]``, only the rows at that level:
    ``y[l, i] -= Σ_k vals[f, i, k]·y[l, cols[f, i, k]]``, ``f = fidx[l]``.

    ``cols``/``vals`` ``[F, n, K]``, ``lens`` (live slots per row) and
    ``rows`` (each factor's rows sorted stably by level) ``[F, n]`` and
    ``starts`` ``[F, >= levels + 1]`` (each level's offset into ``rows``)
    are fleet stacks read through ``fidx`` ``[L]``.  ``level_rows`` (host
    ints) is the bucket's largest row count per level; its length is the
    static level ceiling.  ``lane_levels`` ``[L]`` (each lane's true level
    count) lowers the bound to the batch's live maximum — one host read
    per solve.  A level past a lane's depth has no rows for it, so the
    bound never changes a result.  Each committed row equals
    :func:`trisolve_fleet_masked`'s bit for bit; ``y`` is not modified."""
    bound = len(level_rows)
    if lane_levels is not None:
        bound = min(int(lane_levels.max()), bound)
    y = y.clone(memory_format=torch.contiguous_format)
    _spmv.ell_sweep_fleet(cols, vals, lens, rows, starts,
                          fidx.to(torch.int32), y, level_rows[:bound])
    return y


def trisolve_fleet_masked(cols, vals, fidx, level_of, y, *, n_levels: int,
                          lane_levels: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The full-row form of :func:`trisolve_fleet`: each level runs the
    full-row fleet SpMV and commits the rows at that level,
    ``y = where(level_of == lv, y - A y, y)`` for ``lv = 1 .. bound-1``
    (``level_of`` ``[L, n]``; ``n_levels`` the static ceiling,
    ``lane_levels`` lowering it as there).  Every level reads the whole
    padded panel; kept as the composition the level sweep is held
    against."""
    bound = n_levels
    if lane_levels is not None:
        bound = min(int(lane_levels.max()), n_levels)
    for lv in range(1, bound):
        contrib = ell_spmv_fleet(cols, vals, fidx, y)
        y = torch.where(level_of == lv, y - contrib, y)
    return y


def graph_to_ell(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                 n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Laplacian rows in ELL layout (diagonal + negated off-diagonals)."""
    deg = np.zeros(n, np.int64)
    np.add.at(deg, src, 1)
    np.add.at(deg, dst, 1)
    K = int(deg.max()) + 1                       # +1 for the diagonal
    cols = np.zeros((n, K), np.int32)
    vals = np.zeros((n, K), np.float32)
    fill = np.ones(n, np.int64)                  # slot 0 = diagonal
    cols[:, 0] = np.arange(n)
    for s, d, ww in zip(src, dst, w):
        vals[s, 0] += ww
        vals[d, 0] += ww
        cols[s, fill[s]] = d
        vals[s, fill[s]] = -ww
        fill[s] += 1
        cols[d, fill[d]] = s
        vals[d, fill[d]] = -ww
        fill[d] += 1
    return cols, vals


def schedule_to_ell(sched) -> Tuple[np.ndarray, ...]:
    """Pad a host ``trisolve.LevelSchedule`` into per-level ELL rows.

    Returns (row_ids, cols, vals, level_ptr) with rows grouped by level;
    each row padded to the level's max in-degree (a stable sort + rank
    scatter per level, no per-edge loop)."""
    rows_all, cols_all, vals_all, ptr = [], [], [], [0]
    for lv in range(sched.n_levels):
        lo, hi = int(sched.level_ptr[lv]), int(sched.level_ptr[lv + 1])
        if hi == lo:
            ptr.append(ptr[-1])
            continue
        dst = sched.e_dst[lo:hi]
        uniq, inv = np.unique(dst, return_inverse=True)
        counts = np.bincount(inv)
        K = int(counts.max())
        order = np.argsort(inv, kind="stable")
        starts = np.zeros(uniq.size + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.arange(hi - lo) - np.repeat(starts[:-1], counts)
        cols = np.zeros((uniq.size, K), np.int32)
        vals = np.zeros((uniq.size, K), np.float32)
        cols[inv[order], rank] = sched.e_src[lo:hi][order]
        vals[inv[order], rank] = sched.e_val[lo:hi][order]
        rows_all.append(uniq.astype(np.int32))
        cols_all.append(cols)
        vals_all.append(vals)
        ptr.append(ptr[-1] + uniq.size)
    return rows_all, cols_all, vals_all, np.asarray(ptr)


def _working_copy(b: torch.Tensor, flip: bool) -> torch.Tensor:
    """A contiguous copy of ``b`` (reversed along axis 0 when ``flip``)
    that a level loop may update in place."""
    if flip:
        return torch.flip(b, (0,)).contiguous()
    return b.clone(memory_format=torch.contiguous_format)


def trisolve_levels(level_rows, level_cols, level_vals, b: torch.Tensor,
                    flip: bool = False) -> torch.Tensor:
    """Level-scheduled unit-triangular solve over the numpy slabs of
    :func:`schedule_to_ell`, one ``ell_spmv`` per level, on ``b``'s
    device."""
    y = _working_copy(b, flip)
    dev = y.device
    for rows, cols, vals in zip(level_rows, level_cols, level_vals):
        rows = torch.as_tensor(rows, device=dev).long()
        contrib = ell_spmv(torch.as_tensor(cols, device=dev),
                           torch.as_tensor(vals, device=dev), y)
        y[rows] -= contrib
    return torch.flip(y, (0,)) if flip else y


def trisolve_masked(cols, vals, level_of, y, *, n_levels: int
                    ) -> torch.Tensor:
    """Level-masked unit-triangular solve over row-indexed ELL panels
    ``(n, K)`` (row ``i``'s in-edges in row ``i``), ``level_of`` the
    dependency level per row and ``y`` the rhs ``(n,)``.  Each level runs
    the full-row ``ell_spmv`` and commits only the rows at that level, so
    an over-padded ``n_levels`` does not change the result."""
    for lv in range(1, n_levels):
        contrib = ell_spmv(cols, vals, y)
        y = torch.where(level_of == lv, y - contrib, y)
    return y


def trisolve_panels(sched, b: torch.Tensor, flip: bool = False
                    ) -> torch.Tensor:
    """Unit-triangular solve over a ``trisolve.DeviceSchedule``'s
    level-sorted ELL panels: one sweep (``ell_sweep`` for ``b`` of shape
    ``(n,)``, ``ell_sweep_multi`` for ``(n, B)``) over the schedule's
    ``plan``, one kernel launch per non-empty level ``lv >= 1``, each
    updating the rows ``row_ids[row_ptr[lv]:row_ptr[lv+1]]`` in place over
    their live slots.  Equal to :func:`trisolve_panels_full` bit for bit;
    ``b`` is not modified."""
    y = _working_copy(b, flip)
    sweep = _spmv.ell_sweep if y.dim() == 1 else _spmv.ell_sweep_multi
    sweep(sched.cols, sched.vals, sched.row_len, sched.row_ids, y,
          sched.plan)
    return torch.flip(y, (0,)) if flip else y


def trisolve_panels_full(sched, b: torch.Tensor, flip: bool = False
                         ) -> torch.Tensor:
    """The per-level composition that :func:`trisolve_panels` replaced:
    level ``lv``'s slab ``row_ptr[lv]:row_ptr[lv+1]`` of ``cols``/``vals``
    (all K slots) through ``ell_spmv`` / ``ell_spmv_multi``, then
    ``y[rows] -= Y``.  Level 0 and empty levels are skipped.  Kept as the
    composition the sweep is held against."""
    y = _working_copy(b, flip)
    kernel = ell_spmv if y.dim() == 1 else ell_spmv_multi
    ptr = sched.row_ptr
    for lv in range(1, sched.n_levels):   # level-0 rows have no in-edges
        lo, hi = int(ptr[lv]), int(ptr[lv + 1])
        if hi == lo:
            continue
        rows = sched.row_ids[lo:hi]
        y[rows] -= kernel(sched.cols[lo:hi], sched.vals[lo:hi], y)
    return torch.flip(y, (0,)) if flip else y
