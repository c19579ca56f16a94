"""ELL SpMV kernels of the port, their wrappers and their plain PyTorch
versions.  A CPU tensor takes the plain version, a CUDA tensor the kernel
(or an error); nothing falls back.

* ``ell_spmv_fleet`` — lane-batched over a fleet stack:
  ``Y[l, i] = Σ_k vals[f, i, k] · x[l, cols[f, i, k]]`` with
  ``f = fidx[l]``: cols/vals are the stacked panels ``[F, R, K]`` and each
  lane reads its own factor's panel through ``fidx``.  Replaces the TPU
  kernel ``ell_spmv_fleet_pallas`` (``repro/kernels/spmv.py``), which took
  per-lane panels ``[L, R, K]`` — the ``fidx = arange(L)`` case.  Source:
  ``csrc/ell_spmv_fleet.cu``.
* ``ell_sweep_fleet`` — the fleet's triangular-solve sweeps over level
  rows, in place: for each level ``lv``, ``y[l, i] -= Σ_{k < len[f, i]}
  vals[f, i, k] · y[l, cols[f, i, k]]`` for the rows ``i`` of level
  ``lv`` of factor ``f = fidx[l]``, listed in ``rows[f]`` from
  ``starts[f, lv]`` to ``starts[f, lv + 1]``.  One launch per level of
  the same source's second kernel; a committed row equals
  ``ell_spmv_fleet`` followed by ``y - Y`` bit for bit.
* ``ell_spmv`` — one vector: ``y[i] = Σ_k vals[i, k] · x[cols[i, k]]``
  for any ``R`` and ``K``.  Replaces ``ell_spmv_pallas``.  Source:
  ``csrc/ell_spmv.cu``.
* ``ell_spmv_multi`` — a block of vectors ``x`` ``[n, B]``:
  ``Y[i, b] = Σ_k vals[i, k] · x[cols[i, k], b]``, each (col, val) pair
  read once for all B columns.  Replaces ``ell_spmv_multi_pallas``.
  Source: ``csrc/ell_spmv_multi.cu``.
* ``ell_sweep`` / ``ell_sweep_multi`` — one triangular solve over the
  level slabs of a level-sorted panel (the library path's
  ``DeviceSchedule``), in place on ``y`` ``[n]`` / ``[n, B]``: for each
  level of the plan, ``y[i] -= Σ_{k < row_len[r]} vals[r, k] ·
  y[cols[r, k]]`` for the slab rows ``r`` of that level, ``i =
  row_ids[r]``.  One launch per level, all issued by one C call; the
  redesign of ``ell_spmv_pallas`` / ``ell_spmv_multi_pallas`` for the
  library path, in the same sources as ``ell_spmv`` / ``ell_spmv_multi``.
  A committed row equals ``ell_spmv`` / ``ell_spmv_multi`` followed by
  ``y[rows] -= Y`` bit for bit.

All these kernels sum a row in one order that depends on K alone
(``csrc/ell_row.cuh``; the sweeps over a level's longest live row, which
gives the same bits), so ``ell_spmv`` equals a lane of ``ell_spmv_fleet``
and a column of ``ell_spmv_multi`` bit for bit.  The plain versions are
one function that sums K left to right by fused multiply-adds, as
XLA:CPU sums the reference's rows, so they too agree with each other bit
for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import runtime


def ell_spmv_plain(cols, vals, x) -> torch.Tensor:
    """The plain version of ``ell_spmv`` (x ``[n]``) and of
    ``ell_spmv_multi`` (x ``[n, B]``): the K terms of a row summed left to
    right, each step one fused multiply-add ``acc + v·x`` rounded once to
    float32 — what XLA:CPU computes for the reference's row sums, which it
    contracts into FMAs.  The float64 product of two float32 values is
    exact, so only the final sum is rounded (twice, 53 then 24 bits, which
    differs from one rounding only at exact ties of the second).  A column
    of a block is summed exactly as that column alone.  CPU tensors are
    summed by :func:`_row_sums_np` on their memory, the same operations
    without a torch dispatch per step."""
    if x.device.type == "cpu":
        return torch.from_numpy(_row_sums_np(cols.numpy(), vals.numpy(),
                                             x.numpy()))
    return _row_sums_torch(cols, vals, x)


def _row_sums_torch(cols, vals, x) -> torch.Tensor:
    """:func:`ell_spmv_plain` on tensors of any device."""
    shape = tuple(vals.shape) + (1,) * (x.dim() - 1)
    prod = vals.double().reshape(shape) * x[cols.long()].double()
    acc = torch.zeros(prod.shape[:1] + prod.shape[2:], dtype=x.dtype,
                      device=x.device)
    for k in range(cols.shape[1]):
        acc = (acc.double() + prod[:, k]).to(x.dtype)
    return acc


def _row_sums_np(cols, vals, x) -> np.ndarray:
    """:func:`_row_sums_torch` on numpy arrays: the same exact float64
    products, float64 sums and float32 roundings, step for step."""
    shape = vals.shape + (1,) * (x.ndim - 1)
    prod = vals.astype(np.float64).reshape(shape) * x[cols].astype(np.float64)
    acc = np.zeros(prod.shape[:1] + prod.shape[2:], dtype=x.dtype)
    for k in range(cols.shape[1]):
        acc = (acc + prod[:, k]).astype(x.dtype)
    return acc


ell_spmv_multi_plain = ell_spmv_plain


def ell_spmv_fleet_plain(cols, vals, fidx, x) -> torch.Tensor:
    """The plain version of ``ell_spmv_fleet``: lane by lane, the plain
    single-vector SpMV of the lane's panel."""
    y = torch.empty((x.shape[0], cols.shape[1]), dtype=x.dtype,
                    device=x.device)
    for lane, f in enumerate(fidx.tolist()):
        y[lane] = ell_spmv_plain(cols[f], vals[f], x[lane])
    return y


def group_width(K: int) -> int:
    """Threads that share one row of a K-slot panel in the kernels
    (``ell::group_width`` of ``csrc/ell_row.cuh``)."""
    G = 1
    while G < K and G < 32:
        G <<= 1
    return G


def ell_spmv_fleet_error_bounds(cols, vals, fidx, x):
    """The exact rows of ``ell_spmv_fleet`` and the forward-error bound of
    each summation order against them, per (lane, row), as float64
    ``(exact, kernel_bound, plain_bound)``.

    ``exact`` sums the float32 products, each exact in float64.  A sum
    whose every term passes through at most m roundings of unit roundoff
    u is within ``γ_m·A`` of the exact sum, ``γ_m = m·u / (1 - m·u)`` and
    ``A = Σ_k |vals·x|``.  The kernel's thread sums ``ceil(K/G)`` slots by
    FMAs and the group adds by a ``log2 G`` butterfly; the plain version
    makes K left-to-right steps, each rounded to float64 then float32.
    Each bound takes ``u = 2^-24 + 2^-52``, covering the plain version's
    double rounding, and adds ``2K·2^-53·A`` for the float64 rounding of
    ``exact`` and of ``A``.  With K = 4096 and G = 32 the kernel's bound
    is about 7.9e-6·A, below an average term's A/K."""
    K = cols.shape[2]
    G = group_width(K)
    u = 2.0 ** -24 + 2.0 ** -52
    exact, A = [], []
    for lane, f in enumerate(fidx.tolist()):
        t = vals[f].double() * x[lane].double()[cols[f].long()]
        exact.append(t.sum(1))
        A.append(t.abs().sum(1))
    exact, A = torch.stack(exact), torch.stack(A)

    def gamma(m):
        return m * u / (1 - m * u) + 2 * K * 2.0 ** -53

    m_kernel = -(-K // G) + (G.bit_length() - 1)
    return exact, gamma(m_kernel) * A, gamma(K) * A


def ell_sweep_fleet_plain(cols, vals, lens, rows, starts, fidx, y,
                          level_rows) -> None:
    """The plain version of ``ell_sweep_fleet``, on the same arguments and
    in place: level by level, lane by lane, the lane's level rows gathered
    through its factor's list, summed as :func:`ell_spmv_plain` sums them
    (over the level's longest live length: the slots past a row's own
    length hold 0.0 and add exactly nothing), subtracted and scattered
    back."""
    _check_sweep_shapes(cols, vals, lens, rows, starts, fidx, y, level_rows)
    args = (cols, vals, lens, rows, starts, y)
    if y.device.type == "cpu":
        # numpy views of the same memory, so the sweep still lands in y
        _sweep_levels(*(t.numpy() for t in args), fidx.tolist(), level_rows,
                      _row_sums_np)
    else:
        _sweep_levels(*args, fidx.tolist(), level_rows, _row_sums_torch)


def _sweep_levels(cols, vals, lens, rows, starts, y, fl, level_rows,
                  row_sums) -> None:
    """:func:`ell_sweep_fleet_plain`'s level loop, in place on tensors or
    on numpy arrays; ``row_sums`` is the matching row sum."""
    for lv in range(1, len(level_rows)):
        if not level_rows[lv]:
            continue
        for lane, f in enumerate(fl):
            lo, hi = int(starts[f, lv]), int(starts[f, lv + 1])
            if hi <= lo:
                continue
            r = rows[f, lo:hi]
            if torch.is_tensor(r):
                r = r.long()
            k = int(lens[f, r].max())
            if k:
                y[lane, r] = y[lane, r] - row_sums(
                    cols[f, r, :k], vals[f, r, :k], y[lane])


def _check_sweep_shapes(cols, vals, lens, rows, starts, fidx, y,
                        level_rows) -> None:
    """The sweep's shape contract, for the kernel and the plain version:
    levels ``1 .. len(level_rows) - 1`` read ``starts[:, lv + 1]``, so
    ``starts`` needs ``len(level_rows) + 1`` columns."""
    F, R = cols.shape[:2]
    L = fidx.shape[0]
    if (cols.dim() != 3 or vals.shape != cols.shape
            or lens.shape != (F, R) or rows.shape != (F, R)
            or starts.dim() != 2 or starts.shape[0] != F
            or y.shape != (L, R) or fidx.dim() != 1
            or len(level_rows) + 1 > starts.shape[1]):
        raise ValueError("ell_sweep_fleet: cols/vals [F, R, K], lens/rows "
                         "[F, R], starts [F, >= levels + 1], y [L, R] and "
                         "fidx [L] must agree")


def _launcher(name: str, n_ptr: int, n_int: int, entry: str = ""):
    """The C entry ``<entry or name>_launch`` of ``csrc/<name>.cu``:
    ``n_ptr`` pointers, ``n_int`` ints and the stream; returns a
    cudaError_t."""
    f = getattr(runtime.load(name), f"{entry or name}_launch")
    f.restype = ctypes.c_int
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    return f


def ell_spmv_fleet(cols, vals, fidx, x) -> torch.Tensor:
    """cols int32 / vals float32 ``[F, R, K]``, fidx int32 ``[L]`` (rows
    of the stack, each < F), x float32 ``[L, n]`` → ``[L, R]``."""
    if x.device.type == "cpu":
        return ell_spmv_fleet_plain(cols, vals, fidx, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv_fleet: unsupported device {x.device}")
    dev = x.device
    runtime.require(cols, "cols", torch.int32, 3, dev)
    runtime.require(vals, "vals", torch.float32, 3, dev)
    runtime.require(fidx, "fidx", torch.int32, 1, dev)
    runtime.require(x, "x", torch.float32, 2, dev)
    F, R, K = cols.shape
    L, n = x.shape
    if vals.shape != cols.shape or fidx.shape != (L,):
        raise ValueError("ell_spmv_fleet: cols/vals must match [F, R, K] "
                         "and fidx must be [L]")
    y = torch.empty((L, R), dtype=torch.float32, device=dev)
    err = _launcher("ell_spmv_fleet", 5, 4)(
        cols.data_ptr(), vals.data_ptr(), fidx.data_ptr(), x.data_ptr(),
        y.data_ptr(), L, R, K, n, runtime.stream_ptr(x))
    runtime.check_launch("ell_spmv_fleet", err)
    runtime.count_launch("ell_spmv_fleet")
    return y


def ell_sweep_fleet(cols, vals, lens, rows, starts, fidx, y,
                    level_rows) -> None:
    """The sweeps of one lane-batched unit-triangular solve, in place on
    ``y`` float32 ``[L, R]``: levels ``1 .. len(level_rows) - 1`` in order,
    one launch each.  cols int32 / vals float32 ``[F, R, K]``; lens (live
    slots per row) and rows (each factor's rows sorted stably by level)
    int32 ``[F, R]``; starts int32 ``[F, n_starts]`` (level ``lv``'s rows
    of factor ``f`` are ``rows[f, starts[f, lv]:starts[f, lv + 1]]``);
    fidx int32 ``[L]``.  ``level_rows`` (host ints) bounds each level's
    row count over the lanes; a level whose entry is 0 is skipped.  The
    tensors are checked once, not per level."""
    if y.device.type == "cpu":
        return ell_sweep_fleet_plain(cols, vals, lens, rows, starts, fidx, y,
                                     level_rows)
    if y.device.type != "cuda":
        raise ValueError(f"ell_sweep_fleet: unsupported device {y.device}")
    dev = y.device
    runtime.require(cols, "cols", torch.int32, 3, dev)
    runtime.require(vals, "vals", torch.float32, 3, dev)
    for t, what in ((lens, "lens"), (rows, "rows"), (starts, "starts")):
        runtime.require(t, what, torch.int32, 2, dev)
    runtime.require(fidx, "fidx", torch.int32, 1, dev)
    runtime.require(y, "y", torch.float32, 2, dev)
    _check_sweep_shapes(cols, vals, lens, rows, starts, fidx, y, level_rows)
    F, R, K = cols.shape
    L = y.shape[0]
    n_starts = starts.shape[1]
    launch = _launcher("ell_spmv_fleet", 7, 6, "ell_sweep_fleet")
    stream = runtime.stream_ptr(y)
    ptrs = (cols.data_ptr(), vals.data_ptr(), lens.data_ptr(),
            rows.data_ptr(), starts.data_ptr(), fidx.data_ptr(),
            y.data_ptr())
    for lv in range(1, len(level_rows)):
        if not level_rows[lv]:
            continue
        err = launch(*ptrs, L, R, K, n_starts, lv, int(level_rows[lv]),
                     stream)
        runtime.check_launch("ell_sweep_fleet", err)
        runtime.count_launch("ell_sweep_fleet")


def _check_panel(name, cols, vals, x, x_ndim):
    dev = x.device
    runtime.require(cols, "cols", torch.int32, 2, dev)
    runtime.require(vals, "vals", torch.float32, 2, dev)
    runtime.require(x, "x", torch.float32, x_ndim, dev)
    if vals.shape != cols.shape:
        raise ValueError(f"{name}: cols and vals must both be [R, K], got "
                         f"{tuple(cols.shape)} and {tuple(vals.shape)}")


def ell_spmv(cols, vals, x) -> torch.Tensor:
    """cols int32 / vals float32 ``[R, K]`` (any R and K; a row range of a
    larger contiguous panel is read in place), x float32 ``[n]`` →
    ``[R]``."""
    if x.device.type == "cpu":
        return ell_spmv_plain(cols, vals, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv: unsupported device {x.device}")
    _check_panel("ell_spmv", cols, vals, x, 1)
    R, K = cols.shape
    y = torch.empty(R, dtype=torch.float32, device=x.device)
    err = _launcher("ell_spmv", 4, 2)(
        cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(), R, K,
        runtime.stream_ptr(x))
    runtime.check_launch("ell_spmv", err)
    runtime.count_launch("ell_spmv")
    return y


def ell_spmv_multi(cols, vals, x) -> torch.Tensor:
    """cols int32 / vals float32 ``[R, K]``, x float32 ``[n, B]``
    (row-major) → ``[R, B]``."""
    if x.device.type == "cpu":
        return ell_spmv_multi_plain(cols, vals, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv_multi: unsupported device {x.device}")
    _check_panel("ell_spmv_multi", cols, vals, x, 2)
    R, K = cols.shape
    B = x.shape[1]
    y = torch.empty((R, B), dtype=torch.float32, device=x.device)
    err = _launcher("ell_spmv_multi", 4, 3)(
        cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(), R, K,
        B, runtime.stream_ptr(x))
    runtime.check_launch("ell_spmv_multi", err)
    runtime.count_launch("ell_spmv_multi")
    return y


def _check_sweep(name, cols, vals, row_len, row_ids, y, plan, y_ndim
                 ) -> None:
    """The level sweep's contract, for the kernel and the plain version:
    cols/vals ``[R, K]``, row_len/row_ids ``[R]``, y ``[R]`` or ``[R, B]``,
    and plan a host int32 array ``[L, 3]`` of (slab offset, row count,
    longest live row) whose slabs lie inside the panel and whose longest
    rows fit in K."""
    R, K = cols.shape if cols.dim() == 2 else (-1, -1)
    if (cols.dim() != 2 or vals.shape != cols.shape
            or row_len.shape != (R,) or row_ids.shape != (R,)
            or y_ndim not in (1, 2) or y.dim() != y_ndim
            or y.shape[0] != R):
        raise ValueError(f"{name}: cols/vals [R, K], row_len/row_ids [R] "
                         f"and y [R{', B' if y_ndim == 2 else ''}] must "
                         f"agree")
    if not (isinstance(plan, np.ndarray) and plan.dtype == np.int32
            and plan.ndim == 2 and plan.shape[1] == 3
            and plan.flags.c_contiguous):
        raise ValueError(f"{name}: plan must be a C-contiguous int32 host "
                         f"array [L, 3]")
    lo, count, k = plan.T.astype(np.int64)
    if (lo < 0).any() or (count < 0).any() or (lo + count > R).any() \
            or (k < 0).any() or (k > K).any():
        raise ValueError(f"{name}: a plan entry lies outside the [{R}, {K}] "
                         f"panel")


def ell_sweep_plain(cols, vals, row_len, row_ids, y, plan) -> None:
    """The plain version of ``ell_sweep`` (y ``[n]``) and of
    ``ell_sweep_multi`` (y ``[n, B]``), on the same arguments and in
    place: level by level, the level's rows gathered, summed as
    :func:`ell_spmv_plain` sums them over the level's longest live row
    (the slots past a row's own length hold 0.0 and add exactly nothing),
    subtracted and scattered back."""
    _check_sweep("ell_sweep", cols, vals, row_len, row_ids, y, plan,
                 y.dim())
    for lo, count, k in plan.tolist():
        if count:
            hi = lo + count
            rows = row_ids[lo:hi].long()
            y[rows] = y[rows] - ell_spmv_plain(cols[lo:hi, :k],
                                               vals[lo:hi, :k], y)


ell_sweep_multi_plain = ell_sweep_plain


def _sweep(name, y_ndim, cols, vals, row_len, row_ids, y, plan) -> None:
    """Check once and make the one C call of a sweep, which launches one
    kernel per level with rows; counts what it launched."""
    dev = y.device
    runtime.require(cols, "cols", torch.int32, 2, dev)
    runtime.require(vals, "vals", torch.float32, 2, dev)
    runtime.require(row_len, "row_len", torch.int32, 1, dev)
    runtime.require(row_ids, "row_ids", torch.int32, 1, dev)
    runtime.require(y, "y", torch.float32, y_ndim, dev)
    _check_sweep(name, cols, vals, row_len, row_ids, y, plan, y_ndim)
    ints = (cols.shape[1],) + tuple(y.shape[1:])      # K, then B
    source = "ell_spmv" if y_ndim == 1 else "ell_spmv_multi"
    launched = _launcher(source, 6, 1 + len(ints), name)(
        cols.data_ptr(), vals.data_ptr(), row_len.data_ptr(),
        row_ids.data_ptr(), y.data_ptr(), plan.ctypes.data, plan.shape[0],
        *ints, runtime.stream_ptr(y))
    if launched < 0:
        runtime.check_launch(name, -launched)
    runtime.count_launch(name, launched)


def ell_sweep(cols, vals, row_len, row_ids, y, plan) -> None:
    """One unit-triangular solve over a level-sorted panel, in place on
    ``y`` float32 ``[n]``: cols int32 / vals float32 ``[n, K]`` (row ``r``
    holds the in-edges of row ``row_ids[r]``, left-packed), row_len
    (live slots) and row_ids int32 ``[n]``, plan the host int32 array
    ``[L, 3]`` of (slab offset, row count, longest live row) of each level
    to sweep, in order.  One kernel launch per level with rows, all from
    one C call; the tensors are checked once, not per level."""
    if y.device.type == "cpu":
        return ell_sweep_plain(cols, vals, row_len, row_ids, y, plan)
    if y.device.type != "cuda":
        raise ValueError(f"ell_sweep: unsupported device {y.device}")
    _sweep("ell_sweep", 1, cols, vals, row_len, row_ids, y, plan)


def ell_sweep_multi(cols, vals, row_len, row_ids, y, plan) -> None:
    """:func:`ell_sweep` for a block ``y`` float32 ``[n, B]`` (row-major):
    each live (col, val) pair read once for up to 8 columns; column ``b``
    equals ``ell_sweep`` of that column bit for bit."""
    if y.device.type == "cpu":
        return ell_sweep_multi_plain(cols, vals, row_len, row_ids, y, plan)
    if y.device.type != "cuda":
        raise ValueError(f"ell_sweep_multi: unsupported device {y.device}")
    _sweep("ell_sweep_multi", 2, cols, vals, row_len, row_ids, y, plan)
