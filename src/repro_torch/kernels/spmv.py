"""ELL SpMV kernels of the port, their wrappers and their plain PyTorch
versions.  A CPU tensor takes the plain version, a CUDA tensor the kernel
(or an error); nothing falls back.

* ``ell_spmv_fleet`` — lane-batched over a fleet stack:
  ``Y[l, i] = Σ_{k < lens[f, i]} vals[f, i, k] · x[l, cols[f, i, k]]``
  with ``f = fidx[l]``: cols/vals are the stacked panels ``[F, R, K]``
  and each lane reads its own factor's panel through ``fidx``; ``lens``
  (optional) holds each row's live slots, all K without it.  Replaces
  the TPU kernel ``ell_spmv_fleet_pallas`` (``repro/kernels/spmv.py``),
  which took per-lane panels ``[L, R, K]`` — the ``fidx = arange(L)``,
  ``lens = None`` case.  Source: ``csrc/ell_spmv_fleet.cu``: each block
  groups the lanes by factor and reads a row's live slots once for up to
  8 lanes of its factor.
* ``ell_sweep_fleet`` — one of the fleet's triangular solves over level
  rows, in place: for each level ``lv`` of a host plan, ``y[l, i] -=
  Σ_{k < len[f, i]} vals[f, i, k] · y[l, cols[f, i, k]]`` for the rows
  ``i`` of level ``lv`` of factor ``f = fidx[l]``, listed in ``rows[f]``
  from ``starts[f, lv]`` to ``starts[f, lv + 1]``.  One C call per solve,
  which groups the lanes by factor in one launch and then launches the
  same source's level kernel once per level,
  each row's group as wide as the level's longest live row and each row
  read once for up to 8 lanes of its factor; a committed row equals
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
  row_ids[r]``.  One launch per triangular solve: a persistent kernel
  (``csrc/ell_walk.cuh``) whose blocks take the plan's rows in order by a
  ticket and wait on the previous level's done counter on the card, from
  the item table of :func:`sweep_walk` (the sweeps' last argument); the
  redesign of ``ell_spmv_pallas`` / ``ell_spmv_multi_pallas`` for the
  library path, in the same sources as ``ell_spmv`` / ``ell_spmv_multi``.  A committed row
  equals ``ell_spmv`` / ``ell_spmv_multi`` followed by ``y[rows] -= Y``
  bit for bit.

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
import dataclasses

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


def ell_spmv_fleet_plain(cols, vals, fidx, x, lens=None) -> torch.Tensor:
    """The plain version of ``ell_spmv_fleet``: lane by lane, the plain
    single-vector SpMV of the lane's panel, over each row's first
    ``lens[f, i]`` slots when ``lens`` is given (a slot past a row's
    length counts as 0.0, and the panel is cut at the factor's longest
    row).  On a left-packed panel, whose slots past a row's length hold
    0.0, the sum equals the sum over all K slots bit for bit: adding the
    exact product 0.0 to a float64 partial sum and rounding to float32
    changes nothing (a partial sum of -0 aside)."""
    y = torch.empty((x.shape[0], cols.shape[1]), dtype=x.dtype,
                    device=x.device)
    for lane, f in enumerate(fidx.tolist()):
        c, v = cols[f], vals[f]
        if lens is not None:
            ln = lens[f].long()
            k = min(max(int(ln.max()), 0), c.shape[1]) if ln.numel() else 0
            live = torch.arange(k, device=ln.device)[None, :] < ln[:, None]
            c, v = c[:, :k], torch.where(live, v[:, :k], 0.0)
        y[lane] = ell_spmv_plain(c, v, x[lane])
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
                          plan) -> None:
    """The plain version of ``ell_sweep_fleet``, on the same arguments and
    in place: level by level of the plan, lane by lane, the lane's level
    rows gathered through its factor's list, summed as
    :func:`ell_spmv_plain` sums them (over the lane's longest live row at
    that level: the slots past a row's own length hold 0.0 and add exactly
    nothing), subtracted and scattered back."""
    _check_sweep_shapes(cols, vals, lens, rows, starts, fidx, y, plan)
    args = (cols, vals, lens, rows, starts, y)
    if y.device.type == "cpu":
        # numpy views of the same memory, so the sweep still lands in y
        _sweep_levels(*(t.numpy() for t in args), fidx.tolist(), plan,
                      _row_sums_np)
    else:
        _sweep_levels(*args, fidx.tolist(), plan, _row_sums_torch)


def _sweep_levels(cols, vals, lens, rows, starts, y, fl, plan,
                  row_sums) -> None:
    """:func:`ell_sweep_fleet_plain`'s level loop, in place on tensors or
    on numpy arrays; ``row_sums`` is the matching row sum."""
    for lv, count, _ in plan.tolist():
        if not count:
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


def sweep_plan(counts, level_k) -> np.ndarray:
    """The host plan of one triangular solve, from each level's row count
    bound and longest live row (sequences indexed by level): one
    ``(level, rows, level_k)`` int32 row per level ``>= 1`` that has rows,
    in solve order, C-contiguous (what ``ell_sweep_fleet`` and its plain
    version take)."""
    counts = np.asarray(counts, np.int64)
    level_k = np.asarray(level_k, np.int64)
    lv = np.flatnonzero(counts[1:] > 0) + 1
    return np.ascontiguousarray(np.stack(
        [lv, counts[lv], level_k[lv]], axis=1).astype(np.int32).reshape(-1, 3))


def cut_plan(plan: np.ndarray, levels: int) -> np.ndarray:
    """The plan's entries below level ``levels`` (the deepest level count
    of the factors a call's lanes read: the levels past it have no rows
    for them)."""
    return plan[:int(np.searchsorted(plan[:, 0], levels))]


def _check_sweep_shapes(cols, vals, lens, rows, starts, fidx, y,
                        plan) -> None:
    """The sweep's contract, for the kernel and the plain version: the
    stacks' shapes, and the plan a C-contiguous int32 host array ``[P, 3]``
    of ``(level, rows, level_k)`` with levels rising from 1, each level
    ``lv`` below ``starts.shape[1] - 1`` (it reads ``starts[:, lv + 1]``),
    and ``0 <= level_k <= K``."""
    F, R = cols.shape[:2]
    L = fidx.shape[0]
    if (cols.dim() != 3 or vals.shape != cols.shape
            or lens.shape != (F, R) or rows.shape != (F, R)
            or starts.dim() != 2 or starts.shape[0] != F
            or y.shape != (L, R) or fidx.dim() != 1):
        raise ValueError("ell_sweep_fleet: cols/vals [F, R, K], lens/rows "
                         "[F, R], starts [F, levels + 1], y [L, R] and "
                         "fidx [L] must agree")
    if not (isinstance(plan, np.ndarray) and plan.dtype == np.int32
            and plan.ndim == 2 and plan.shape[1] == 3
            and plan.flags.c_contiguous):
        raise ValueError("ell_sweep_fleet: plan must be a C-contiguous "
                         "int32 host array [P, 3]")
    lv, count, k = plan.T.astype(np.int64)
    if plan.shape[0] and (
            lv[0] < 1 or (np.diff(lv) <= 0).any()
            or lv[-1] + 1 >= starts.shape[1] or (count < 0).any()
            or (k < 0).any() or (k > cols.shape[2]).any()):
        raise ValueError(f"ell_sweep_fleet: a plan entry lies outside the "
                         f"levels 1 .. {starts.shape[1] - 2} of starts or "
                         f"the panel's {cols.shape[2]} slots, or the levels "
                         f"do not rise")


# the C entry points, resolved and typed once each
_LAUNCHERS: dict = {}


def _launcher(name: str, n_ptr: int, n_int: int, entry: str = ""):
    """The C entry ``<entry or name>_launch`` of ``csrc/<name>.cu``:
    ``n_ptr`` pointers, ``n_int`` ints and the stream; returns a
    cudaError_t.  Resolved (and its ``argtypes`` set) on first use, then
    taken from a cache."""
    key = (name, entry, n_ptr, n_int)
    f = _LAUNCHERS.get(key)
    if f is None:
        f = getattr(runtime.load(name), f"{entry or name}_launch")
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_void_p])
        _LAUNCHERS[key] = f
    return f


# the most lanes one ell_spmv_fleet launch takes (kMaxLanes of
# csrc/ell_spmv_fleet.cu: each block keeps the lanes' factor table in
# shared memory)
FLEET_MAX_LANES = 1024
# the shared memory the kernel stages a pass's x in (kXSmemBytes): a pass
# of nb lanes (the next power of two above L, at most 8) at width n fits
# when nb * round4(n) * 4 bytes do
FLEET_X_SMEM_BYTES = 136 * 1024


def _fleet_gather(L: int, n: int, x_smem):
    """(gather code, interleaved x width) of an ``ell_spmv_fleet`` launch,
    as the C entry decides them: x staged in shared memory (1) when a pass
    takes 2 or more lanes and they fit, or when asked for, else gathered
    through L1 (0) from x with its lanes interleaved ``[n][ld]`` (ld 0: no
    copy, one lane reads x)."""
    nb = 8 if L > 4 else 4 if L > 2 else L         # lanes a pass
    fits = nb * ((n + 3) // 4 * 4) * 4 <= FLEET_X_SMEM_BYTES
    if x_smem and not fits:
        raise ValueError(f"ell_spmv_fleet: x of {nb} lanes at n = {n} does "
                         f"not fit in shared memory")
    if ((nb >= 2 and fits) if x_smem is None else x_smem):
        return 1, 0
    return 0, (0 if L == 1 else nb if L <= 8 else (L + 7) // 8 * 8)


def ell_spmv_fleet(cols, vals, fidx, x, lens=None, *,
                   x_smem=None) -> torch.Tensor:
    """cols int32 / vals float32 ``[F, R, K]``, fidx int32 ``[L]`` (rows
    of the stack, each < F), x float32 ``[L, n]`` → ``[L, R]``.  ``lens``
    int32 ``[F, R]``: each row's live slots (≤ K; the slots past it must
    hold 0.0 and are not read); ``None`` reads all K.  On the card at most
    :data:`FLEET_MAX_LANES` lanes a launch.  ``x_smem`` picks the
    kernel's gather of x: ``None`` stages it in shared memory when a pass
    takes 2 or more lanes and they fit (8 lanes at n ≤ 4,096), else
    gathers it through L1 (several lanes from a copy with the lanes
    interleaved); ``True`` / ``False`` force either way (for comparing
    the two; ``True`` raises where it does not fit)."""
    if x.device.type == "cpu":
        return ell_spmv_fleet_plain(cols, vals, fidx, x, lens)
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
    if lens is not None:
        runtime.require(lens, "lens", torch.int32, 2, dev)
        if lens.shape != (F, R):
            raise ValueError("ell_spmv_fleet: lens must be [F, R]")
    if L > FLEET_MAX_LANES:
        raise ValueError(f"ell_spmv_fleet: {L} lanes; one launch takes at "
                         f"most {FLEET_MAX_LANES}")
    gather, ld = _fleet_gather(L, n, x_smem)
    y = torch.empty((L, R), dtype=torch.float32, device=dev)
    xt = torch.empty(n * ld, dtype=torch.float32, device=dev) if ld else None
    err = _launcher("ell_spmv_fleet", 7, 5)(
        cols.data_ptr(), vals.data_ptr(),
        None if lens is None else lens.data_ptr(), fidx.data_ptr(),
        x.data_ptr(), None if xt is None else xt.data_ptr(), y.data_ptr(),
        L, R, K, n, gather, runtime.stream_ptr(x))
    runtime.check_launch("ell_spmv_fleet", err)
    runtime.count_launch("ell_spmv_fleet")
    return y


def ell_sweep_fleet(cols, vals, lens, rows, starts, fidx, y,
                    plan) -> None:
    """One lane-batched unit-triangular solve, in place on ``y`` float32
    ``[L, R]``: one launch that groups the lanes by factor, then the
    levels of ``plan`` in order, one kernel launch each, all from one C
    call (its launch count, the grouping included, goes to the runtime's
    counter).  cols int32 / vals float32 ``[F, R, K]``; lens
    (live slots per row) and rows (each factor's rows sorted stably by
    level) int32 ``[F, R]``; starts int32 ``[F, n_starts]`` (level
    ``lv``'s rows of factor ``f`` are ``rows[f, starts[f, lv]:starts[f,
    lv + 1]]``); fidx int32 ``[L]``, at most :data:`FLEET_MAX_LANES` on
    the card.  ``plan`` is the host array of :func:`sweep_plan`: per level
    its row count and longest live row, each bounding every lane's factor
    (the launch grid and the group width).  ``y`` is lane-major (C
    contiguous) or interleaved (the transpose of a C-contiguous ``[R,
    L]``: a column's lanes side by side); either gives the same bits.
    The tensors are checked once, not per level."""
    if y.device.type == "cpu":
        return ell_sweep_fleet_plain(cols, vals, lens, rows, starts, fidx, y,
                                     plan)
    if y.device.type != "cuda":
        raise ValueError(f"ell_sweep_fleet: unsupported device {y.device}")
    dev = y.device
    runtime.require(cols, "cols", torch.int32, 3, dev)
    runtime.require(vals, "vals", torch.float32, 3, dev)
    for t, what in ((lens, "lens"), (rows, "rows"), (starts, "starts")):
        runtime.require(t, what, torch.int32, 2, dev)
    runtime.require(fidx, "fidx", torch.int32, 1, dev)
    if y.dtype != torch.float32:
        raise TypeError(f"y: expected torch.float32, got {y.dtype}")
    if y.device != dev or y.dim() != 2 or not (y.is_contiguous()
                                                or y.t().is_contiguous()):
        raise ValueError("y: must be [L, R], lane-major or interleaved "
                         "(the transpose of a contiguous [R, L])")
    _check_sweep_shapes(cols, vals, lens, rows, starts, fidx, y, plan)
    F, R, K = cols.shape
    L = y.shape[0]
    if L > FLEET_MAX_LANES or L * R >= 2 ** 31:
        raise ValueError(f"ell_sweep_fleet: {L} lanes of {R} rows; one call "
                         f"takes at most {FLEET_MAX_LANES} lanes and 2^31 "
                         f"entries")
    groups = torch.empty(5 * L, dtype=torch.int32, device=dev)
    launched = _launcher("ell_spmv_fleet", 9, 7, "ell_sweep_fleet")(
        cols.data_ptr(), vals.data_ptr(), lens.data_ptr(), rows.data_ptr(),
        starts.data_ptr(), fidx.data_ptr(), groups.data_ptr(), y.data_ptr(),
        plan.ctypes.data, plan.shape[0], L, R, K, starts.shape[1],
        y.stride(0), y.stride(1), runtime.stream_ptr(y))
    if launched < 0:
        runtime.check_launch("ell_sweep_fleet", -launched)
    runtime.count_launch("ell_sweep_fleet", launched)


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


# rows of a block of the level walk (kWalkThreads of csrc/ell_walk.cuh),
# the int32 words from one done counter of its workspace to the next
# (kWalkStride) and the most entries one run item holds (kWalkRun)
WALK_THREADS = 256
WALK_STRIDE = 32
WALK_RUN = 64


@dataclasses.dataclass(frozen=True)
class SweepWalk:
    """The level walk's device tables for one host plan (built once per
    schedule by :func:`sweep_walk`, beside the plan).  ``entries`` int32
    ``[n_entries, 4]``: (slab offset, rows, longest live row, 0) of each
    plan entry with rows, in order (an entry waits on the one before it);
    ``items`` int32 ``[n_items, 4]``, in plan order: (first slab row, rows,
    entry, longest live row) of a piece of at most ``WALK_THREADS //
    group_width(level_k)`` rows of one entry, or (first entry's offset,
    entries, first entry, -1) of a run of 2 to ``WALK_RUN`` consecutive
    entries whose rows each fit one block, which one block sweeps in
    turn."""

    plan: np.ndarray
    items: torch.Tensor
    entries: torch.Tensor

    @property
    def n_items(self) -> int:
        return self.items.shape[0]

    @property
    def n_entries(self) -> int:
        return self.entries.shape[0]


def walk_items(plan: np.ndarray):
    """The host side of :func:`sweep_walk`: (items ``[n_items, 4]``,
    entries ``[n_entries, 4]``) as int32 numpy arrays."""
    live = plan[plan[:, 1] > 0].astype(np.int64)
    entries = np.zeros((live.shape[0], 4), np.int64)
    entries[:, :3] = live
    items = []
    e = 0
    while e < live.shape[0]:
        lo, count, k = (int(v) for v in live[e])
        per = WALK_THREADS // group_width(k)
        run = e
        while (run < live.shape[0] and run - e < WALK_RUN
               and live[run, 1] <= WALK_THREADS // group_width(
                   int(live[run, 2]))):
            run += 1
        if run - e >= 2:
            items.append((lo, run - e, e, -1))
            e = run
            continue
        items.extend((lo + start, min(per, count - start), e, k)
                     for start in range(0, count, per))
        e += 1
    return (np.array(items, np.int32).reshape(-1, 4),
            entries.astype(np.int32))


def sweep_walk(plan: np.ndarray, device) -> SweepWalk:
    """The level walk's item and entry tables of ``plan`` (a host int32
    ``[L, 3]`` of (slab offset, rows, longest live row)) on ``device``:
    one host-to-device copy each, made once per schedule."""
    items, entries = walk_items(plan)
    dev = torch.device(device)
    return SweepWalk(plan=plan, items=torch.from_numpy(items).to(dev),
                     entries=torch.from_numpy(entries).to(dev))


def _sweep(name, y_ndim, cols, vals, row_len, row_ids, y, walk) -> None:
    """Check once and make the one C call of a sweep: a workspace zeroed
    on the stream and one launch of the level walk (none for an empty
    plan); counts what it launched."""
    dev = y.device
    runtime.require(cols, "cols", torch.int32, 2, dev)
    runtime.require(vals, "vals", torch.float32, 2, dev)
    runtime.require(row_len, "row_len", torch.int32, 1, dev)
    runtime.require(row_ids, "row_ids", torch.int32, 1, dev)
    runtime.require(y, "y", torch.float32, y_ndim, dev)
    _check_sweep(name, cols, vals, row_len, row_ids, y, walk.plan, y_ndim)
    runtime.require(walk.items, "walk.items", torch.int32, 2, dev)
    runtime.require(walk.entries, "walk.entries", torch.int32, 2, dev)
    ws_words = (walk.n_entries + 1) * WALK_STRIDE
    ws = torch.empty(ws_words, dtype=torch.int32, device=dev)
    ints = (walk.n_items, walk.n_entries, ws_words,
            cols.shape[1]) + tuple(y.shape[1:])           # K, then B
    source = "ell_spmv" if y_ndim == 1 else "ell_spmv_multi"
    launched = _launcher(source, 8, len(ints), name)(
        cols.data_ptr(), vals.data_ptr(), row_len.data_ptr(),
        row_ids.data_ptr(), walk.items.data_ptr(),
        walk.entries.data_ptr(), ws.data_ptr(), y.data_ptr(), *ints,
        runtime.stream_ptr(y))
    if launched < 0:
        runtime.check_launch(name, -launched)
    runtime.count_launch(name, launched)


def _walk_of(name, walk) -> SweepWalk:
    """``walk`` itself, refused unless it is a :class:`SweepWalk`."""
    if not isinstance(walk, SweepWalk):
        raise TypeError(f"{name}: takes the plan's SweepWalk "
                        f"(spmv.sweep_walk), not {type(walk).__name__}")
    return walk


def ell_sweep(cols, vals, row_len, row_ids, y, walk) -> None:
    """One unit-triangular solve over a level-sorted panel, in place on
    ``y`` float32 ``[n]``: cols int32 / vals float32 ``[n, K]`` (row ``r``
    holds the in-edges of row ``row_ids[r]``, left-packed), row_len
    (live slots) and row_ids int32 ``[n]``, and ``walk`` the
    :class:`SweepWalk` of the host plan (int32 ``[L, 3]`` of (slab
    offset, row count, longest live row) of each level to sweep, in
    order) that a schedule builds once.  On the card one launch walks
    every level (none for a plan without rows); on the CPU the plain
    version sweeps ``walk.plan``.  The tensors are checked once."""
    walk = _walk_of("ell_sweep", walk)
    if y.device.type == "cpu":
        return ell_sweep_plain(cols, vals, row_len, row_ids, y, walk.plan)
    if y.device.type != "cuda":
        raise ValueError(f"ell_sweep: unsupported device {y.device}")
    _sweep("ell_sweep", 1, cols, vals, row_len, row_ids, y, walk)


def ell_sweep_multi(cols, vals, row_len, row_ids, y, walk) -> None:
    """:func:`ell_sweep` for a block ``y`` float32 ``[n, B]`` (row-major):
    each live (col, val) pair read once for up to 8 columns; column ``b``
    equals ``ell_sweep`` of that column bit for bit."""
    walk = _walk_of("ell_sweep_multi", walk)
    if y.device.type == "cpu":
        return ell_sweep_multi_plain(cols, vals, row_len, row_ids, y,
                                     walk.plan)
    if y.device.type != "cuda":
        raise ValueError(f"ell_sweep_multi: unsupported device {y.device}")
    _sweep("ell_sweep_multi", 2, cols, vals, row_len, row_ids, y, walk)
