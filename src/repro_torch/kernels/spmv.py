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
* ``ell_spmv`` — one vector: ``y[i] = Σ_k vals[i, k] · x[cols[i, k]]``
  for any ``R`` and ``K``.  Replaces ``ell_spmv_pallas``.  Source:
  ``csrc/ell_spmv.cu``.
* ``ell_spmv_multi`` — a block of vectors ``x`` ``[n, B]``:
  ``Y[i, b] = Σ_k vals[i, k] · x[cols[i, k], b]``, each (col, val) pair
  read once for all B columns.  Replaces ``ell_spmv_multi_pallas``.
  Source: ``csrc/ell_spmv_multi.cu``.

All three kernels sum a row in one order that depends on K alone
(``csrc/ell_row.cuh``), so ``ell_spmv`` equals a lane of
``ell_spmv_fleet`` and a column of ``ell_spmv_multi`` bit for bit.  The
plain versions are one function that sums K left to right by fused
multiply-adds, as XLA:CPU sums the reference's rows, so they too agree
with each other bit for bit.
"""
from __future__ import annotations

import ctypes

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
    of a block is summed exactly as that column alone."""
    shape = tuple(vals.shape) + (1,) * (x.dim() - 1)
    prod = vals.double().reshape(shape) * x[cols.long()].double()
    acc = torch.zeros(prod.shape[:1] + prod.shape[2:], dtype=x.dtype,
                      device=x.device)
    for k in range(cols.shape[1]):
        acc = (acc.double() + prod[:, k]).to(x.dtype)
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


def _launcher(name: str, n_ptr: int, n_int: int):
    """The C entry ``<name>_launch`` of ``csrc/<name>.cu``: ``n_ptr``
    pointers, ``n_int`` ints and the stream; returns a cudaError_t."""
    f = getattr(runtime.load(name), f"{name}_launch")
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
