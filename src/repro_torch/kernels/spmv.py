"""Lane-batched ELL SpMV over a fleet stack: the ``ell_spmv_fleet`` CUDA
kernel, its wrapper and its plain PyTorch version.

``Y[l, i] = Σ_k vals[f, i, k] · x[l, cols[f, i, k]]`` with
``f = fidx[l]``: cols/vals are the stacked panels ``[F, R, K]`` and each
lane reads its own factor's panel through ``fidx``.  Replaces the TPU
kernel ``repro/kernels/spmv.py`` (``ell_spmv_fleet_pallas``), which took
per-lane panels ``[L, R, K]`` — that is the ``fidx = arange(L)`` case.
Kernel source: ``csrc/ell_spmv_fleet.cu``.  A CPU tensor takes the plain
version, a CUDA tensor the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import runtime

NAME = "ell_spmv_fleet"


def ell_spmv_fleet_plain(cols, vals, fidx, x) -> torch.Tensor:
    """The plain version: for each lane, gather its panel's x values,
    multiply, and sum the K products left to right (the order in which
    XLA:CPU reduces a short row).  Lane by lane, so the temporaries are
    one panel's size whatever L is."""
    L = x.shape[0]
    R = cols.shape[1]
    y = torch.empty((L, R), dtype=x.dtype, device=x.device)
    for lane, f in enumerate(fidx.tolist()):
        prod = (vals[f] * x[lane][cols[f].long()]).t().contiguous()
        acc = torch.zeros(R, dtype=x.dtype, device=x.device)
        for k in range(prod.shape[0]):
            acc = acc + prod[k]
        y[lane] = acc
    return y


def _lib():
    lib = runtime.load(NAME)
    f = lib.ell_spmv_fleet_launch
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return lib


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
    err = _lib().ell_spmv_fleet_launch(
        cols.data_ptr(), vals.data_ptr(), fidx.data_ptr(), x.data_ptr(),
        y.data_ptr(), L, R, K, n, runtime.stream_ptr(x))
    runtime.check_launch(NAME, err)
    runtime.count_launch(NAME)
    return y
