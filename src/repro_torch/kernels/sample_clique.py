"""Batched vertex elimination: the ``sample_clique`` CUDA kernel, its
wrapper and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/sample_clique.py``
(``sample_clique_pallas``).  The kernel source is
``csrc/sample_clique.cu``; the plain version is
``core.column_math.eliminate_column``, which it must equal bit for bit.
A CPU tensor takes the plain version, a CUDA tensor the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.column_math import ColumnElim, eliminate_column
from . import runtime

NAME = "sample_clique"
MAX_WIDTH = 16384          # 12·W bytes of shared memory per row


def sample_clique_plain(ids, ws, fill, u) -> ColumnElim:
    """The plain version: rows ``[R, W]`` with ``fill[r]`` valid lanes."""
    W = ids.shape[1]
    valid = (torch.arange(W, device=ids.device)[None, :]
             < fill.to(torch.int64)[:, None])
    return eliminate_column(ids, ws, valid, u)


def _lib():
    lib = runtime.load(NAME)
    f = lib.sample_clique_launch
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    return lib


def sample_clique(ids, ws, fill, u) -> ColumnElim:
    """Eliminate ``R`` rows: ids int32 ``[R, W]``, ws/u float32 ``[R, W]``,
    fill int32 ``[R]`` (lanes ``< fill`` are valid).  ``W`` must be a
    power of two on the GPU (``ops.sample_clique`` pads)."""
    if ids.device.type == "cpu":
        return sample_clique_plain(ids, ws, fill, u)
    if ids.device.type != "cuda":
        raise ValueError(f"sample_clique: unsupported device {ids.device}")
    R, W = ids.shape
    dev = ids.device
    runtime.require(ids, "ids", torch.int32, 2, dev)
    runtime.require(ws, "ws", torch.float32, 2, dev)
    runtime.require(u, "u", torch.float32, 2, dev)
    runtime.require(fill, "fill", torch.int32, 1, dev)
    if ws.shape != (R, W) or u.shape != (R, W) or fill.shape != (R,):
        raise ValueError("sample_clique: ids/ws/u must be [R, W], fill [R]")
    if W < 2 or W & (W - 1) or W > MAX_WIDTH:
        raise ValueError(f"sample_clique: W={W} must be a power of two in "
                         f"[2, {MAX_WIDTH}]")
    out = ColumnElim(
        g_rows=torch.empty((R, W), dtype=torch.int32, device=dev),
        g_vals=torch.empty((R, W), dtype=torch.float32, device=dev),
        m=torch.empty((R,), dtype=torch.int32, device=dev),
        ell_kk=torch.empty((R,), dtype=torch.float32, device=dev),
        e_lo=torch.empty((R, W), dtype=torch.int32, device=dev),
        e_hi=torch.empty((R, W), dtype=torch.int32, device=dev),
        e_w=torch.empty((R, W), dtype=torch.float32, device=dev),
        e_valid=torch.empty((R, W), dtype=torch.bool, device=dev))
    if R == 0:
        return out
    err = _lib().sample_clique_launch(
        ids.data_ptr(), ws.data_ptr(), fill.data_ptr(), u.data_ptr(),
        *(t.data_ptr() for t in out), R, W, runtime.stream_ptr(ids))
    runtime.check_launch(NAME, err)
    runtime.count_launch(NAME)
    return out
