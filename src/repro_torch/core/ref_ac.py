"""Sequential randomized-Cholesky oracle (paper Algorithms 1 + 2) and the
factor containers.

Right-looking, one vertex at a time in label order — the reference the
wavefront engine must match bit for bit (same per-vertex uniforms ⇒ same
factor).  The current graph's edges are bucketed by their min-label
endpoint ("owner column"): when vertex k's turn comes, its bucket holds
exactly L(:,k)'s off-diagonal entries.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..kernels.runtime import resolve_device
from .laplacian import Graph
from .column_math import column_uniforms, INVALID_ID


class DeviceFactor(NamedTuple):
    """Device-resident view of an ``ACFactor`` — what the schedule
    builder, preconditioner and PCG read."""

    col_ptr: torch.Tensor  # int32[n+1]
    rows: torch.Tensor     # int32[nnz]
    vals: torch.Tensor     # f32[nnz]
    D: torch.Tensor        # f32[n]

    @property
    def n(self) -> int:
        return int(self.D.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def device(self) -> torch.device:
        return self.D.device

    def to_device(self, device=None) -> "DeviceFactor":
        if device is None or torch.device(device) == self.D.device:
            return self
        return DeviceFactor(*(t.to(device) for t in self))


@dataclasses.dataclass
class ACFactor:
    """L ≈ G D Gᵀ with G unit-lower-triangular in elimination order; CSC
    host arrays over elimination positions plus an optional device view."""

    n: int
    col_ptr: np.ndarray   # int64[n+1]
    rows: np.ndarray      # int32[nnz]  (strictly > column index)
    vals: np.ndarray      # f32[nnz]
    D: np.ndarray         # f32[n]
    perm: Optional[np.ndarray] = None
    stats: Optional[dict] = None
    device: Optional[DeviceFactor] = None

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def to_device(self, device=None) -> DeviceFactor:
        """Device view, cached; uploaded on first use.  ``device``
        defaults to the cached view's device, else to the GPU (an error
        where there is none: the CPU is used only when asked for)."""
        if self.device is None or (device is not None and
                                   torch.device(device) != self.device.device):
            dev = resolve_device(device)
            self.device = DeviceFactor(
                col_ptr=torch.as_tensor(self.col_ptr.astype(np.int32),
                                        device=dev),
                rows=torch.as_tensor(self.rows.astype(np.int32), device=dev),
                vals=torch.as_tensor(self.vals, device=dev),
                D=torch.as_tensor(self.D, device=dev))
        return self.device

    def fill_ratio(self, g: Graph) -> float:
        """Paper Fig. 4 metric: 2·nnz(G) / nnz(L)."""
        nnz_L = 2 * g.m + g.n
        nnz_G = 2 * (self.nnz + self.n) - self.n
        return nnz_G / nnz_L


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def factorize_sequential(g: Graph, key, dtype=np.float32) -> ACFactor:
    """Run AC sequentially in label order on the CPU (the oracle)."""
    from ..kernels.ops import sample_clique

    n = g.n
    cols: List[List] = [[] for _ in range(n)]
    for s, d, w in zip(g.src, g.dst, g.w.astype(dtype)):
        cols[int(s)].append((int(d), dtype(w)))
    col_rows, col_vals = [], []
    D = np.zeros(n, dtype=dtype)
    for k in range(n):
        entries = cols[k]
        cols[k] = None
        d = len(entries)
        if d == 0:
            col_rows.append(np.zeros(0, np.int32))
            col_vals.append(np.zeros(0, dtype))
            continue
        width = _next_pow2(d)
        ids = np.full((1, width), INVALID_ID, np.int32)
        ws = np.zeros((1, width), dtype)
        ids[0, :d] = [e[0] for e in entries]
        ws[0, :d] = [e[1] for e in entries]
        u = column_uniforms(key, torch.tensor([k]), width)
        res = sample_clique(torch.from_numpy(ids), torch.from_numpy(ws),
                            torch.tensor([d], dtype=torch.int32), u)
        m = int(res.m[0])
        D[k] = res.ell_kk[0].item()
        col_rows.append(res.g_rows[0, :m].numpy())
        col_vals.append(res.g_vals[0, :m].numpy())
        ev = res.e_valid[0].numpy()
        for lo, hi, w in zip(res.e_lo[0].numpy()[ev], res.e_hi[0].numpy()[ev],
                             res.e_w[0].numpy()[ev]):
            cols[int(lo)].append((int(hi), dtype(w)))
    lens = np.array([r.shape[0] for r in col_rows], dtype=np.int64)
    col_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=col_ptr[1:])
    rows = np.concatenate(col_rows) if col_ptr[-1] else np.zeros(0, np.int32)
    vals = np.concatenate(col_vals) if col_ptr[-1] else np.zeros(0, dtype)
    return ACFactor(n=n, col_ptr=col_ptr, rows=rows.astype(np.int32),
                    vals=vals.astype(dtype), D=D)
