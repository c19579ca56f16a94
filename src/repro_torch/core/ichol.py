"""Incomplete-Cholesky baselines and the ``ichol`` preconditioner family.

* ``ichol(g, droptol=0.0)`` — zero-fill IC on the matrix pattern
  (cuSPARSE csric02 analogue): fast construction, weaker preconditioner.
* ``ichol(g, droptol=τ)`` — threshold-dropping IC (MATLAB
  ``ichol(...,'ict')`` analogue): drop |v| < τ·norm(col).

Both factor the grounded Laplacian with a Manteuffel-style diagonal shift
retry on breakdown.  Host-side sequential numpy/scipy, the same code as
the reference package's, so the factor is the same bit for bit; the
device takes it as the fleet's ``(G, D)`` factor
(:func:`ichol_device_factor`) and applies it with the same level sweeps
as the randomized AC factor.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg below)
import torch

from .laplacian import Graph, grounded_laplacian_coo
from .ref_ac import DeviceFactor


def _laplacian_csc(g: Graph, shift: float) -> sp.csc_matrix:
    i, j, v = grounded_laplacian_coo(g, shift)
    return sp.coo_matrix((v, (i, j)), shape=(g.n, g.n)).tocsc()


@dataclasses.dataclass
class ICholFactor:
    """L_ic lower-triangular CSC with explicit diagonal (A ≈ L Lᵀ)."""

    L: sp.csc_matrix
    shift: float

    def apply(self, r: np.ndarray) -> np.ndarray:
        y = sp.linalg.spsolve_triangular(self.L.tocsr(), r, lower=True)
        return sp.linalg.spsolve_triangular(self.L.T.tocsr(), y, lower=False)

    @property
    def nnz(self) -> int:
        return self.L.nnz


def _ic_factor(A: sp.csc_matrix, droptol: float) -> sp.csc_matrix:
    """Left-looking IC with threshold dropping (droptol=0 ⇒ IC(0) pattern)."""
    n = A.shape[0]
    A = A.tocsc()
    cols_i: list = []
    cols_v: list = []
    # row-wise access to already-computed columns: store per-row lists
    row_entries: list = [[] for _ in range(n)]  # (col, val)
    pattern = [set(A.indices[A.indptr[k]:A.indptr[k + 1]]) for k in range(n)] \
        if droptol == 0.0 else None
    for k in range(n):
        lo, hi = A.indptr[k], A.indptr[k + 1]
        col = dict(zip(A.indices[lo:hi], A.data[lo:hi]))
        # subtract L(k:,j) * L(k,j) for all j < k with L(k,j) != 0
        for (j, lkj) in row_entries[k]:
            for (i2, lij) in zip(cols_i[j], cols_v[j]):
                if i2 >= k:
                    col[i2] = col.get(i2, 0.0) - lij * lkj
        dkk = col.pop(k, 0.0)
        if dkk <= 0:
            raise FloatingPointError(f"IC breakdown at column {k}")
        lkk = np.sqrt(dkk)
        ids, vals = [], []
        if col:
            items = [(i2, v / lkk) for i2, v in col.items() if i2 > k]
            if droptol > 0.0:
                nrm = np.sqrt(sum(v * v for _, v in items)) or 1.0
                items = [(i2, v) for i2, v in items
                         if abs(v) >= droptol * nrm]
            else:
                items = [(i2, v) for i2, v in items
                         if i2 in pattern[k]]
            items.sort()
            ids = [i2 for i2, _ in items]
            vals = [v for _, v in items]
            for i2, v in zip(ids, vals):
                row_entries[i2].append((k, v))
        cols_i.append(np.array([k] + ids, np.int64))
        cols_v.append(np.array([lkk] + vals, np.float64))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum([c.size for c in cols_i], out=indptr[1:])
    indices = np.concatenate(cols_i)
    data = np.concatenate(cols_v)
    return sp.csc_matrix((data, indices, indptr), shape=(n, n))


def ichol(g: Graph, droptol: float = 0.0, max_shift_tries: int = 8
          ) -> ICholFactor:
    """Incomplete Cholesky of ``g``'s grounded Laplacian; on breakdown the
    diagonal shift doubles (from 1e-3) up to ``max_shift_tries`` times,
    then ``RuntimeError``."""
    shift = 0.0
    for _ in range(max_shift_tries):
        try:
            L = _ic_factor(_laplacian_csc(g, shift), droptol)
            return ICholFactor(L=L, shift=shift)
        except FloatingPointError:
            shift = max(2 * shift, 1e-3)
    raise RuntimeError("ichol breakdown even with diagonal shift")


def ichol_device_factor(g: Graph, droptol: float = 0.0,
                        max_shift_tries: int = 8,
                        dtype=np.float32) -> DeviceFactor:
    """Incomplete Cholesky re-expressed as the fleet's ``(G, D)`` form.

    ``L_ic L_icᵀ = G D Gᵀ`` with ``G = L_ic · diag(1/ℓ_kk)`` unit lower
    triangular and ``D = diag(ℓ_kk²)`` — the shape the randomized AC
    factor ships in, so an ichol preconditioner rides the same schedule
    build, fleet admission and level sweeps as AC.  Returns a
    :class:`~repro_torch.core.ref_ac.DeviceFactor` of CPU tensors
    (strict-lower ``G`` in CSC as int32 ``col_ptr``/``rows``, ``dtype``
    ``vals`` and ``D``); the cache's admission moves it to its device.
    Raises ``RuntimeError`` when IC broke down even at the largest
    shift."""
    ic = ichol(g, droptol=droptol, max_shift_tries=max_shift_tries)
    L = ic.L.tocsc()
    n = g.n
    col_ptr = np.zeros(n + 1, np.int64)
    rows_l: list = []
    vals_l: list = []
    D = np.zeros(n, np.float64)
    for k in range(n):
        lo, hi = L.indptr[k], L.indptr[k + 1]
        idx = L.indices[lo:hi]
        val = L.data[lo:hi]
        dpos = np.nonzero(idx == k)[0]
        lkk = float(val[dpos[0]])
        D[k] = lkk * lkk
        off = idx != k
        rows_l.append(idx[off].astype(np.int32))
        vals_l.append(val[off] / lkk)
        col_ptr[k + 1] = col_ptr[k] + int(off.sum())
    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int32)
    vals = np.concatenate(vals_l) if vals_l else np.zeros(0, np.float64)
    return DeviceFactor(
        col_ptr=torch.from_numpy(col_ptr.astype(np.int32)),
        rows=torch.from_numpy(rows.astype(np.int32)),
        vals=torch.from_numpy(vals.astype(dtype)),
        D=torch.from_numpy(D.astype(dtype)))


def jacobi_preconditioner(g: Graph) -> Callable:
    """``r -> D⁻¹ r`` with ``D`` the weighted degrees (0 where a vertex
    has none)."""
    wd = g.weighted_degrees()
    dinv = np.where(wd > 0, 1.0 / np.maximum(wd, 1e-30), 0.0)

    def apply(r: np.ndarray) -> np.ndarray:
        return dinv * r

    return apply
