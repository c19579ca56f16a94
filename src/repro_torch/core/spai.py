"""Sparse approximate inverse (SPAI) preconditioner in ELL row layout.

The apply of a SPAI preconditioner is a single SpMV ``z = M r`` with a
*materialized* sparse approximate inverse ``M ≈ L⁺`` — which makes it a
perfect fit for the fleet's lane-batched ELL SpMV kernel
(``repro_torch.kernels.spmv.ell_spmv_fleet``, the full-row kernel of
``csrc/ell_spmv_fleet.cu``): one kernel launch per
PCG iteration instead of the ``f_levels + b_levels`` masked sweeps a
triangular factor pays.  This is the serving-side point of the SPAI
lineage (arxiv 2510.27517): trade construction-time least squares for a
branch-free, mega-batchable apply.

Construction here is the **factored** SPAI (FSAI, Kolotilina–Yeremin):
build a sparse lower-triangular ``G ≈ L_chol⁻¹`` by solving one small
SPD system per row over the row's lower-triangular sparsity pattern,
then materialize ``M = Gᵀ G`` — symmetric positive definite *by
construction*, unlike plain column-wise SPAI whose symmetrization can
go indefinite.  ``M``'s pattern is the 2-hop closure of the graph, so
rows densify with degree²; at the tiny/medium serving scales this repo
targets that is cheap; ``M`` is formed dense (``n × n`` float64), so
the family is for graphs of a few thousand vertices.

Host scipy/numpy construction, the same code as the reference package's
(so the payload is the same bit for bit); the product ``M`` ships to the
device once via the family's ``FactorCache`` attach.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from .laplacian import Graph, grounded_laplacian_coo


@dataclasses.dataclass
class EllPrecond:
    """A materialized approximate inverse ``M`` as padded ELL rows —
    the host-side payload of every ``"spmv"``-kind preconditioner
    family (SPAI, flattened AMG).

    Row ``i``'s nonzeros occupy ``cols[i, :]``/``vals[i, :]``; unused
    slots carry ``cols == 0, vals == 0`` so padded slots contribute
    exactly zero to the SpMV.  The fleet admission path scatters these
    rows into the bucket's forward-panel arrays and the apply runs as
    one ``ell_spmv_fleet`` launch.
    """

    n: int
    cols: np.ndarray    # int32[n, K]
    vals: np.ndarray    # f32[n, K]
    nnz: int = 0
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def K(self) -> int:
        return int(self.cols.shape[1])

    @property
    def device_bytes(self) -> int:
        """Bytes one device copy of the ELL rows would occupy (the
        fleet row is the actual resident copy; this sizes it)."""
        return int(self.cols.nbytes + self.vals.nbytes)

    def apply(self, r: np.ndarray) -> np.ndarray:
        """Host reference apply ``z = M r`` (tests/baselines; the
        serving path runs the fleet ELL kernel instead)."""
        return np.sum(self.vals * np.asarray(r, self.vals.dtype)[self.cols],
                      axis=1)


def dense_to_ell(M: np.ndarray, *, droptol: float = 0.0,
                 dtype=np.float32) -> EllPrecond:
    """Pack a dense symmetric approximate inverse into ELL rows.

    Entries with ``|m_ij| < droptol · max|M|`` are dropped (a global
    threshold keeps the drop mask symmetric, so the packed operator
    stays symmetric); diagonal entries are always kept.  ``K`` is the
    post-drop maximum row count.

    Args:
        M: dense ``(n, n)`` symmetric operator.
        droptol: relative drop threshold (``0.0`` keeps everything).
        dtype: value dtype of the packed rows.

    Returns:
        The packed :class:`EllPrecond`.
    """
    n = M.shape[0]
    if droptol > 0.0:
        mmax = float(np.abs(M).max())
        keep = np.abs(M) >= droptol * (mmax if mmax > 0.0 else 1.0)
    else:
        keep = np.abs(M) != 0.0
    np.fill_diagonal(keep, True)
    counts = keep.sum(axis=1)
    K = max(int(counts.max()), 1)
    cols = np.zeros((n, K), np.int32)
    vals = np.zeros((n, K), dtype)
    for i in range(n):
        js = np.nonzero(keep[i])[0]
        cols[i, :js.size] = js
        vals[i, :js.size] = M[i, js].astype(dtype)
    return EllPrecond(n=n, cols=cols, vals=vals, nnz=int(counts.sum()),
                      meta={"droptol": float(droptol)})


def fsai_lower(g: Graph, shift: float = 0.0) -> sp.csr_matrix:
    """Factored-SPAI lower triangle ``G ≈ L_chol⁻¹`` on the pattern of
    the grounded Laplacian.

    Row ``i``'s pattern is ``J = {j ≤ i : A[i, j] ≠ 0}``; the row
    solves the local SPD system ``A[J, J] y = e_last`` and is scaled by
    ``1/√y_last`` so ``G A Gᵀ`` has unit diagonal — the classical FSAI
    normalization, which makes ``Gᵀ G`` an SPD approximation of ``A⁻¹``.

    Args:
        g: graph whose grounded Laplacian to approximate.
        shift: optional relative diagonal shift (same meaning as
            ``ichol``'s Manteuffel retry shift).

    Returns:
        ``G`` as lower-triangular CSR.
    """
    i, j, v = grounded_laplacian_coo(g, shift)
    A = sp.coo_matrix((v, (i, j)), shape=(g.n, g.n)).tocsr()
    n = g.n
    rows_i: list = []
    rows_j: list = []
    rows_v: list = []
    for r in range(n):
        lo, hi = A.indptr[r], A.indptr[r + 1]
        J = A.indices[lo:hi]
        J = np.sort(J[J <= r])
        if J.size == 0 or J[-1] != r:
            J = np.append(J, r)
        Aloc = A[np.ix_(J, J)].toarray()
        e = np.zeros(J.size)
        e[-1] = 1.0
        y = np.linalg.solve(Aloc, e)
        ylast = y[-1]
        if ylast <= 0:                    # local breakdown: Jacobi row
            y = np.zeros(J.size)
            y[-1] = 1.0
            ylast = 1.0 / max(float(Aloc[-1, -1]), 1e-30)
            y[-1] = ylast
        gr = y / np.sqrt(ylast)
        rows_i.append(np.full(J.size, r, np.int64))
        rows_j.append(J.astype(np.int64))
        rows_v.append(gr)
    return sp.coo_matrix(
        (np.concatenate(rows_v),
         (np.concatenate(rows_i), np.concatenate(rows_j))),
        shape=(n, n)).tocsr()


def spai_ell_precond(g: Graph, *, droptol: float = 0.0,
                     dtype=np.float32) -> EllPrecond:
    """Build the SPAI family's ELL operator ``M = Gᵀ G`` for ``g``.

    ``G`` is the FSAI lower triangle (:func:`fsai_lower`), so ``M`` is
    SPD by construction; the product is formed sparsely and packed row
    by row (``droptol`` trims the 2-hop fill relative to the largest
    entry of ``M``).

    Args:
        g: graph to precondition.
        droptol: relative drop threshold on ``M``'s entries.
        dtype: value dtype of the packed rows.

    Returns:
        The packed :class:`EllPrecond` with construction metadata in
        ``meta`` (``{"family": "spai", "nnz_G": ...}``).
    """
    G = fsai_lower(g)
    M = (G.T @ G).toarray()
    out = dense_to_ell(M, droptol=droptol, dtype=dtype)
    out.meta.update(family="spai", nnz_G=int(G.nnz))
    return out
