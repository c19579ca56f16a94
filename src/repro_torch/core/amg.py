"""Smoothed-aggregation AMG V-cycle — HyPre/AmgX stand-in baseline.

Greedy strength-based aggregation, piecewise-constant tentative
prolongator smoothed by one weighted-Jacobi step, Galerkin coarse
operators, V(1,1)-cycle with weighted-Jacobi smoothing.  scipy.sparse
host implementation, the same code as the reference package's (so the
flattened operator is the same bit for bit); the ``amg`` family serves
it as one materialized ELL operator (:func:`amg_ell_precond`).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import scipy.sparse as sp

from .laplacian import Graph, grounded_laplacian_coo
from .spai import EllPrecond, dense_to_ell


def _laplacian_csr(g: Graph) -> sp.csr_matrix:
    # grounding shared with ichol (an absolute 1e-12 diagonal epsilon):
    # the previous amg-local variant scaled the epsilon by
    # ``wd.max() or 1.0``, an ``or`` over a numpy float whose truthiness
    # silently rewrote a 0.0 maximum — and meant the two baselines
    # factored *different* operators.  Both now ground identically.
    i, j, v = grounded_laplacian_coo(g)
    return sp.coo_matrix((v, (i, j)), shape=(g.n, g.n)).tocsr()


def _aggregate(A: sp.csr_matrix, theta: float = 0.08) -> np.ndarray:
    """Greedy aggregation on the strength graph."""
    n = A.shape[0]
    D = np.asarray(A.diagonal())
    agg = np.full(n, -1, np.int64)
    next_agg = 0
    indptr, indices, data = A.indptr, A.indices, A.data
    # pass 1: seed aggregates around unaggregated vertices
    for v in range(n):
        if agg[v] >= 0:
            continue
        nbrs = indices[indptr[v]:indptr[v + 1]]
        vals = data[indptr[v]:indptr[v + 1]]
        strong = nbrs[(nbrs != v) & (-vals >= theta * np.sqrt(
            np.abs(D[v] * D[nbrs]) + 1e-30))]
        if np.all(agg[strong] < 0):
            agg[v] = next_agg
            agg[strong] = next_agg
            next_agg += 1
    # pass 2: attach leftovers to a strong neighbour's aggregate
    for v in range(n):
        if agg[v] >= 0:
            continue
        nbrs = indices[indptr[v]:indptr[v + 1]]
        cand = nbrs[agg[nbrs] >= 0]
        if cand.size:
            vals = data[indptr[v]:indptr[v + 1]][agg[nbrs] >= 0]
            agg[v] = agg[cand[np.argmin(vals)]]
        else:
            agg[v] = next_agg
            next_agg += 1
    return agg


def _build_hierarchy(A: sp.csr_matrix, max_levels: int = 10,
                     min_coarse: int = 64):
    levels = [{"A": A}]
    while len(levels) < max_levels and levels[-1]["A"].shape[0] > min_coarse:
        Al = levels[-1]["A"]
        agg = _aggregate(Al)
        nc = int(agg.max()) + 1
        if nc >= Al.shape[0]:
            break
        T = sp.coo_matrix((np.ones(Al.shape[0]),
                           (np.arange(Al.shape[0]), agg)),
                          shape=(Al.shape[0], nc)).tocsr()
        Dinv = sp.diags(1.0 / np.maximum(Al.diagonal(), 1e-30))
        P = (sp.identity(Al.shape[0]) - (2.0 / 3.0) * (Dinv @ Al)) @ T
        Ac = (P.T @ Al @ P).tocsr()
        levels[-1].update(P=P)
        levels.append({"A": Ac})
    return levels


def _jacobi(A, Dinv, x, b, omega=2.0 / 3.0, iters=1):
    for _ in range(iters):
        x = x + omega * Dinv * (b - A @ x)
    return x


def smoothed_aggregation_preconditioner(g: Graph) -> Callable:
    A = _laplacian_csr(g)
    levels = _build_hierarchy(A)
    for lv in levels:
        lv["Dinv"] = 1.0 / np.maximum(lv["A"].diagonal(), 1e-30)
    coarse = levels[-1]["A"].toarray()
    coarse_pinv = np.linalg.pinv(coarse)

    def cycle(lv: int, b: np.ndarray) -> np.ndarray:
        if lv == len(levels) - 1:
            return coarse_pinv @ b
        L = levels[lv]
        x = _jacobi(L["A"], L["Dinv"], np.zeros_like(b), b)
        r = b - L["A"] @ x
        xc = cycle(lv + 1, L["P"].T @ r)
        x = x + L["P"] @ xc
        return _jacobi(L["A"], L["Dinv"], x, b)

    return lambda r: cycle(0, np.asarray(r, np.float64))


def amg_ell_precond(g: Graph, *, droptol: float = 1e-3,
                    dtype=np.float32) -> EllPrecond:
    """Flatten the V(1,1)-cycle into a materialized ELL operator.

    The smoothed-aggregation V-cycle is a fixed **linear** operator
    ``M ≈ L⁺`` (Jacobi smoothing, Galerkin coarse operators and the
    coarse pseudo-inverse are all linear, and the hierarchy is frozen at
    construction), so applying it to the ``n`` basis vectors
    materializes it exactly.  The dense result is symmetrized (the
    V(1,1) cycle with matched pre/post smoothing is symmetric up to
    roundoff) and packed into ELL rows, turning every serving-side apply
    into a single lane-batched SpMV — the same fleet kernel the SPAI
    family rides — instead of a host V-cycle per iteration.

    Materialization costs ``n`` cycle applies and densifies rows, so
    this is for serving-scale graphs (a few thousand vertices: the
    dense ``n × n`` float64 operator is built whole).

    Args:
        g: graph to precondition.
        droptol: relative drop threshold on the flattened operator
            (``1e-3`` trims roundoff-level fill; ``0.0`` keeps the
            cycle exactly).
        dtype: value dtype of the packed rows.

    Returns:
        The packed :class:`~repro_torch.core.spai.EllPrecond` with
        ``meta["levels"]`` recording the hierarchy depth.
    """
    cycle = smoothed_aggregation_preconditioner(g)
    n = g.n
    M = np.empty((n, n), np.float64)
    e = np.zeros(n, np.float64)
    for j in range(n):
        e[j] = 1.0
        M[:, j] = cycle(e)
        e[j] = 0.0
    M = 0.5 * (M + M.T)
    # Deflate the constant mode: the cycle approximates the inverse of
    # the *grounded* Laplacian, whose 1e-12 epsilon makes it amplify
    # span(1) by ~1e12 — harmless to the float64 host PCG (projection
    # kills it to roundoff) but catastrophic in the float32 fleet apply,
    # and it would dominate the relative droptol.  Serving PCG iterates
    # mean-zero, so ``P M P`` (P = I - 11ᵀ/n) is the operator that
    # actually acts — SPD on the mean-zero subspace.
    M = M - M.mean(axis=1, keepdims=True) - M.mean(axis=0, keepdims=True) \
        + M.mean()
    out = dense_to_ell(M, droptol=droptol, dtype=dtype)
    out.meta.update(family="amg")
    return out
