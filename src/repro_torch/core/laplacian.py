"""Graph / Laplacian containers and basic linear-algebra helpers.

Weighted undirected graphs are edge lists with ``src < dst`` (one record
per undirected edge), held in numpy on the host; the operators take
torch tensors on whatever device the caller chose.  The numpy parts are
a copy of the reference package's, so both see identical graphs.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Graph:
    """Weighted undirected graph, one record per edge, ``src < dst``."""

    n: int
    src: np.ndarray  # int32[m]
    dst: np.ndarray  # int32[m]
    w: np.ndarray    # float[m], strictly positive

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    def validate(self) -> None:
        assert self.src.shape == self.dst.shape == self.w.shape
        assert np.all(self.src < self.dst), "edges must satisfy src < dst"
        assert np.all(self.src >= 0) and np.all(self.dst < self.n)
        assert np.all(self.w > 0), "edge weights must be positive"

    def degrees(self) -> np.ndarray:
        """Number of incident edges per vertex."""
        deg = np.zeros(self.n, dtype=np.int64)
        np.add.at(deg, self.src, 1)
        np.add.at(deg, self.dst, 1)
        return deg

    def weighted_degrees(self) -> np.ndarray:
        wd = np.zeros(self.n, dtype=np.float64)
        np.add.at(wd, self.src, self.w)
        np.add.at(wd, self.dst, self.w)
        return wd

    def coalesce(self) -> "Graph":
        """Merge parallel edges (sum weights) and drop self loops."""
        keep = self.src != self.dst
        src, dst, w = self.src[keep], self.dst[keep], self.w[keep]
        key = src.astype(np.int64) * self.n + dst
        order = np.argsort(key, kind="stable")
        key, w = key[order], w[order]
        uniq, inv = np.unique(key, return_inverse=True)
        wm = np.zeros(uniq.shape[0], dtype=w.dtype)
        np.add.at(wm, inv, w)
        s = (uniq // self.n).astype(np.int32)
        d = (uniq % self.n).astype(np.int32)
        return Graph(self.n, s, d, wm)

    def permute(self, perm: np.ndarray) -> "Graph":
        """Relabel vertices: new label of old vertex v is ``perm[v]`` (the
        elimination position)."""
        ns = perm[self.src].astype(np.int32)
        nd = perm[self.dst].astype(np.int32)
        return Graph(self.n, np.minimum(ns, nd), np.maximum(ns, nd),
                     self.w.copy())


def grounded_laplacian_coo(g: Graph, shift: float = 0.0):
    """COO triples ``(i, j, v)`` of the grounded (SPD) Laplacian
    ``L + shift·diag(L) + 1e-12·I`` — the operator every host-built
    family (``ichol``, ``amg``, ``spai``) factors or approximates.  The
    grounding is an absolute ``1e-12`` on the diagonal; ``shift`` is the
    relative Manteuffel shift of the incomplete-Cholesky breakdown retry.
    Returns int/float numpy arrays for
    ``scipy.sparse.coo_matrix((v, (i, j)), shape=(g.n, g.n))``."""
    i = np.concatenate([g.src, g.dst, np.arange(g.n)])
    j = np.concatenate([g.dst, g.src, np.arange(g.n)])
    wd = g.weighted_degrees()
    v = np.concatenate([-g.w, -g.w, wd * (1.0 + shift) + 1e-12])
    return i, j, v


def laplacian_dense(g: Graph, dtype=np.float64) -> np.ndarray:
    """Dense Laplacian — tests only."""
    L = np.zeros((g.n, g.n), dtype=dtype)
    np.add.at(L, (g.src, g.src), g.w)
    np.add.at(L, (g.dst, g.dst), g.w)
    np.add.at(L, (g.src, g.dst), -g.w)
    np.add.at(L, (g.dst, g.src), -g.w)
    return L


def laplacian_matvec_np(g: Graph, x: np.ndarray) -> np.ndarray:
    """y = L x on host (numpy), edge-list formulation."""
    diff = x[g.src] - x[g.dst]
    y = np.zeros_like(x)
    np.add.at(y, g.src, g.w * diff)
    np.add.at(y, g.dst, -g.w * diff)
    return y


def laplacian_matvec(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                     n: int, x: torch.Tensor) -> torch.Tensor:
    """y = L x, ``L = Σ w_e (e_s - e_d)(e_s - e_d)ᵀ`` (edge-parallel
    gather + scatter-add; the float scatter-add is not deterministic on
    CUDA — the solve path uses :func:`laplacian_adjacency` rows instead)."""
    diff = w * (x[src.long()] - x[dst.long()])
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    y.index_add_(0, src.long(), diff)
    y.index_add_(0, dst.long(), -diff)
    return y


def laplacian_adjacency(g: Graph, n_rows: int = 0, K: int = 0,
                        dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Each vertex's incident edges as ELL rows ``(nbr, w)``, zero-padded
    to ``K`` slots and ``n_rows`` rows: first the edges where the vertex
    is ``src``, then those where it is ``dst``, each in edge order — the
    order in which the edge-list matvec's scatter-adds reach it.  With
    them ``(L x)_i = Σ_k w[i,k]·(x_i − x[nbr[i,k]])`` summed left to right
    is the edge-list matvec term for term and in the same order, and
    needs no float scatter-add (whose CUDA atomics are not
    deterministic)."""
    n = g.n
    deg = g.degrees()
    K = max(K, int(deg.max(initial=0)), 1)
    n_rows = max(n_rows, n)
    nbr = np.zeros((n_rows, K), np.int32)
    wts = np.zeros((n_rows, K), dtype)
    rows = np.concatenate([g.src, g.dst]).astype(np.int64)
    if rows.size:
        order = np.argsort(rows, kind="stable")
        rs = rows[order]
        start = np.concatenate([[True], rs[1:] != rs[:-1]])
        run_start = np.maximum.accumulate(
            np.where(start, np.arange(rs.size), 0))
        slot = np.arange(rs.size) - run_start
        nbr[rs, slot] = np.concatenate([g.dst, g.src])[order]
        wts[rs, slot] = np.concatenate([g.w, g.w]).astype(dtype)[order]
    return nbr, wts


def project_mean_zero(x: torch.Tensor) -> torch.Tensor:
    """Project onto 1⊥ — Laplacians are singular with nullspace span(1)."""
    return x - torch.mean(x)


def sdd_to_grounded_laplacian(A_diag: np.ndarray, g: Graph) -> Graph:
    """Reduce an SDD system ``A = L(g) + diag(surplus)`` to a Laplacian.

    ``A_diag`` is the full diagonal of A; the surplus
    ``s_v = A_vv - Σ_incident w`` must be ≥ 0 (diagonally dominant).  A
    ground vertex ``n`` gets an edge ``(v, n, s_v)`` for every ``v`` with
    ``s_v > 0``; solving the grounded Laplacian with rhs ``[b; -Σb]`` and
    then grounding ``x_n = 0`` solves ``A x = b``.  Raises ``ValueError``
    when ``A`` is not diagonally dominant."""
    wd = g.weighted_degrees()
    surplus = np.asarray(A_diag, dtype=np.float64) - wd
    if np.any(surplus < -1e-9 * np.abs(A_diag)):
        raise ValueError("matrix is not diagonally dominant")
    surplus = np.maximum(surplus, 0.0)
    keep = surplus > 0
    vs = np.nonzero(keep)[0].astype(np.int32)
    gsrc = np.concatenate([g.src, vs])
    gdst = np.concatenate([g.dst, np.full(vs.shape, g.n, dtype=np.int32)])
    gw = np.concatenate([g.w, surplus[keep].astype(g.w.dtype)])
    return Graph(g.n + 1, gsrc, gdst, gw)
