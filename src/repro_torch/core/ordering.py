"""Elimination orderings studied by the paper (§6): random, nnz-sort and an
AMD-like minimum-degree ordering.

``nnz-sort`` sorts vertices ascending by initial degree with randomized
tie-break — the paper's best GPU ordering.  The AMD stand-in is exact
greedy minimum-degree (with clique fill tracking) for small graphs and
reverse Cuthill–McKee (the locality-favouring classical ordering) beyond
that — AMD's supernodal tricks are orthogonal to the paper's contribution
(DESIGN.md §7.3).

A *permutation* here maps original vertex id -> elimination position.
"""
from __future__ import annotations

import numpy as np

from .laplacian import Graph


def natural_order(g: Graph) -> np.ndarray:
    return np.arange(g.n, dtype=np.int32)


def random_order(g: Graph, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(g.n).astype(np.int32)


def nnz_sort_order(g: Graph, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    deg = g.degrees().astype(np.float64)
    jitter = rng.uniform(0, 1, g.n)
    order = np.lexsort((jitter, deg))  # ascending degree, random tie-break
    perm = np.empty(g.n, np.int32)
    perm[order] = np.arange(g.n, dtype=np.int32)
    return perm


def rcm_order(g: Graph) -> np.ndarray:
    """Reverse Cuthill–McKee (locality-favouring)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    A = sp.coo_matrix(
        (np.ones(2 * g.m), (np.concatenate([g.src, g.dst]),
                            np.concatenate([g.dst, g.src]))),
        shape=(g.n, g.n)).tocsr()
    order = reverse_cuthill_mckee(A, symmetric_mode=True)
    perm = np.empty(g.n, np.int32)
    perm[order] = np.arange(g.n, dtype=np.int32)
    return perm


def min_degree_order(g: Graph, max_exact: int = 4000) -> np.ndarray:
    """Greedy minimum degree with clique fill (exact, small n); RCM beyond."""
    if g.n > max_exact:
        return rcm_order(g)
    import heapq
    adj = [set() for _ in range(g.n)]
    for s, d in zip(g.src, g.dst):
        adj[int(s)].add(int(d))
        adj[int(d)].add(int(s))
    heap = [(len(adj[v]), v) for v in range(g.n)]
    heapq.heapify(heap)
    eliminated = np.zeros(g.n, bool)
    perm = np.empty(g.n, np.int32)
    pos = 0
    while heap:
        d, v = heapq.heappop(heap)
        if eliminated[v] or d != len(adj[v]):
            continue  # stale entry
        eliminated[v] = True
        perm[v] = pos
        pos += 1
        nbrs = [u for u in adj[v] if not eliminated[u]]
        for i, a in enumerate(nbrs):  # clique fill
            adj[a].discard(v)
            for b in nbrs[i + 1:]:
                if b not in adj[a]:
                    adj[a].add(b)
                    adj[b].add(a)
        for a in nbrs:
            heapq.heappush(heap, (len(adj[a]), a))
        adj[v] = set()
    return perm


ORDERINGS = {
    "natural": lambda g, seed=0: natural_order(g),
    "random": random_order,
    "nnz-sort": nnz_sort_order,
    "amd-like": lambda g, seed=0: min_degree_order(g),
    "rcm": lambda g, seed=0: rcm_order(g),
}
