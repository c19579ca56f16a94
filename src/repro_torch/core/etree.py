"""Elimination-tree and critical-path analysis (paper Fig. 4).

Three structural quantities per (graph, ordering):

  * **classical e-tree height** — height of the elimination tree of the
    *exact* (clique fill) factorization, computed with Liu's
    path-compression algorithm directly from the matrix pattern;
  * **actual e-tree height** — dependency-DAG longest path of the
    *randomized* factor: level(k) = 1 + max level over columns j whose
    sampled column contains k.  This equals the number of bulk-synchronous
    wavefronts the ParAC engine needs (DESIGN.md §2);
  * **triangular-solve critical path** — longest path through all nonzeros
    of G (equals ``LevelSchedule.n_levels`` of the forward solve).
"""
from __future__ import annotations

import numpy as np

from .laplacian import Graph
from .ref_ac import ACFactor


def classical_etree(g: Graph, perm: np.ndarray) -> np.ndarray:
    """Liu's algorithm: e-tree of the filled pattern from A's pattern only.

    Returns parent array over elimination positions (-1 = root).
    """
    n = g.n
    lo = np.minimum(perm[g.src], perm[g.dst])
    hi = np.maximum(perm[g.src], perm[g.dst])
    order = np.argsort(hi, kind="stable")
    lo, hi = lo[order], hi[order]
    parent = np.full(n, -1, np.int64)
    ancestor = np.full(n, -1, np.int64)
    ptr = 0
    for i in range(n):
        while ptr < hi.shape[0] and hi[ptr] == i:
            k = lo[ptr]
            ptr += 1
            # walk from k to the root of its current subtree, compressing
            while True:
                a = ancestor[k]
                ancestor[k] = i
                if a == -1:
                    if k != i and parent[k] == -1:
                        parent[k] = i
                    break
                if a == i:
                    break
                k = a
    return parent


def tree_height(parent: np.ndarray) -> int:
    """Longest root-to-leaf path (#nodes) of a forest given parent[]."""
    n = parent.shape[0]
    depth = np.zeros(n, np.int64)
    # parents always have larger position index ⇒ process descending
    for i in range(n - 1, -1, -1):
        p = parent[i]
        if p >= 0:
            depth[i] = depth[p] + 1
    return int(depth.max()) + 1 if n else 0


def classical_etree_height(g: Graph, perm: np.ndarray) -> int:
    return tree_height(classical_etree(g, perm))


def factor_levels(f: ACFactor) -> np.ndarray:
    """Wavefront level of every column of the randomized factor."""
    n = f.n
    cols = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(f.col_ptr).astype(np.int64))
    rows = f.rows.astype(np.int64)
    level = np.zeros(n, np.int64)
    while True:  # level-synchronous longest-path relaxation
        cand = np.zeros(n, np.int64)
        np.maximum.at(cand, rows, level[cols] + 1)
        new = np.maximum(level, cand)
        if np.array_equal(new, level):
            return level
        level = new


def actual_etree_height(f: ACFactor) -> int:
    """Actual dependency height = #wavefronts (paper Fig. 4 'actual')."""
    lv = factor_levels(f)
    return int(lv.max()) + 1 if f.n else 0


def actual_parent_etree_height(f: ACFactor) -> int:
    """Height of the e-tree defined as parent = first nonzero per column
    (the paper's strict e-tree definition, Def. 3.1)."""
    n = f.n
    parent = np.full(n, -1, np.int64)
    for c in range(n):
        lo, hi = f.col_ptr[c], f.col_ptr[c + 1]
        if hi > lo:
            parent[c] = int(f.rows[lo:hi].min())
    return tree_height(parent)


def wavefront_profile(f: ACFactor) -> np.ndarray:
    """Histogram: #columns eliminable at each wavefront (parallelism profile)."""
    lv = factor_levels(f)
    return np.bincount(lv)
