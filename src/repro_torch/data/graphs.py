"""Laptop-scale analogues of the paper's test-matrix families (Table 1).

| paper matrix                | generator here                      |
|-----------------------------|-------------------------------------|
| uniform 3D poisson          | ``grid3d(..., kind='uniform')``     |
| anisotropic 3D poisson      | ``grid3d(..., kind='aniso')``       |
| high contrast 3D poisson    | ``grid3d(..., kind='contrast')``    |
| parabolic_fem / apache2 …   | ``grid2d`` (2/5-point stencils)     |
| GAP-road / europe_osm       | ``road_like`` (sparse planar-ish)   |
| com-LiveJournal             | ``powerlaw`` (Barabási–Albert)      |
| delaunay_n24                | ``delaunay_like``                   |
| spe16m                      | ``grid3d(..., kind='contrast')``    |

All generators return a coalesced ``Graph`` with positive weights and a
deterministic seed.
"""
from __future__ import annotations

import numpy as np

from ..core.laplacian import Graph


def grid2d(nx: int, ny: int, seed: int = 0, weighted: bool = True) -> Graph:
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    vid = (ii * ny + jj).astype(np.int32)
    src = np.concatenate([vid[:-1, :].ravel(), vid[:, :-1].ravel()])
    dst = np.concatenate([vid[1:, :].ravel(), vid[:, 1:].ravel()])
    m = src.shape[0]
    w = rng.uniform(0.5, 2.0, m) if weighted else np.ones(m)
    return Graph(nx * ny, src.astype(np.int32), dst.astype(np.int32),
                 w.astype(np.float32))


def grid3d(nx: int, ny: int, nz: int, kind: str = "uniform",
           seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    vid = (ii * ny * nz + jj * nz + kk).astype(np.int32)
    src = np.concatenate([vid[:-1, :, :].ravel(), vid[:, :-1, :].ravel(),
                          vid[:, :, :-1].ravel()])
    dst = np.concatenate([vid[1:, :, :].ravel(), vid[:, 1:, :].ravel(),
                          vid[:, :, 1:].ravel()])
    mx = vid[:-1, :, :].size
    my = vid[:, :-1, :].size
    m = src.shape[0]
    if kind == "uniform":
        w = np.ones(m)
    elif kind == "aniso":
        w = np.concatenate([np.full(mx, 100.0), np.full(my, 1.0),
                            np.full(m - mx - my, 0.01)])
    elif kind == "contrast":
        # high-contrast random coefficient field: log-uniform cellwise
        w = 10.0 ** rng.uniform(-3, 3, m)
    else:
        raise ValueError(kind)
    return Graph(nx * ny * nz, src.astype(np.int32), dst.astype(np.int32),
                 w.astype(np.float32))


def powerlaw(n: int, m_attach: int = 8, seed: int = 0) -> Graph:
    """Barabási–Albert preferential attachment (com-LiveJournal analogue:
    high density, hub vertices — the paper's hardest parallelism case)."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_attach))
    repeated: list = list(range(m_attach))
    src, dst = [], []
    for v in range(m_attach, n):
        ts = rng.choice(repeated, size=m_attach, replace=False) \
            if len(repeated) >= m_attach else targets
        for t in set(int(t) for t in ts):
            src.append(min(v, t))
            dst.append(max(v, t))
            repeated.append(t)
            repeated.append(v)
    w = rng.uniform(0.5, 2.0, len(src))
    return Graph(n, np.array(src, np.int32), np.array(dst, np.int32),
                 w.astype(np.float32)).coalesce()


def road_like(n_side: int, extra_frac: float = 0.1, seed: int = 0) -> Graph:
    """Sparse near-planar graph (road-network analogue): 2D grid with a
    fraction of random diagonal shortcuts and strong weight variation."""
    rng = np.random.default_rng(seed)
    g = grid2d(n_side, n_side, seed=seed)
    n_extra = int(extra_frac * g.m)
    i = rng.integers(0, n_side - 1, n_extra)
    j = rng.integers(0, n_side - 1, n_extra)
    s = (i * n_side + j).astype(np.int32)
    d = ((i + 1) * n_side + (j + 1)).astype(np.int32)
    src = np.concatenate([g.src, np.minimum(s, d)])
    dst = np.concatenate([g.dst, np.maximum(s, d)])
    w = np.concatenate([g.w, rng.uniform(0.1, 10.0, n_extra).astype(np.float32)])
    return Graph(g.n, src, dst, w).coalesce()


def delaunay_like(n: int, seed: int = 0) -> Graph:
    """Delaunay triangulation of random points (delaunay_n24 analogue)."""
    from scipy.spatial import Delaunay
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 2))
    tri = Delaunay(pts)
    e = np.concatenate([tri.simplices[:, [0, 1]], tri.simplices[:, [1, 2]],
                        tri.simplices[:, [0, 2]]])
    lo = e.min(axis=1).astype(np.int32)
    hi = e.max(axis=1).astype(np.int32)
    w = rng.uniform(0.5, 2.0, lo.shape[0]).astype(np.float32)
    return Graph(n, lo, hi, w).coalesce()


def random_regular(n: int, d: int = 4, seed: int = 0) -> Graph:
    """Random d-regular expander (well-conditioned sanity case)."""
    import networkx as nx
    G = nx.random_regular_graph(d, n, seed=seed)
    e = np.array(G.edges(), np.int32)
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, e.shape[0]).astype(np.float32)
    return Graph(n, e.min(axis=1).astype(np.int32),
                 e.max(axis=1).astype(np.int32), w).coalesce()


SUITE_MICRO = {
    # sub-100-vertex graphs (two shape buckets) for tests and benchmarks
    # that measure orchestration — routing, scheduling — not solve scale
    "grid2d_micro": lambda: grid2d(6, 6, seed=3),
    "powerlaw_micro": lambda: powerlaw(80, 4, seed=3),
    "road_micro": lambda: road_like(6, seed=4),
}

SUITE_TINY = {
    # sub-second graphs for CI smoke jobs and service traces
    "grid2d_tiny": lambda: grid2d(12, 12, seed=3),
    "powerlaw_tiny": lambda: powerlaw(300, 5, seed=3),
    "road_tiny": lambda: road_like(10, seed=4),
}

SUITE = {
    "grid2d_64": lambda: grid2d(64, 64, seed=1),
    "grid3d_uniform_16": lambda: grid3d(16, 16, 16, "uniform", seed=2),
    "grid3d_aniso_16": lambda: grid3d(16, 16, 16, "aniso", seed=3),
    "grid3d_contrast_16": lambda: grid3d(16, 16, 16, "contrast", seed=4),
    "road_64": lambda: road_like(64, seed=5),
    "powerlaw_4k": lambda: powerlaw(4096, 8, seed=6),
    "delaunay_4k": lambda: delaunay_like(4096, seed=7),
    "regular_4k": lambda: random_regular(4096, 4, seed=8),
}

SUITE_LARGE = {
    "grid2d_256": lambda: grid2d(256, 256, seed=11),
    "grid3d_uniform_32": lambda: grid3d(32, 32, 32, "uniform", seed=12),
    "grid3d_contrast_32": lambda: grid3d(32, 32, 32, "contrast", seed=13),
    "road_256": lambda: road_like(256, seed=14),
    "powerlaw_50k": lambda: powerlaw(50_000, 8, seed=15),
    "delaunay_50k": lambda: delaunay_like(50_000, seed=16),
}
