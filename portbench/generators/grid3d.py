"""A frozen copy of the 3D Poisson generator: the 7-point stencil
Laplacian of a ``side``³ grid.  A configuration's ``graph`` entry names
``side``, ``kind`` and the fixed ``seed`` of the weights."""
from __future__ import annotations

import numpy as np

from portbench.graphs import Edges


def grid3d(nx: int, ny: int, nz: int, kind: str, seed: int) -> Edges:
    """7-point stencil Laplacian of an ``nx × ny × nz`` grid: unit weights
    (``uniform``), 100 / 1 / 0.01 along the three axes (``aniso``), or
    ``10 ** U(-3, 3)`` per edge (``contrast``)."""
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
        w = 10.0 ** rng.uniform(-3, 3, m)
    else:
        raise ValueError(f"unknown grid kind {kind!r}")
    return Edges(nx * ny * nz, src.astype(np.int32), dst.astype(np.int32),
                 w.astype(np.float32))


def build(graph: dict) -> Edges:
    s = int(graph["side"])
    return grid3d(s, s, s, graph["kind"], int(graph["seed"]))
