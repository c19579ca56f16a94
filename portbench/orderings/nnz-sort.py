"""A frozen copy of the nnz-sort elimination ordering: ascending initial
degree, ties broken at random from the configuration's
``ordering_seed``."""
from __future__ import annotations

import numpy as np

from portbench.graphs import Edges


def order(g: Edges, seed: int) -> np.ndarray:
    """Old vertex id -> new label (the elimination position)."""
    rng = np.random.default_rng(seed)
    deg = np.zeros(g.n, dtype=np.int64)
    np.add.at(deg, g.src, 1)
    np.add.at(deg, g.dst, 1)
    jitter = rng.uniform(0, 1, g.n)
    order = np.lexsort((jitter, deg.astype(np.float64)))
    perm = np.empty(g.n, np.int32)
    perm[order] = np.arange(g.n, dtype=np.int32)
    return perm
