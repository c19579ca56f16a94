"""The benchmark's own graphs, in numpy.  A configuration's ``graph``
entry names a generator and an elimination ordering, each a file of its
own (``portbench/generators/<name>.py``, ``portbench/orderings/<name>.py``:
frozen copies, not the program's), with their arguments and fixed seeds,
so a graph is the same in every run whatever ``--seed`` is.

Both sides get the same arrays: the program wraps them in its ``Graph``,
the reference reads them as they are.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

HERE = Path(__file__).resolve().parent


class Edges(NamedTuple):
    """Weighted undirected graph, one record per edge, ``src < dst``."""

    n: int
    src: np.ndarray   # int32[m]
    dst: np.ndarray   # int32[m]
    w: np.ndarray     # float32[m], strictly positive

    @property
    def m(self) -> int:
        return int(self.src.shape[0])


def permute(g: Edges, perm: np.ndarray) -> Edges:
    ns = perm[g.src].astype(np.int32)
    nd = perm[g.dst].astype(np.int32)
    return Edges(g.n, np.minimum(ns, nd), np.maximum(ns, nd), g.w.copy())


def coalesce(g: Edges) -> Edges:
    """Merge parallel edges (weights summed), drop self loops, sort by
    ``(src, dst)``."""
    keep = g.src != g.dst
    src, dst, w = g.src[keep], g.dst[keep], g.w[keep]
    key = src.astype(np.int64) * g.n + dst
    order = np.argsort(key, kind="stable")
    key, w = key[order], w[order]
    uniq, inv = np.unique(key, return_inverse=True)
    wm = np.zeros(uniq.shape[0], dtype=w.dtype)
    np.add.at(wm, inv, w)
    return Edges(g.n, (uniq // g.n).astype(np.int32),
                  (uniq % g.n).astype(np.int32), wm)


def build(graph: dict, base: Path = HERE) -> Edges:
    """The graph a configuration's ``graph`` entry names: the edges of
    ``base/generators/<generator>.py``'s ``build(graph)``, relabelled by
    ``base/orderings/<ordering>.py``'s ``order(edges, ordering_seed)``
    and coalesced."""
    from portbench.harness import load_module
    gen = load_module(base / "generators" / f"{graph['generator']}.py",
                      f"portbench_generator_{graph['generator']}")
    name = graph["ordering"]
    ordering = load_module(base / "orderings" / f"{name}.py",
                           "portbench_ordering_" + name.replace("-", "_"))
    g = gen.build(graph)
    return coalesce(permute(g, ordering.order(g, int(graph["ordering_seed"]))))
