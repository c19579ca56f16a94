"""Port parity: graph generators, orderings and e-tree analysis are the
reference's, array for array."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import graphs as jgraphs                      # noqa: E402
from repro.core import ordering as jordering, etree as jetree  # noqa: E402
from repro.core.laplacian import laplacian_matvec_np as jmv   # noqa: E402
from repro_torch.data import graphs as tgraphs                # noqa: E402
from repro_torch.core import ordering as tordering            # noqa: E402
from repro_torch.core import etree as tetree                  # noqa: E402
from repro_torch.core.laplacian import (                      # noqa: E402
    Graph, laplacian_adjacency, laplacian_dense, laplacian_matvec,
    laplacian_matvec_np)
from repro_torch.core.ref_ac import ACFactor                  # noqa: E402

SUITES = ("SUITE_MICRO", "SUITE_TINY", "SUITE", "SUITE_LARGE")
# powerlaw_50k is left out only for time: its generator (the same code in
# both packages) is quadratic in n and takes over ten minutes to build;
# test_powerlaw_generator_identical covers that generator
CASES = [(s, name) for s in SUITES for name in getattr(jgraphs, s)
         if name != "powerlaw_50k"]


def _same_graph(a, b):
    assert a.n == b.n
    for f in ("src", "dst", "w"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("suite,name", CASES)
def test_suite_graphs_identical(suite, name):
    assert set(getattr(jgraphs, suite)) == set(getattr(tgraphs, suite))
    _same_graph(getattr(jgraphs, suite)[name](),
                getattr(tgraphs, suite)[name]())


def test_powerlaw_generator_identical():
    _same_graph(jgraphs.powerlaw(3000, 8, seed=15),
                tgraphs.powerlaw(3000, 8, seed=15))


@pytest.mark.parametrize("order", ["natural", "random", "nnz-sort",
                                   "amd-like", "rcm"])
def test_orderings_identical(order):
    g = tgraphs.road_like(10, seed=4)
    gj = jgraphs.road_like(10, seed=4)
    pt = tordering.ORDERINGS[order](g)
    pj = jordering.ORDERINGS[order](gj)
    assert np.array_equal(pt, pj)
    _same_graph(g.permute(pt).coalesce(), gj.permute(pj).coalesce())


def test_etree_heights_identical():
    from repro.core.ref_ac import ACFactor as JFactor
    g = tgraphs.grid2d(8, 9, seed=1)
    perm = tordering.nnz_sort_order(g)
    assert tetree.classical_etree_height(g, perm) == \
        jetree.classical_etree_height(jgraphs.grid2d(8, 9, seed=1), perm)
    # a small lower-triangular pattern: column k holds rows k+1, k+3
    n = 12
    rows = [[r for r in (k + 1, k + 3) if r < n] for k in range(n)]
    col_ptr = np.cumsum([0] + [len(r) for r in rows]).astype(np.int64)
    flat = np.array([r for rs in rows for r in rs], np.int32)
    vals = -np.ones(flat.size, np.float32)
    D = np.ones(n, np.float32)
    ft = ACFactor(n=n, col_ptr=col_ptr, rows=flat, vals=vals, D=D)
    fj = JFactor(n=n, col_ptr=col_ptr, rows=flat, vals=vals, D=D)
    assert tetree.actual_etree_height(ft) == jetree.actual_etree_height(fj)
    assert np.array_equal(tetree.wavefront_profile(ft),
                          jetree.wavefront_profile(fj))


def test_matvecs_agree():
    g = tgraphs.powerlaw(120, 4, seed=2)
    x = np.random.default_rng(0).normal(size=g.n)
    ref = laplacian_dense(g) @ x
    assert np.allclose(laplacian_matvec_np(g, x), ref)
    assert np.allclose(jmv(jgraphs.powerlaw(120, 4, seed=2), x), ref)
    y = laplacian_matvec(torch.from_numpy(g.src), torch.from_numpy(g.dst),
                         torch.from_numpy(g.w.astype(np.float64)), g.n,
                         torch.from_numpy(x))
    assert np.allclose(y.numpy(), ref)


def test_adjacency_rows_follow_scatter_order():
    # row i lists edges where i is src, then where i is dst, in edge order
    g = Graph(4, np.array([0, 1, 0, 2], np.int32),
              np.array([1, 2, 2, 3], np.int32),
              np.array([1.0, 2.0, 3.0, 4.0], np.float32))
    nbr, w = laplacian_adjacency(g, n_rows=8)
    assert nbr.shape == (8, 3)
    assert nbr[0].tolist() == [1, 2, 0] and w[0].tolist() == [1.0, 3.0, 0.0]
    assert nbr[2].tolist() == [3, 1, 0] and w[2].tolist() == [4.0, 2.0, 3.0]
    assert not w[4:].any()
