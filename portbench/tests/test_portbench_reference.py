"""The plain reference against the program on the CPU at small sizes:
the factor bit for bit (and the sequential oracle), the preconditioner
apply, the PCG's iterations; and the benchmark's frozen graphs against
the program's generators."""
import numpy as np
import pytest
import torch

from portbench_small import CPU
from portbench import graphs
from portbench import reference as ref

GRAPHS = [("uniform", 6, 2), ("contrast", 7, 13), ("aniso", 5, 3)]
KEY = np.array([2 ** 31 + 5, 987_654_321], np.uint32)


def _graph(kind, side, seed):
    return graphs.build(dict(generator="grid3d", side=side, kind=kind,
                             seed=seed, ordering="nnz-sort",
                             ordering_seed=0))


def test_frozen_graphs_are_the_programs():
    from repro_torch.core.ordering import nnz_sort_order
    from repro_torch.data import graphs as pg
    for kind, side, seed in GRAPHS:
        g = pg.grid3d(side, side, side, kind, seed=seed)
        want = g.permute(nnz_sort_order(g, seed=0)).coalesce()
        got = _graph(kind, side, seed)
        assert got.n == want.n
        for a in ("src", "dst", "w"):
            assert np.array_equal(getattr(got, a), getattr(want, a))


@pytest.mark.parametrize("kind,side,seed", GRAPHS)
def test_reference_factor_is_the_programs_and_the_oracles(kind, side, seed):
    from repro_torch.core.laplacian import Graph
    from repro_torch.core.parac import factorize_wavefront
    g = _graph(kind, side, seed)
    want = ref.factor(g.n, g.src, g.dst, g.w, KEY)
    got = factorize_wavefront(Graph(g.n, g.src, g.dst, g.w), KEY, chunk=256,
                              fill_slack=32, strict=True, device="cpu")
    assert ref.factor_mismatch(got, want) == 0
    seq = ref.factor_sequential(g.n, g.src, g.dst, g.w, KEY)
    assert ref.factor_mismatch(seq, want) == 0
    # blocks of rows give the same factor
    assert ref.factor_mismatch(ref.factor(g.n, g.src, g.dst, g.w, KEY,
                                          block_elems=16), want) == 0


def test_factor_mismatch_counts_differing_entries():
    g = _graph("uniform", 5, 2)
    f = ref.factor(g.n, g.src, g.dst, g.w, KEY)
    vals = f.vals.copy()
    vals[[0, 3]] = np.nextafter(vals[[0, 3]], np.float32(1))
    assert ref.factor_mismatch(f._replace(vals=vals), f) == 2
    assert ref.factor_mismatch(f._replace(rows=f.rows[:-1]), f) == f.rows.size


def test_reference_apply_and_pcg_against_the_program():
    from repro_torch.core.laplacian import Graph
    from repro_torch.core.solver import Solver
    g = _graph("contrast", 8, 13)
    s = Solver(chunk=256, fill_slack=32, strict=True, device="cpu")
    h = s.factor(Graph(g.n, g.src, g.dst, g.w), KEY)
    f = ref.factor(g.n, g.src, g.dst, g.w, KEY)
    gen = torch.Generator().manual_seed(3)
    R = torch.randn((g.n, 8), generator=gen)
    apply = ref.Apply(f, device=CPU)
    assert ref.apply_error(h.precondition(R), apply(R)) < 1e-5
    B = torch.randn((8, g.n), generator=gen)
    res = h.solve(B, tol=1e-6, maxiter=500)
    lap = ref.Laplacian(g.n, g.src, g.dst, g.w)
    o = ref.pcg(lap, apply, B.T.double(), 1e-6, 500)
    assert np.abs(res.iters.numpy() - o.iters).max() <= 1
    assert float(ref.true_relres(lap, o.x, B.T).max()) < 1e-6


def test_lower_precision_reference_departs():
    g = _graph("contrast", 7, 13)
    f32 = ref.factor(g.n, g.src, g.dst, g.w, KEY)
    bf = ref.factor(g.n, g.src, g.dst, g.w, KEY, dtype=torch.bfloat16)
    assert ref.factor_mismatch(bf, f32) > f32.rows.size // 2
    R = torch.randn((g.n, 2), generator=torch.Generator().manual_seed(0))
    err = ref.apply_error(ref.Apply(bf, dtype=torch.bfloat16)(R),
                          ref.Apply(f32)(R))
    assert not err <= 1e-3         # far off, or not a number
