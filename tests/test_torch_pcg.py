"""Port parity of the library PCGs: ``laplacian_pcg`` /
``laplacian_pcg_batched`` against the reference's ``laplacian_pcg_jax`` /
``laplacian_pcg_jax_batched`` over ``make_preconditioner`` (equal
iteration counts, x within 1e-4), and inside the port: a batched column
takes its single solve's iterates bit for bit, stepped equals one-shot,
and every PCG of the port projects through one shared helper."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.core import ref_ac as jref                          # noqa: E402
from repro.core.laplacian import Graph as JGraph               # noqa: E402
from repro.core.ordering import ORDERINGS as JORD              # noqa: E402
from repro.core.parac import factorize_wavefront as jwave      # noqa: E402
from repro.core.pcg import (laplacian_pcg_jax,                 # noqa: E402
                            laplacian_pcg_jax_batched)
from repro.core.trisolve import make_preconditioner as jprec   # noqa: E402
from repro.data import graphs as jgraphs                       # noqa: E402
from repro_torch.core import pcg as tpcg                       # noqa: E402
from repro_torch.core import ref_ac as tref                    # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.core.ordering import ORDERINGS as TORD        # noqa: E402
from repro_torch.core.parac import factorize_wavefront as twave  # noqa
from repro_torch.core.solver import Solver                     # noqa: E402
from repro_torch.core.trisolve import make_preconditioner as tprec  # noqa
from repro_torch.data import graphs as tgraphs                 # noqa: E402

NAMES = ["grid2d_tiny", "road_tiny", "powerlaw_micro"]
SUITE = {**tgraphs.SUITE_MICRO, **tgraphs.SUITE_TINY}
KW = dict(tol=1e-6, maxiter=300)


def _relerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(a, axis=-1)


@pytest.fixture(scope="module")
def problems():
    """name -> (graph, port preconditioner, reference graph, reference
    preconditioner), both packages built on the same factor arrays."""
    out = {}
    for name in NAMES:
        g = SUITE[name]()
        ft = tref.factorize_sequential(g, key_from_seed(7))
        fj = jref.ACFactor(n=ft.n, col_ptr=ft.col_ptr, rows=ft.rows,
                           vals=ft.vals, D=ft.D)
        out[name] = (g, tprec(ft, device="cpu"),
                     JGraph(g.n, g.src, g.dst, g.w), jprec(fj))
    return out


def _rhs(n, k, seed=1):
    return np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_laplacian_pcg_matches_reference(problems, name):
    g, pt, gj, pj = problems[name]
    b = _rhs(g.n, 1)[0]
    rj = laplacian_pcg_jax(gj, pj, jnp.asarray(b), **KW)
    rt = tpcg.laplacian_pcg(g, pt, torch.from_numpy(b), **KW)
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.iters) == int(rj.iters)
    assert _relerr(rj.x, rt.x.numpy()) <= 1e-4


@pytest.mark.parametrize("name", NAMES)
def test_laplacian_pcg_batched_matches_reference(problems, name):
    """A batched column takes its single-rhs solve's iterates, in the port
    bit for bit.  Against the reference's batch: x within 1e-4 and
    iteration counts within one.  The reference's vmapped batch sums in
    another order than its single solve, so one of its lanes whose relres
    lands within float noise of tol can stop an iteration away from that
    solve (with these right-hand sides, one lane on road_tiny does)."""
    g, pt, gj, pj = problems[name]
    B = _rhs(g.n, 3, seed=2)
    rj = laplacian_pcg_jax_batched(gj, jax.vmap(pj), jnp.asarray(B), **KW)
    rt = tpcg.laplacian_pcg_batched(g, lambda R: pt(R.T).T,
                                    torch.from_numpy(B), **KW)
    assert rt.converged.all() and bool(np.all(np.asarray(rj.converged)))
    assert np.abs(rt.iters.numpy() - np.asarray(rj.iters)).max() <= 1
    assert _relerr(rj.x, rt.x.numpy()).max() <= 1e-4
    for c in range(3):
        one = tpcg.laplacian_pcg(g, pt, torch.from_numpy(B[c]), **KW)
        assert int(one.iters) == int(rt.iters[c])
        assert torch.equal(one.x, rt.x[c])


def test_stepped_equals_one_shot(problems):
    g, pt, _, _ = problems["road_tiny"]
    B = torch.from_numpy(_rhs(g.n, 3, seed=3))
    mv = tpcg._laplacian_operator(g, B)
    pre = lambda R: pt(R.T).T                                  # noqa: E731
    one = tpcg.pcg_batched(mv, pre, B, **KW)
    s = tpcg.pcg_batched_init(mv, pre, B, tol=KW["tol"])
    while bool(s.active.any()):
        s = tpcg.pcg_batched_step(mv, pre, s, k=4, **KW)
    res = tpcg.pcg_batched_result(s, KW["tol"])
    assert torch.equal(res.x, one.x) and torch.equal(res.iters, one.iters)
    assert torch.equal(res.relres, one.relres)


def test_every_pcg_projects_the_residual_through_one_helper(problems,
                                                             monkeypatch):
    """The fleet, single and batched PCGs all project the rhs, the
    residual every iteration and Z through ``project_lanes``: 2 calls at
    init and 2 per iteration."""
    calls = []
    real = tpcg.project_lanes

    def counted(Y, nvalid):
        calls.append(Y.shape[0])
        return real(Y, nvalid)

    monkeypatch.setattr(tpcg, "project_lanes", counted)
    g, pt, _, _ = problems["grid2d_tiny"]
    B = _rhs(g.n, 2, seed=4)
    r1 = tpcg.laplacian_pcg(g, pt, torch.from_numpy(B[0]), **KW)
    assert len(calls) == 2 + 2 * int(r1.iters)
    calls.clear()
    rb = tpcg.laplacian_pcg_batched(g, lambda R: pt(R.T).T,
                                    torch.from_numpy(B), **KW)
    assert len(calls) == 2 + 2 * int(rb.iters.max())
    calls.clear()
    solver = Solver(chunk=32, device="cpu")
    solver.factor(g, key_from_seed(7))
    rf = solver.solve(torch.from_numpy(B), **KW)
    assert len(calls) == 2 + 2 * int(rf.iters.max())


def test_quickstart_flow_in_both_packages():
    """``examples/quickstart.py``'s flow (nnz-sort, wavefront factor,
    make_preconditioner, Laplacian PCG) at grid3d 8^3 contrast: same
    factor, same iteration count, x within 1e-4."""
    gj = jgraphs.grid3d(8, 8, 8, kind="contrast", seed=0)
    permj = JORD["nnz-sort"](gj, seed=0)
    gpj = gj.permute(permj).coalesce()
    fj = jwave(gpj, jax.random.key(0), chunk=256)
    gt = tgraphs.grid3d(8, 8, 8, kind="contrast", seed=0)
    permt = TORD["nnz-sort"](gt, seed=0)
    assert np.array_equal(permj, permt)
    gpt = gt.permute(permt).coalesce()
    ft = twave(gpt, key_from_seed(0), chunk=256, device="cpu")
    assert np.array_equal(fj.vals.view(np.uint32), ft.vals.view(np.uint32))
    b = np.random.default_rng(0).normal(size=gt.n)
    b -= b.mean()
    bp = b[np.argsort(permt)].astype(np.float32)
    rj = jax.jit(lambda bb: laplacian_pcg_jax(
        gpj, jprec(fj), bb, tol=1e-6, maxiter=500))(jnp.asarray(bp))
    rt = tpcg.laplacian_pcg(gpt, tprec(ft), torch.from_numpy(bp), tol=1e-6,
                            maxiter=500)
    assert bool(rj.converged) and bool(rt.converged)
    assert int(rt.iters) == int(rj.iters)
    assert _relerr(rj.x, rt.x.numpy()) <= 1e-4
