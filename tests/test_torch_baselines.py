"""The port's host baselines on the CPU: incomplete Cholesky (IC(0) and
icholt), the smoothed-aggregation V-cycle and the SDD reduction as the
reference's ``tests/test_baselines_and_dist.py`` checks them, and the
port's copies of ``grounded_laplacian_coo``, ``sdd_to_grounded_laplacian``,
``ichol``, ``ichol_device_factor`` and ``make_solver`` against the
reference's on the same inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax.numpy as jnp                                        # noqa: E402

from repro.core import ichol as jichol                         # noqa: E402
from repro.core import laplacian as jlap                       # noqa: E402
from repro.core import ref_ac as jref                          # noqa: E402
from repro.core import trisolve as jtri                        # noqa: E402
from repro.data import graphs as jgraphs                       # noqa: E402
from repro_torch.core import trisolve as ttri                  # noqa: E402
from repro_torch.core.amg import (                             # noqa: E402
    smoothed_aggregation_preconditioner)
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.core.ichol import (                           # noqa: E402
    ichol, ichol_device_factor, jacobi_preconditioner)
from repro_torch.core.laplacian import (                       # noqa: E402
    grounded_laplacian_coo, laplacian_dense, sdd_to_grounded_laplacian)
from repro_torch.core.parac import factorize_wavefront         # noqa: E402
from repro_torch.core.pcg import laplacian_pcg_np              # noqa: E402
from repro_torch.data import graphs                            # noqa: E402


@pytest.fixture(scope="module")
def g():
    return graphs.grid2d(14, 14, seed=5)


def _rhs(n, seed=0):
    b = np.random.default_rng(seed).normal(size=n)
    return b - b.mean()


# ---------------------------------------------------------------------------
# The reference's baseline checks, on the port
# ---------------------------------------------------------------------------

def test_ichol0_preconditions(g):
    ic = ichol(g, droptol=0.0)
    b = _rhs(g.n)
    res = laplacian_pcg_np(g, ic.apply, b, tol=1e-7, maxiter=600)
    plain = laplacian_pcg_np(g, lambda r: r, b, tol=1e-7, maxiter=2000)
    assert res.converged and res.iters < plain.iters


def test_icholt_quality_better_than_ic0(g):
    ic0 = ichol(g, droptol=0.0)
    ict = ichol(g, droptol=0.02)
    b = _rhs(g.n)
    r0 = laplacian_pcg_np(g, ic0.apply, b, tol=1e-7, maxiter=600)
    rt = laplacian_pcg_np(g, ict.apply, b, tol=1e-7, maxiter=600)
    assert rt.iters <= r0.iters
    assert ict.nnz >= ic0.nnz


def test_amg_vcycle_preconditions(g):
    amg = smoothed_aggregation_preconditioner(g)
    b = _rhs(g.n)
    res = laplacian_pcg_np(g, amg, b, tol=1e-7, maxiter=200)
    assert res.converged and res.iters < 40


def test_jacobi_preconditions(g):
    b = _rhs(g.n)
    res = laplacian_pcg_np(g, jacobi_preconditioner(g), b, tol=1e-7,
                           maxiter=2000)
    assert res.converged


def test_sdd_reduction_solves_sdd_system():
    """Solve A x = b with A = L + diag(surplus) via the grounded graph."""
    g0 = graphs.grid2d(8, 8, seed=2)
    rng = np.random.default_rng(0)
    surplus = rng.uniform(0.0, 0.5, g0.n)
    surplus[rng.random(g0.n) < 0.7] = 0.0
    surplus[0] = 1.0                      # ensure nonsingular
    A = laplacian_dense(g0) + np.diag(surplus)
    gg = sdd_to_grounded_laplacian(np.diag(A), g0)
    assert gg.n == g0.n + 1
    b = rng.normal(size=g0.n)
    bg = np.concatenate([b, [-b.sum()]])  # grounded rhs (mean-zero)
    f = factorize_wavefront(gg, key_from_seed(0), fill_slack=64,
                            device="cpu")
    res = laplacian_pcg_np(gg, lambda r: ttri.precond_apply_np(f, r), bg,
                           tol=1e-9, maxiter=400)
    xg = np.asarray(res.x)
    x = xg[:-1] - xg[-1]                  # ground node potential = 0
    np.testing.assert_allclose(A @ x, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="diagonally dominant"):
        sdd_to_grounded_laplacian(np.diag(A) - 2.0, g0)


# ---------------------------------------------------------------------------
# The port's copies against the reference's, on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [0.0, 1e-3])
@pytest.mark.parametrize("name", ["grid2d_micro", "powerlaw_micro"])
def test_grounded_laplacian_coo_matches_reference(name, shift):
    got = grounded_laplacian_coo(graphs.SUITE_MICRO[name](), shift)
    want = jlap.grounded_laplacian_coo(jgraphs.SUITE_MICRO[name](), shift)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_sdd_to_grounded_laplacian_matches_reference():
    g0, j0 = graphs.grid2d(8, 8, seed=2), jgraphs.grid2d(8, 8, seed=2)
    diag = laplacian_dense(g0).diagonal() + np.where(
        np.arange(g0.n) % 3 == 0, 0.25, 0.0)
    got = sdd_to_grounded_laplacian(diag, g0)
    want = jlap.sdd_to_grounded_laplacian(diag, j0)
    assert got.n == want.n
    for f in ("src", "dst", "w"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("droptol", [0.0, 0.02])
def test_ichol_factor_matches_reference(g, droptol):
    """The host factorization is the reference's code: the same CSC
    factor and shift bit for bit, and its device ``(G, D)`` form too."""
    jg = jgraphs.grid2d(14, 14, seed=5)
    got, want = ichol(g, droptol=droptol), jichol.ichol(jg, droptol=droptol)
    assert got.shift == want.shift
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got.L, f), getattr(want.L, f))
    dev = ichol_device_factor(g, droptol=droptol)
    ref = jichol.ichol_device_factor(jg, droptol=droptol)
    for f in ("col_ptr", "rows", "vals", "D"):
        a, b = getattr(dev, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("flip", [False, True], ids=["fwd", "bwd"])
def test_make_solver_matches_reference(flip):
    """``make_solver`` (one scatter-add per level of a host schedule) on
    the CPU against the reference's ``make_jax_solver`` on the same
    schedule and rhs: float32 scatter-adds whose order may differ, so
    within 1e-5 of the largest entry; both within 1e-5 of the float64
    host solve."""
    g0 = graphs.SUITE_MICRO["powerlaw_micro"]()
    f = factorize_wavefront(g0, key_from_seed(3), fill_slack=64,
                            device="cpu")
    jf = jref.ACFactor(n=f.n, col_ptr=f.col_ptr, rows=f.rows, vals=f.vals,
                       D=f.D)
    fwd, bwd = ttri.build_schedules(f)
    jfwd, jbwd = jtri.build_schedules(jf)
    sched, jsched = (bwd, jbwd) if flip else (fwd, jfwd)
    b = np.random.default_rng(4).normal(size=f.n).astype(np.float32)
    got = ttri.make_solver(sched, flip=flip, device="cpu")(
        torch.from_numpy(b)).numpy()
    want = np.asarray(jtri.make_jax_solver(jsched, flip=flip)(
        jnp.asarray(b)))
    exact = ttri.solve_levels_np(sched, b, flip=flip)
    scale = float(np.abs(exact).max())
    assert got.dtype == np.float32 and got.shape == (f.n,)
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - exact).max() <= 1e-5 * scale
    assert np.isfinite(got).all()
