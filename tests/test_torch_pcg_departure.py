"""The port's one deliberate departure from the reference's PCG, witnessed
on the CPU: the reference keeps the rhs and Z mean-zero but not the
residual R, and in float32 R picks up a mean component that CG cannot
reduce and the singular preconditioner amplifies.  On a 9^3 high-contrast
grid at tol 1e-7 the reference's library PCG stalls above tol for all of
its 500 iterations; the port, which projects R every iteration
(``pcg.project_lanes``), converges in a few dozen on the same factor."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.core import ref_ac as jref                          # noqa: E402
from repro.core.laplacian import Graph as JGraph               # noqa: E402
from repro.core.pcg import laplacian_pcg_jax                   # noqa: E402
from repro.core.trisolve import make_preconditioner as jprec   # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.core.laplacian import laplacian_matvec_np     # noqa: E402
from repro_torch.core.ordering import ORDERINGS                # noqa: E402
from repro_torch.core.parac import factorize_wavefront         # noqa: E402
from repro_torch.core.pcg import laplacian_pcg                 # noqa: E402
from repro_torch.core.trisolve import make_preconditioner      # noqa: E402
from repro_torch.data import graphs                            # noqa: E402

TOL, MAXITER = 1e-7, 500


def test_reference_pcg_stalls_where_the_port_converges():
    g = graphs.grid3d(9, 9, 9, "contrast", seed=4)
    gp = g.permute(ORDERINGS["nnz-sort"](g, seed=0)).coalesce()
    ft = factorize_wavefront(gp, key_from_seed(0), chunk=256, device="cpu")
    fj = jref.ACFactor(n=ft.n, col_ptr=ft.col_ptr, rows=ft.rows,
                       vals=ft.vals, D=ft.D)
    gj = JGraph(gp.n, gp.src, gp.dst, gp.w)
    b = np.random.default_rng(0).normal(size=gp.n).astype(np.float32)

    pj = jprec(fj)
    rj = jax.jit(lambda bb: laplacian_pcg_jax(
        gj, pj, bb, tol=TOL, maxiter=MAXITER))(jnp.asarray(b))
    assert not bool(rj.converged)
    assert int(rj.iters) == MAXITER and float(rj.relres) > 2 * TOL

    rt = laplacian_pcg(gp, make_preconditioner(ft, device="cpu"),
                       torch.from_numpy(b), tol=TOL, maxiter=MAXITER)
    assert bool(rt.converged) and int(rt.iters) < 50
    # the converged iterate solves the system: its float64 true residual
    # is below 1e-4, the bound chip_smoke.py holds every lane to (float32
    # x on a high-contrast grid does not reach the recursive residual)
    x = rt.x.numpy().astype(np.float64)
    bb = b.astype(np.float64) - b.mean()
    assert np.linalg.norm(laplacian_matvec_np(gp, x) - bb) \
        / np.linalg.norm(bb) < 1e-4
