"""Run the JAX reference's AC factor → fleet PCG on a uniform 3D grid and
report whether its float32 solve reaches the tolerance.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_pcg_stall.py \
        [--side 24] [--tol 1e-6] [--maxiter 500]

The graph, ordering, factor settings, key and right-hand side are those of
the PyTorch port's main-path smoke (``chip_smoke.py``): ``grid3d(side,
side, side, "uniform", seed=2)``, nnz-sort ordering, chunk 256,
fill_slack 32, strict retry, key 0, ``b = default_rng(0).normal(n)`` in
float32.  The reference keeps B and Z mean-zero but not the residual R,
whose float32 drift out of range(L) can stall PCG above the tolerance:
the script prints the iteration count, the relative residual and whether
the solve converged.

On the CPU the Pallas fleet SpMV runs in interpret mode, about 90 s per
triangular solve at 24^3.  The script therefore runs the solve with the
kernel's plain reference, ``kernels/ref.py::ell_spmv_ref`` under ``vmap``
(the kernel body's own expression), after checking that it equals the
interpret-mode kernel bit for bit on the factor's forward and backward
panels.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=24)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=500)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from repro.core.ordering import ORDERINGS
    from repro.core.solver import Solver
    from repro.data import graphs
    from repro.kernels import ops
    from repro.kernels.ref import ell_spmv_ref
    from repro.kernels.spmv import ell_spmv_fleet_pallas

    s = args.side
    g = graphs.grid3d(s, s, s, "uniform", seed=2)
    g = g.permute(ORDERINGS["nnz-sort"](g, seed=0)).coalesce()
    solver = Solver(chunk=256, fill_slack=32, strict=True)
    t0 = time.time()
    h = solver.factor(g, jax.random.key(0))
    f = h.factor
    print(f"grid3d {s}^3 n={g.n} m={g.m}: factor {time.time() - t0:.1f}s "
          f"rounds={f.stats['rounds']} fill_slack={f.stats['fill_slack']} "
          f"overflow={f.stats['overflow']} nnz={f.nnz}", flush=True)

    plain = jax.jit(jax.vmap(ell_spmv_ref))
    fa = h.fleet.arrays
    x = jnp.asarray(np.random.default_rng(1).normal(size=(1, h.n_pad)),
                    jnp.float32)
    for cols, vals in ((fa.fcols, fa.fvals), (fa.bcols, fa.bvals)):
        c, v = cols[h.fleet_row][None], vals[h.fleet_row][None]
        want = ell_spmv_fleet_pallas(c, v, x, interpret=True)
        got = plain(c, v, x)
        if not bool(jnp.all(want.view(jnp.int32) == got.view(jnp.int32))):
            raise SystemExit("kernels/ref.py::ell_spmv_ref differs from the "
                             "interpret-mode Pallas kernel on this factor")
    print(f"plain SpMV == Pallas interpret bit for bit on the panels "
          f"(K fwd={fa.fcols.shape[2]} bwd={fa.bcols.shape[2]})", flush=True)
    ops.ell_spmv_fleet = lambda cols, vals, x, interpret=None: plain(
        cols, vals, x)

    b = np.random.default_rng(0).normal(size=g.n).astype(np.float32)
    t0 = time.time()
    res = solver.solve(jnp.asarray(b), tol=args.tol, maxiter=args.maxiter)
    jax.block_until_ready(res.x)
    print(f"solve {time.time() - t0:.1f}s tol={args.tol:g} "
          f"maxiter={args.maxiter}: iters={int(res.iters)} "
          f"relres={float(res.relres):.3e} "
          f"converged={bool(res.converged)}", flush=True)


if __name__ == "__main__":
    main()
