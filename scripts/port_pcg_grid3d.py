"""Run the PyTorch port's AC factor → fleet PCG on a uniform 3D grid: the
port-side counterpart of ``scripts/reference_pcg_stall.py``, on the same
graph, factor settings, key and right-hand side.

    PYTHONPATH=src python scripts/port_pcg_grid3d.py [--side 24] \
        [--tol 1e-6] [--maxiter 500] [--device cpu]

The port keeps the residual R mean-zero every iteration, which the
reference does not; the script prints the iteration count, the relative
residual and whether the solve converged, for comparison with the
reference's run.
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()

    import torch
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.ordering import ORDERINGS
    from repro_torch.core.solver import Solver
    from repro_torch.data import graphs

    s = args.side
    g = graphs.grid3d(s, s, s, "uniform", seed=2)
    g = g.permute(ORDERINGS["nnz-sort"](g, seed=0)).coalesce()
    solver = Solver(chunk=256, fill_slack=32, strict=True, device=args.device)
    t0 = time.time()
    h = solver.factor(g, key_from_seed(0))
    f = h.factor
    print(f"grid3d {s}^3 n={g.n} m={g.m}: factor {time.time() - t0:.1f}s "
          f"rounds={f.stats['rounds']} fill_slack={f.stats['fill_slack']} "
          f"overflow={f.stats['overflow']} nnz={f.nnz}", flush=True)
    b = np.random.default_rng(0).normal(size=g.n).astype(np.float32)
    t0 = time.time()
    res = solver.solve(torch.from_numpy(b), tol=args.tol,
                       maxiter=args.maxiter)
    print(f"solve {time.time() - t0:.1f}s tol={args.tol:g} "
          f"maxiter={args.maxiter}: iters={int(res.iters)} "
          f"relres={float(res.relres):.3e} "
          f"converged={bool(res.converged)}", flush=True)


if __name__ == "__main__":
    main()
