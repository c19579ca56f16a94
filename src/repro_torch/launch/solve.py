"""Laplacian-solver launcher — the paper's pipeline as a CLI, on the GPU
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.solve --graph grid2d_64 \\
        [--nrhs N] [--batch N] [--device cpu]

Prints the same ``graph=``, ``factor:`` and ``solve:`` fields as the
reference launcher.  ``--batch N`` factorizes N seeded replicas of the
graph in one batched engine run instead of solving.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="grid2d_64")
    ap.add_argument("--ordering", default="nnz-sort")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--batch", type=int, default=0,
                    help="factorize N seeded replicas in one batched run")
    ap.add_argument("--nrhs", type=int, default=1,
                    help="solve N right-hand sides in one batched PCG")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to ask "
                         "for the plain path)")
    args = ap.parse_args(argv)

    from repro_torch.data import graphs
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.parac import factorize_batched
    from repro_torch.core.solver import Solver
    from repro_torch.core.ordering import ORDERINGS
    from repro_torch.core import etree
    from repro_torch.kernels.runtime import resolve_device

    device = resolve_device(args.device)
    g = graphs.SUITE[args.graph]() if args.graph in graphs.SUITE \
        else graphs.SUITE_LARGE[args.graph]()
    perm = ORDERINGS[args.ordering](g, seed=0) \
        if args.ordering in ("random", "nnz-sort") \
        else ORDERINGS[args.ordering](g)
    gp = g.permute(perm).coalesce()
    print(f"graph={args.graph} n={g.n} m={g.m} ordering={args.ordering} "
          f"device={device}")

    if args.batch:
        t0 = time.time()
        factorize_batched([gp] * args.batch,
                          [key_from_seed(i) for i in range(args.batch)],
                          chunk=args.chunk, strict=False, device=device)
        _sync(device)
        dt = time.time() - t0
        print(f"batched construction: {args.batch} factors in {dt:.2f}s "
              f"({dt / args.batch:.3f}s each)")
        return

    solver = Solver(chunk=args.chunk, device=device)
    t0 = time.time()
    handle = solver.factor(gp, key_from_seed(0))
    _sync(device)
    f = handle.factor
    print(f"factor: {time.time()-t0:.2f}s nnz={f.nnz} "
          f"fill={f.fill_ratio(g):.2f} rounds={f.stats['rounds']} "
          f"height={etree.actual_etree_height(f)} "
          f"levels={handle.n_levels}")

    rng = np.random.default_rng(0)
    iperm = np.argsort(perm)
    if args.nrhs > 1:
        B = rng.normal(size=(args.nrhs, g.n))
        B -= B.mean(axis=1, keepdims=True)
        Bp = torch.tensor(B[:, iperm], dtype=torch.float32, device=device)
        t0 = time.time()
        res = solver.solve(Bp, tol=args.tol, maxiter=args.maxiter)
        _sync(device)
        it = res.iters.cpu().numpy()
        rr = res.relres.cpu().numpy()
        print(f"batched solve: {time.time()-t0:.2f}s nrhs={args.nrhs} "
              f"iters={it.min()}..{it.max()} max_relres={rr.max():.2e} "
              f"converged={bool(res.converged.all())}")
        return

    b = rng.normal(size=g.n)
    b -= b.mean()
    bp = torch.tensor(b[iperm], dtype=torch.float32, device=device)
    t0 = time.time()
    res = solver.solve(bp, tol=args.tol, maxiter=args.maxiter)
    _sync(device)
    print(f"solve: {time.time()-t0:.2f}s iters={int(res.iters)} "
          f"relres={float(res.relres):.2e} converged={bool(res.converged)}")


if __name__ == "__main__":
    main()
