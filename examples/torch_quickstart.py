"""Quickstart on the PyTorch/CUDA port: build a Laplacian, construct the
ParAC preconditioner in parallel, and solve with PCG — the flow of
``examples/quickstart.py`` on ``repro_torch``, on the GPU unless
``--device cpu`` asks for the plain path.

    PYTHONPATH=src python examples/torch_quickstart.py [--side 12] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import etree
from repro_torch.core.column_math import key_from_seed
from repro_torch.core.ordering import ORDERINGS
from repro_torch.core.parac import factorize_wavefront
from repro_torch.core.pcg import laplacian_pcg
from repro_torch.core.trisolve import make_preconditioner
from repro_torch.data import graphs
from repro_torch.kernels.runtime import resolve_device


def main(side: int = 12, device=None) -> dict:
    device = resolve_device(device)
    # a high-contrast 3D Poisson problem (paper Table 1 family)
    g = graphs.grid3d(side, side, side, kind="contrast", seed=0)
    print(f"graph: {g.n} vertices, {g.m} edges")

    # nnz-sort elimination ordering (the paper's best GPU ordering)
    perm = ORDERINGS["nnz-sort"](g, seed=0)
    gp = g.permute(perm).coalesce()

    # parallel randomized Cholesky (bulk-synchronous wavefronts)
    f = factorize_wavefront(gp, key_from_seed(0), chunk=256, device=device)
    print(f"factor: nnz={f.nnz}, fill_ratio={f.fill_ratio(g):.2f}, "
          f"wavefront rounds={f.stats['rounds']}, "
          f"actual e-tree height={etree.actual_etree_height(f)} "
          f"(vs classical {etree.classical_etree_height(g, perm)})")

    # PCG with the G D Gᵀ preconditioner
    rng = np.random.default_rng(0)
    b = rng.normal(size=g.n)
    b -= b.mean()
    bp = torch.as_tensor(b[np.argsort(perm)], dtype=torch.float32,
                         device=device)
    res = laplacian_pcg(gp, make_preconditioner(f), bp, tol=1e-6,
                        maxiter=500)
    print(f"PCG: {int(res.iters)} iterations, relres={float(res.relres):.2e}")
    assert bool(res.converged)
    return dict(iters=int(res.iters), relres=float(res.relres),
                converged=bool(res.converged), nnz=f.nnz)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the "
                         "plain path)")
    a = ap.parse_args()
    main(a.side, a.device)
