"""Spectral graph embedding via ParAC-preconditioned inverse power
iteration on the PyTorch/CUDA port — the flow of
``examples/spectral_embedding.py`` on ``repro_torch``, on the GPU unless
``--device cpu`` asks for the plain path.

Computes the first k nontrivial Laplacian eigenvectors by orthogonal
inverse iteration, where each step solves L X = V for the k columns at
once (one batched PCG with the randomized Cholesky preconditioner; a
column takes the iterates of its own single solve), then bi-partitions
the graph by the Fiedler vector's sign.

    PYTHONPATH=src python examples/torch_spectral_embedding.py [--side 24] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.column_math import key_from_seed
from repro_torch.core.laplacian import laplacian_matvec_np
from repro_torch.core.ordering import ORDERINGS
from repro_torch.core.parac import factorize_wavefront
from repro_torch.core.pcg import laplacian_pcg_batched
from repro_torch.core.trisolve import make_preconditioner
from repro_torch.data import graphs
from repro_torch.kernels.runtime import resolve_device


def main(side: int = 24, k: int = 4, steps: int = 12, device=None) -> dict:
    device = resolve_device(device)
    g = graphs.road_like(side, seed=3)     # two-ish communities road grid
    perm = ORDERINGS["nnz-sort"](g, seed=0)
    gp = g.permute(perm).coalesce()
    f = factorize_wavefront(gp, key_from_seed(0), chunk=256, device=device)
    precond = make_preconditioner(f)

    rng = np.random.default_rng(0)
    V = rng.normal(size=(g.n, k)).astype(np.float32)
    iperm = np.argsort(perm)
    converged, iters = True, []
    for _ in range(steps):
        # inverse power step: V <- L⁺ V (every column), then orthonormalize
        B = (V - V.mean(axis=0)).T[:, iperm]
        res = laplacian_pcg_batched(
            gp, lambda R: precond(R.T).T,
            torch.as_tensor(B, dtype=torch.float32, device=device),
            tol=1e-7, maxiter=400)
        converged &= bool(res.converged.all())
        iters.append(int(res.iters.max()))
        X = res.x.cpu().numpy()[:, perm].T
        V, _ = np.linalg.qr(X - X.mean(axis=0))

    # Rayleigh quotients ≈ smallest nontrivial eigenvalues
    lams = np.array([float(V[:, j] @ laplacian_matvec_np(
        g, V[:, j].astype(np.float64))) for j in range(k)])
    order = np.argsort(lams)
    lams = lams[order]
    fiedler = V[:, order[0]]
    cut = fiedler >= 0
    cut_edges = int(np.sum(cut[g.src] != cut[g.dst]))
    print(f"approx eigenvalues: {np.round(lams, 5)}")
    print(f"Fiedler bipartition: {cut.sum()} vs {(~cut).sum()} vertices, "
          f"{cut_edges}/{g.m} edges cut ({100 * cut_edges / g.m:.1f}%)")
    assert converged and cut_edges / g.m < 0.5
    return dict(converged=converged, iters=iters, eigenvalues=lams,
                cut_fraction=cut_edges / g.m)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the "
                         "plain path)")
    a = ap.parse_args()
    main(a.side, device=a.device)
