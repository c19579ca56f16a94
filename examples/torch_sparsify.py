"""Incremental spectral sparsification on the PyTorch/CUDA port — the flow
of ``examples/sparsify.py`` on ``repro_torch``, on the GPU unless
``--device cpu`` asks for the plain path.

Each round: construct the randomized factor of the current graph (no
symbolic pre-processing), estimate effective resistances from the factor
via Johnson-Lindenstrauss sketching of G⁻¹ edge indicators (the ``Q``
sketch solves run as one batched PCG; a column of it takes the iterates
of its own single solve), and resample edges proportional to leverage
scores.

    PYTHONPATH=src python examples/torch_sparsify.py [--n 512] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.column_math import key_from_seed
from repro_torch.core.laplacian import Graph
from repro_torch.core.ordering import ORDERINGS
from repro_torch.core.parac import factorize_wavefront
from repro_torch.core.pcg import laplacian_pcg_batched
from repro_torch.core.trisolve import make_preconditioner
from repro_torch.data import graphs
from repro_torch.kernels.runtime import resolve_device


def main(n: int = 512, degree: int = 8, rounds: int = 3, Q: int = 12,
         device=None) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    g = graphs.random_regular(n, degree, seed=2)
    print(f"start: n={g.n} m={g.m}")
    converged, iters, ms = True, [], [g.m]
    for rnd in range(rounds):
        perm = ORDERINGS["nnz-sort"](g, seed=rnd)
        gp = g.permute(perm).coalesce()
        iperm = np.argsort(perm)
        f = factorize_wavefront(gp, key_from_seed(rnd), chunk=256,
                                strict=False, device=device)
        precond = make_preconditioner(f)
        # effective resistance sketch: R_e ≈ ||Z (e_u - e_v)||²,
        # Z = Q^{-1/2} L⁺ B W^{1/2}
        bs = []
        for _ in range(Q):
            s = rng.choice([-1.0, 1.0], g.m) * np.sqrt(g.w)
            b = np.zeros(g.n)
            np.add.at(b, g.src, s)
            np.add.at(b, g.dst, -s)
            b -= b.mean()
            bs.append(b[iperm])
        res = laplacian_pcg_batched(
            gp, lambda R: precond(R.T).T,
            torch.as_tensor(np.stack(bs), dtype=torch.float32, device=device),
            tol=1e-4, maxiter=200)
        converged &= bool(res.converged.all())
        iters.append(int(res.iters.max()))
        Z = res.x.cpu().numpy()[:, perm] / np.sqrt(Q)
        reff = np.sum((Z[:, g.src] - Z[:, g.dst]) ** 2, axis=0)
        lev = np.clip(g.w * reff, 1e-6, 1.0)    # leverage ≈ w·R_eff
        keep_p = np.clip(lev * 4.0, 0.05, 1.0)
        keep = rng.random(g.m) < keep_p
        g = Graph(g.n, g.src[keep], g.dst[keep],
                  (g.w[keep] / keep_p[keep]).astype(np.float32)).coalesce()
        ms.append(g.m)
        print(f"round {rnd}: kept {keep.sum()}/{keep.size} edges -> m={g.m} "
              f"(sketch solves: {iters[-1]} iterations)")
    print("done: final sparsifier", g.m, "edges")
    assert converged
    return dict(converged=converged, iters=iters, m=ms)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the "
                         "plain path)")
    a = ap.parse_args()
    main(a.n, rounds=a.rounds, device=a.device)
