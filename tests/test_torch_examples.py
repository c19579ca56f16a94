"""The port's examples (``examples/torch_*.py``) run on the CPU at small
sizes against the reference flows (``examples/quickstart.py``,
``sparsify.py`` and ``spectral_embedding.py``'s steps in the JAX package
on the same inputs): every solve converges, the quickstart takes the
reference's iteration count, sparsification keeps the reference's edge
count each round and the spectral embedding its eigenvalues."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.core.laplacian import Graph as JGraph               # noqa: E402
from repro.core.laplacian import laplacian_matvec_np as jlap_np  # noqa
from repro.core.ordering import ORDERINGS as JORD              # noqa: E402
from repro.core.parac import factorize_wavefront as jwave      # noqa: E402
from repro.core.pcg import laplacian_pcg_jax                   # noqa: E402
from repro.core.trisolve import make_preconditioner as jprec   # noqa: E402
from repro.data import graphs as jgraphs                       # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_matches_reference_iterations():
    side = 6
    out = _example("torch_quickstart").main(side, device="cpu")
    g = jgraphs.grid3d(side, side, side, kind="contrast", seed=0)
    perm = JORD["nnz-sort"](g, seed=0)
    gp = g.permute(perm).coalesce()
    f = jwave(gp, jax.random.key(0), chunk=256)
    b = np.random.default_rng(0).normal(size=g.n)
    b -= b.mean()
    bp = jnp.asarray(b[np.argsort(perm)], dtype=jnp.float32)
    ref = jax.jit(lambda bb: laplacian_pcg_jax(
        gp, jprec(f), bb, tol=1e-6, maxiter=500))(bp)
    assert out["converged"] and bool(ref.converged)
    assert out["iters"] == int(ref.iters)
    assert out["nnz"] == f.nnz


def _ref_sparsify(n, rounds, Q, degree=8):
    """``examples/sparsify.py``'s flow in the JAX package at a given size:
    the edge count after each round."""
    rng = np.random.default_rng(0)
    g = jgraphs.random_regular(n, degree, seed=2)
    ms = [g.m]
    for rnd in range(rounds):
        perm = JORD["nnz-sort"](g, seed=rnd)
        gp = g.permute(perm).coalesce()
        iperm = np.argsort(perm)
        f = jwave(gp, jax.random.key(rnd), chunk=256, strict=False)
        precond = jprec(f)
        solve = jax.jit(lambda bb: laplacian_pcg_jax(
            gp, precond, bb, tol=1e-4, maxiter=200).x)
        zs = []
        for _ in range(Q):
            s = rng.choice([-1.0, 1.0], g.m) * np.sqrt(g.w)
            b = np.zeros(g.n)
            np.add.at(b, g.src, s)
            np.add.at(b, g.dst, -s)
            b -= b.mean()
            zs.append(np.asarray(solve(jnp.asarray(b[iperm],
                                                   jnp.float32)))[perm])
        Z = np.stack(zs) / np.sqrt(Q)
        reff = np.sum((Z[:, g.src] - Z[:, g.dst]) ** 2, axis=0)
        lev = np.clip(g.w * reff, 1e-6, 1.0)
        keep_p = np.clip(lev * 4.0, 0.05, 1.0)
        keep = rng.random(g.m) < keep_p
        g = JGraph(g.n, g.src[keep], g.dst[keep],
                   (g.w[keep] / keep_p[keep]).astype(np.float32)).coalesce()
        ms.append(g.m)
    return ms


def _ref_spectral(side, steps, k=4):
    """``examples/spectral_embedding.py``'s flow in the JAX package at a
    given size: the sorted Rayleigh quotients."""
    g = jgraphs.road_like(side, seed=3)
    perm = JORD["nnz-sort"](g, seed=0)
    gp = g.permute(perm).coalesce()
    precond = jprec(jwave(gp, jax.random.key(0), chunk=256))
    solve = jax.jit(lambda bb: laplacian_pcg_jax(gp, precond, bb,
                                                 tol=1e-7, maxiter=400).x)
    V = np.random.default_rng(0).normal(size=(g.n, k)).astype(np.float32)
    iperm = np.argsort(perm)
    for _ in range(steps):
        cols = []
        for j in range(k):
            b = V[:, j] - V[:, j].mean()
            x = np.asarray(solve(jnp.asarray(b[iperm])))[perm]
            cols.append(x - x.mean())
        V, _ = np.linalg.qr(np.stack(cols, axis=1))
    return np.sort([float(V[:, j] @ jlap_np(g, V[:, j].astype(np.float64)))
                    for j in range(k)])


def test_sparsify_example_converges():
    """Each round keeps the reference flow's edges: the batched sketch
    solves give every column its single solve's iterates, so the
    resampling draws the same edges and the edge counts are equal."""
    out = _example("torch_sparsify").main(128, rounds=2, Q=4, device="cpu")
    assert out["converged"] and len(out["iters"]) == 2
    assert out["m"][-1] < out["m"][0]
    assert out["m"] == _ref_sparsify(128, rounds=2, Q=4)


def test_spectral_embedding_example_converges():
    """The Rayleigh quotients within 1e-5 relative of the reference
    flow's, whose k columns are solved one at a time."""
    out = _example("torch_spectral_embedding").main(10, steps=4,
                                                    device="cpu")
    assert out["converged"] and len(out["iters"]) == 4
    assert np.all(np.isfinite(out["eigenvalues"]))
    assert out["cut_fraction"] < 0.5
    np.testing.assert_allclose(out["eigenvalues"], _ref_spectral(10, steps=4),
                               rtol=1e-5, atol=0)
