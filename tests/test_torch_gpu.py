"""Kernels against their plain versions on the card.  Marked ``gpu``:
they skip where no CUDA device is present (run them on the GPU machine
with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``;
``python3 chip_smoke.py`` covers the same ground at the main path's
shapes)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import runtime                        # noqa: E402
from repro_torch.kernels import sample_clique as sc            # noqa: E402
from repro_torch.kernels import spmv                           # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("W", [2, 64, 1024, 8192])
def test_sample_clique_kernel_bitwise(dev, W):
    rng = np.random.default_rng(W)
    R = 64
    fill = rng.integers(0, W + 1, R).astype(np.int32)
    ids = rng.integers(0, max(2, W // 2), (R, W)).astype(np.int32)
    ws = rng.uniform(0.1, 3.0, (R, W)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (R, W)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (ids, ws, fill, u)]
    before = runtime.LAUNCHES.get("sample_clique", 0)
    k = sc.sample_clique(*args)
    p = sc.sample_clique_plain(*args)
    assert runtime.LAUNCHES["sample_clique"] == before + 1
    for a, b in zip(k, p):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_ell_spmv_fleet_kernel(dev):
    rng = np.random.default_rng(0)
    F, R, K, n, L = 3, 1000, 37, 1000, 5
    cols = torch.from_numpy(rng.integers(0, n, (F, R, K)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(F, R, K)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(L, n)).astype(np.float32))
    fidx = torch.tensor([2, 0, 1, 2, 2], dtype=torch.int32)
    cols, vals, x, fidx = (t.to(dev) for t in (cols, vals, x, fidx))
    y = spmv.ell_spmv_fleet(cols, vals, fidx, x)
    p = spmv.ell_spmv_fleet_plain(cols, vals, fidx, x)
    assert torch.allclose(y, p, rtol=1e-5, atol=1e-5)
    y0 = spmv.ell_spmv_fleet(cols, vals, fidx[:1], x[:1].contiguous())
    assert torch.equal(y0[0], y[0])


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(TypeError):
        spmv.ell_spmv_fleet(torch.zeros((1, 2, 2), device=dev),
                            torch.zeros((1, 2, 2), device=dev),
                            torch.zeros(1, dtype=torch.int32, device=dev),
                            torch.zeros((1, 2), device=dev))
    ids = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        sc.sample_clique(ids, ids.float(), ids[:, 0].contiguous(),
                         ids.float())


@pytest.mark.parametrize("R,K", [(1, 1), (37, 5), (1000, 33), (300, 700)])
def test_ell_spmv_kernel(dev, R, K):
    rng = np.random.default_rng(R + K)
    n = 2000
    cols = torch.from_numpy(rng.integers(0, n, (R, K)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(R, K)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    cols, vals, x = (t.to(dev) for t in (cols, vals, x))
    before = runtime.LAUNCHES.get("ell_spmv", 0)
    y = spmv.ell_spmv(cols, vals, x)
    assert runtime.LAUNCHES["ell_spmv"] == before + 1
    p = spmv.ell_spmv_plain(cols, vals, x)
    assert torch.allclose(y, p, rtol=1e-5, atol=1e-5)
    # one row-reduction order: ell_spmv is the fleet kernel's lane
    lane = spmv.ell_spmv_fleet(cols[None], vals[None],
                               torch.zeros(1, dtype=torch.int32, device=dev),
                               x[None])[0]
    assert torch.equal(y, lane)
    # a row range of the panel is read in place
    lo, hi = R // 3, R
    assert torch.equal(spmv.ell_spmv(cols[lo:hi], vals[lo:hi], x), y[lo:hi])


@pytest.mark.parametrize("B", [1, 3, 8, 11])
def test_ell_spmv_multi_kernel(dev, B):
    rng = np.random.default_rng(B)
    R, K, n = 777, 45, 1500
    cols = torch.from_numpy(rng.integers(0, n, (R, K)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(R, K)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, B)).astype(np.float32))
    cols, vals, x = (t.to(dev) for t in (cols, vals, x))
    before = runtime.LAUNCHES.get("ell_spmv_multi", 0)
    Y = spmv.ell_spmv_multi(cols, vals, x)
    assert runtime.LAUNCHES["ell_spmv_multi"] == before + 1
    assert torch.allclose(Y, spmv.ell_spmv_multi_plain(cols, vals, x),
                          rtol=1e-5, atol=1e-5)
    for b in range(B):
        assert torch.equal(Y[:, b], spmv.ell_spmv(cols, vals,
                                                  x[:, b].contiguous()))


def test_library_path_on_card(dev):
    """make_preconditioner → laplacian_pcg / laplacian_pcg_batched on the
    card: converges as on the CPU, every lane within 1e-4 of the CPU's
    solution, and through the two kernels."""
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.parac import factorize_wavefront
    from repro_torch.core.pcg import laplacian_pcg, laplacian_pcg_batched
    from repro_torch.core.trisolve import make_preconditioner
    from repro_torch.data import graphs
    g = graphs.grid3d(8, 8, 8, "contrast", seed=0)
    B = np.random.default_rng(0).normal(size=(3, g.n)).astype(np.float32)
    res = {}
    for d in ("cpu", dev):
        f = factorize_wavefront(g, key_from_seed(0), chunk=64, device=d)
        apply = make_preconditioner(f)
        runtime.reset_launches()
        r1 = laplacian_pcg(g, apply, torch.from_numpy(B[0]).to(d), tol=1e-6,
                           maxiter=300)
        rb = laplacian_pcg_batched(g, lambda R: apply(R.T).T,
                                   torch.from_numpy(B).to(d), tol=1e-6,
                                   maxiter=300)
        res[str(d)] = r1, rb, dict(runtime.LAUNCHES)
    (c1, cb, _), (g1, gb, launches) = res["cpu"], res[str(dev)]
    assert launches["ell_spmv"] > 0 and launches["ell_spmv_multi"] > 0
    assert bool(g1.converged) and bool(gb.converged.all())
    for xc, xg in ((c1.x, g1.x), *zip(cb.x, gb.x)):
        xc, xg = xc.double(), xg.cpu().double()
        assert float((xc - xg).norm() / xc.norm()) <= 1e-4
    # lane independence on the card: lane 0 of the block is its own
    # single-rhs solve bit for bit
    assert int(g1.iters) == int(gb.iters[0]) and torch.equal(g1.x, gb.x[0])


def test_fleet_lanes_do_not_depend_on_their_batch(dev):
    """The Solver's fleet PCG on the card: a column solved alone takes
    the same iterates as inside a batch of three."""
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.solver import Solver
    from repro_torch.data import graphs
    g = graphs.grid2d(12, 12, seed=3)
    solver = Solver(chunk=32, device=dev)
    solver.factor(g, key_from_seed(7))
    B = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, g.n)).astype(np.float32)).to(dev)
    rb = solver.solve(B, tol=1e-6, maxiter=300)
    for c in range(3):
        r1 = solver.solve(B[c], tol=1e-6, maxiter=300)
        assert int(r1.iters) == int(rb.iters[c])
        assert torch.equal(r1.x, rb.x[c])


def test_spmv_wrappers_reject_bad_input(dev):
    c = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    v = torch.zeros((4, 3), device=dev)
    with pytest.raises(TypeError):
        spmv.ell_spmv(c, v, torch.zeros(5, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        spmv.ell_spmv(c, v[:, :2].contiguous(), torch.zeros(5, device=dev))
    with pytest.raises(ValueError):
        spmv.ell_spmv_multi(c, v, torch.zeros(5, device=dev))
