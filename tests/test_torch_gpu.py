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
