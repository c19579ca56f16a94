"""Port parity of the single- and multi-vector ELL SpMV against the
reference's Pallas kernels, run in interpret mode as the reference's own
tests run them on a CPU, and the plain multi-vector SpMV's columns bit for
bit equal to the plain single-vector SpMV.

Tolerance: XLA:CPU sums a short row left to right by fused multiply-adds,
as the plain versions do, so up to K = 16 the results must be equal bit
for bit.  Longer rows it sums in another order, where an entry whose
terms cancel can miss 1e-6 of itself; there each entry must be within
1e-6 of the reference relative to the sum of its terms' magnitudes
(float32 reordering error grows with that sum, not with the result)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax.numpy as jnp                                        # noqa: E402

from repro.kernels import ops as jops                          # noqa: E402
from repro_torch.kernels import ops as tops                    # noqa: E402
from repro_torch.kernels import spmv as tspmv                  # noqa: E402

RS = [1, 37, 256]
KS = [1, 5, 16, 33]
SEQUENTIAL_K = 16          # rows XLA:CPU sums by left-to-right FMAs


def _assert_parity(got, want, cols, vals, x):
    if cols.shape[1] <= SEQUENTIAL_K:
        np.testing.assert_array_equal(got, want)
        return
    v = np.abs(vals.astype(np.float64)).reshape(
        vals.shape + (1,) * (x.ndim - 1))
    mag = v * np.abs(x[cols].astype(np.float64))
    scale = 1.0 + mag.sum(axis=1)
    assert np.all(np.abs(got.astype(np.float64) - want) <= 1e-6 * scale)


def _panel(R, K, n, seed):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, (R, K)).astype(np.int32)
    vals = rng.normal(size=(R, K)).astype(np.float32)
    return cols, vals, rng


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("R", RS)
def test_plain_ell_spmv_vs_pallas_interpret(R, K):
    n = 300
    cols, vals, rng = _panel(R, K, n, 100 * R + K)
    x = rng.normal(size=n).astype(np.float32)
    want = np.asarray(jops.ell_spmv(jnp.asarray(cols), jnp.asarray(vals),
                                    jnp.asarray(x), interpret=True))
    got = tops.ell_spmv(torch.from_numpy(cols), torch.from_numpy(vals),
                        torch.from_numpy(x)).numpy()
    assert got.shape == (R,)
    _assert_parity(got, want, cols, vals, x)


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("R", RS)
def test_plain_ell_spmv_multi_vs_pallas_interpret(R, K, B):
    n = 300
    cols, vals, rng = _panel(R, K, n, 1000 * R + 10 * K + B)
    x = rng.normal(size=(n, B)).astype(np.float32)
    want = np.asarray(jops.ell_spmv_multi(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x),
        interpret=True))
    got = tops.ell_spmv_multi(torch.from_numpy(cols), torch.from_numpy(vals),
                              torch.from_numpy(x))
    assert tuple(got.shape) == (R, B)
    _assert_parity(got.numpy(), want, cols, vals, x)
    # each column is the single-vector SpMV of that column, bit for bit
    for b in range(B):
        one = tspmv.ell_spmv_plain(torch.from_numpy(cols),
                                   torch.from_numpy(vals),
                                   torch.from_numpy(x[:, b].copy()))
        assert torch.equal(got[:, b], one)


def test_plain_ell_spmv_is_a_fleet_lane_bit_for_bit():
    """``ell_spmv(c, v, x)`` equals lane 0 of the fleet SpMV of the same
    panel, as the kernels are built to (one row-reduction order)."""
    cols, vals, rng = _panel(37, 33, 300, 5)
    x = rng.normal(size=300).astype(np.float32)
    c, v, xt = (torch.from_numpy(a) for a in (cols, vals, x))
    fleet = tspmv.ell_spmv_fleet_plain(c[None], v[None],
                                       torch.zeros(1, dtype=torch.int32),
                                       xt[None])
    assert torch.equal(tspmv.ell_spmv_plain(c, v, xt), fleet[0])


@pytest.mark.parametrize("B", [0, 3], ids=["vector", "block"])
def test_numpy_row_sums_equal_torch_row_sums(B):
    """The CPU plain version sums on numpy arrays; the torch sums (the
    plain version on the card) give the same bits on the same inputs."""
    cols, vals, rng = _panel(64, 33, 300, 11)
    x = rng.normal(size=(300, B) if B else 300).astype(np.float32)
    c, v, xt = (torch.from_numpy(a) for a in (cols, vals, x))
    want = tspmv._row_sums_torch(c, v, xt)
    assert torch.equal(tspmv.ell_spmv_plain(c, v, xt).view(torch.int32),
                       want.view(torch.int32))


def test_plain_ell_spmv_reads_a_row_range_in_place():
    """A level slab is a row range of the panel: the SpMV of the view
    equals the same rows of the whole panel's SpMV."""
    cols, vals, rng = _panel(64, 7, 100, 9)
    x = rng.normal(size=(100, 3)).astype(np.float32)
    c, v, xt = (torch.from_numpy(a) for a in (cols, vals, x))
    assert torch.equal(tops.ell_spmv(c[10:47], v[10:47], xt[:, 0]),
                       tops.ell_spmv(c, v, xt[:, 0])[10:47])
    assert torch.equal(tops.ell_spmv_multi(c[10:47], v[10:47], xt),
                       tops.ell_spmv_multi(c, v, xt)[10:47])


@pytest.mark.parametrize("K", [33, 4096])
def test_plain_fleet_within_its_forward_error_bound(K):
    """``ell_spmv_fleet_error_bounds`` on rows whose terms nearly cancel
    (each row's values made mean-zero, as amg's deflated operator's are):
    the plain version is within its own order's bound of the exact row
    sums, and a row missing its largest term breaks the kernel's bound,
    so a kernel that dropped a slot could not pass it."""
    rng = np.random.default_rng(K)
    F, R, n, L = 2, 64, 4096, 3
    cols = rng.integers(0, n, (F, R, K)).astype(np.int32)
    vals = rng.normal(size=(F, R, K))
    vals = (vals - vals.mean(axis=2, keepdims=True)).astype(np.float32)
    x = rng.normal(size=(L, n)).astype(np.float32)
    c, v, xt = (torch.from_numpy(a) for a in (cols, vals, x))
    fidx = torch.tensor([1, 0, 1], dtype=torch.int32)
    exact, kernel_bound, plain_bound = tspmv.ell_spmv_fleet_error_bounds(
        c, v, fidx, xt)
    assert bool((kernel_bound < plain_bound).all())
    p = tspmv.ell_spmv_fleet_plain(c, v, fidx, xt)
    assert bool(((p.double() - exact).abs() <= plain_bound).all())
    t = v[fidx.long()].double() * torch.stack(
        [xt[lane].double()[c[f].long()] for lane, f in
         enumerate(fidx.tolist())])
    dropped = exact - t.gather(2, t.abs().argmax(2, keepdim=True))[..., 0]
    assert bool(((dropped - exact).abs() > kernel_bound).all())
