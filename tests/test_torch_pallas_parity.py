"""Port parity against the reference's Pallas kernels, run as the
reference's own tests run them on a CPU (interpret mode): the plain
``sample_clique`` bit for bit, the plain fleet SpMV within float
summation-order tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax.numpy as jnp                                        # noqa: E402

from repro.kernels import ops as jops                          # noqa: E402
from repro.kernels.spmv import ell_spmv_fleet_pallas           # noqa: E402
from repro_torch.kernels import sample_clique as tsc           # noqa: E402
from repro_torch.kernels import ops as tops                    # noqa: E402
from repro_torch.kernels.spmv import ell_spmv_fleet_plain      # noqa: E402

FIELDS = ("g_rows", "g_vals", "m", "ell_kk", "e_lo", "e_hi", "e_w",
          "e_valid")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _rows(W, R, seed=0, id_range=None):
    rng = np.random.default_rng(seed + W)
    fill = rng.integers(0, W + 1, R).astype(np.int32)
    fill[:3] = [0, 1, W]
    ids = rng.integers(0, id_range or max(2, W // 2), (R, W)).astype(np.int32)
    ws = rng.uniform(0.1, 3.0, (R, W)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (R, W)).astype(np.float32)
    return ids, ws, fill, u


@pytest.mark.parametrize("W", [2, 8, 128, 256])
def test_plain_sample_clique_bitwise_vs_pallas_interpret(W):
    # W = 32 and 64 are left out here only for time: the Pallas interpreter
    # takes one to three minutes on each on a CPU; the jnp parity test in
    # test_torch_column_math.py covers them
    ids, ws, fill, u = _rows(W, 4, id_range=W)
    want = jops.sample_clique(jnp.asarray(ids), jnp.asarray(ws),
                              jnp.asarray(fill), jnp.asarray(u),
                              interpret=True)
    got = tsc.sample_clique_plain(torch.from_numpy(ids), torch.from_numpy(ws),
                                  torch.from_numpy(fill), torch.from_numpy(u))
    for f, w in zip(FIELDS, want):
        g = getattr(got, f).numpy()
        w = np.asarray(w).reshape(g.shape)
        assert np.array_equal(_bits(w), _bits(g)), f



@pytest.mark.parametrize("L,R,K,n", [(1, 64, 4, 64), (3, 128, 9, 256),
                                     (4, 256, 32, 200)])
def test_plain_spmv_fleet_vs_pallas_interpret(L, R, K, n):
    rng = np.random.default_rng(L * 1000 + K)
    cols = rng.integers(0, n, (L, R, K)).astype(np.int32)
    vals = rng.normal(size=(L, R, K)).astype(np.float32)
    x = rng.normal(size=(L, n)).astype(np.float32)
    want = np.asarray(ell_spmv_fleet_pallas(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x),
        interpret=True))
    got = tops.ell_spmv_fleet(torch.from_numpy(cols), torch.from_numpy(vals),
                              torch.arange(L, dtype=torch.int32),
                              torch.from_numpy(x)).numpy()
    # summation order differs between XLA and the port for K > 16
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # through a stack + fidx, lanes read their own panels in place
    fidx = np.arange(L)[::-1].astype(np.int32)
    got2 = ell_spmv_fleet_plain(torch.from_numpy(cols), torch.from_numpy(vals),
                                torch.from_numpy(fidx),
                                torch.from_numpy(x[::-1].copy())).numpy()
    np.testing.assert_array_equal(got2, got[::-1])
