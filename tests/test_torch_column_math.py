"""Port parity: threefry keys and uniforms, the scans and the batched
elimination (the plain ``sample_clique``) are bit-identical to the
reference's jnp math."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.core import column_math as jcm                      # noqa: E402
from repro_torch.core import column_math as tcm                # noqa: E402
from repro_torch.kernels import ops as tops                    # noqa: E402
from repro_torch.kernels import sample_clique as tsc           # noqa: E402
from repro_torch.core.convert import key_from_jax              # noqa: E402

FIELDS = ("g_rows", "g_vals", "m", "ell_kk", "e_lo", "e_hi", "e_w",
          "e_valid")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _rows(W, R=24, seed=0, id_range=None):
    rng = np.random.default_rng(seed + W)
    fill = rng.integers(0, W + 1, R).astype(np.int32)
    fill[:3] = [0, 1, W]
    ids = rng.integers(0, id_range or max(2, W // 2), (R, W)).astype(np.int32)
    ws = rng.uniform(0.1, 3.0, (R, W)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (R, W)).astype(np.float32)
    return ids, ws, fill, u


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 + 5, 2 ** 40 + 3, -1])
def test_key_from_seed_matches_jax(seed):
    k = jax.random.key(seed)
    assert np.array_equal(tcm.key_from_seed(seed),
                          np.asarray(jax.random.key_data(k)))
    assert np.array_equal(key_from_jax(jax.random.key_data(k)),
                          tcm.key_from_seed(seed))


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_column_uniforms_bitwise(seed):
    key = jax.random.key(seed)
    verts = np.array([0, 1, 2, 99, 4095, 262143], np.int32)
    want = np.stack([np.asarray(jcm.column_uniforms(key, jnp.int32(v), 40))
                     for v in verts])
    got = tcm.column_uniforms(tcm.key_from_seed(seed), torch.tensor(verts),
                              40, block=4).numpy()
    assert np.array_equal(_bits(want), _bits(got))


def test_hs_scans_bitwise():
    x = np.random.default_rng(3).uniform(0, 1, (5, 37)).astype(np.float32)
    for jf, tf in ((jcm.hs_cumsum, tcm.hs_cumsum),
                   (jcm.hs_suffix_sum, tcm.hs_suffix_sum)):
        want = np.stack([np.asarray(jf(jnp.asarray(r))) for r in x])
        assert np.array_equal(_bits(want), _bits(tf(torch.from_numpy(x))))


def test_searchsorted_matches_jax_on_unsorted_rows():
    # the partner search must answer as jnp.searchsorted(method="scan")
    # even where the searched array is out of order
    rng = np.random.default_rng(4)
    for W in (1, 2, 5, 8, 33):
        a = rng.normal(size=W).astype(np.float32)
        v = rng.normal(size=W).astype(np.float32)
        want = np.asarray(jnp.searchsorted(jnp.asarray(a), jnp.asarray(v),
                                           side="right"))
        got = tcm.searchsorted_right(torch.from_numpy(a)[None].expand(W, -1)
                                     .contiguous(),
                                     torch.from_numpy(v)[:, None])[:, 0]
        assert np.array_equal(want, got.numpy()), W


@pytest.mark.parametrize("W", [2, 8, 64, 256])
def test_eliminate_column_bitwise_vs_jnp(W):
    ids, ws, fill, u = _rows(W)
    valid = np.arange(W)[None, :] < fill[:, None]
    want = jax.vmap(jcm.eliminate_column)(jnp.asarray(ids), jnp.asarray(ws),
                                          jnp.asarray(valid), jnp.asarray(u))
    got = tcm.eliminate_column(torch.from_numpy(ids), torch.from_numpy(ws),
                               torch.from_numpy(valid), torch.from_numpy(u))
    for f in FIELDS:
        assert np.array_equal(_bits(getattr(want, f)),
                              _bits(getattr(got, f).numpy())), f


@pytest.mark.parametrize("W", [3, 6, 40])
def test_ops_pads_width_without_changing_results(W):
    """ops.sample_clique pads to a power of two with INVALID/0/u=0.5; the
    result equals the unpadded reference math on its first W lanes'
    outputs shifted to the padded width."""
    ids, ws, fill, u = _rows(W, seed=5)
    valid = np.arange(W)[None, :] < fill[:, None]
    want = jax.vmap(jcm.eliminate_column)(jnp.asarray(ids), jnp.asarray(ws),
                                          jnp.asarray(valid), jnp.asarray(u))
    got = tops.sample_clique(torch.from_numpy(ids), torch.from_numpy(ws),
                             torch.from_numpy(fill), torch.from_numpy(u))
    W2 = got.g_rows.shape[1]
    assert W2 == max(1 << (W - 1).bit_length(), 2)
    assert np.array_equal(np.asarray(want.m), got.m.numpy())
    assert np.array_equal(_bits(want.ell_kk), _bits(got.ell_kk.numpy()))
    assert np.array_equal(np.asarray(want.g_rows), got.g_rows[:, :W].numpy())
    assert np.array_equal(_bits(want.g_vals), _bits(got.g_vals[:, :W]))
    # sampled edges are right-aligned: compare the last W lanes
    for f in ("e_lo", "e_hi", "e_w", "e_valid"):
        assert np.array_equal(_bits(getattr(want, f)),
                              _bits(getattr(got, f)[:, W2 - W:].numpy())), f


def test_kernel_wrapper_rejects_bad_input_before_launch():
    # a non-CPU, non-CUDA tensor never reaches a kernel
    ids = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tsc.sample_clique(ids, ids.float(), ids[:, 0], ids.float())
