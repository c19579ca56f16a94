"""Port parity of the library path's triangular solves: level-sorted
device schedules equal to the reference's field by field, the kernel-driven
solves (``trisolve_panels``, ``trisolve_levels``, ``trisolve_masked``) and
``make_preconditioner`` against the reference within 3e-4 (the tolerance
of the reference's own trisolve tests), and the host oracle exactly.  Both
packages get the same factor arrays, so the schedule builders are compared
on identical input."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax.numpy as jnp                                        # noqa: E402

from repro.core import ref_ac as jref                          # noqa: E402
from repro.core import trisolve as jtri                        # noqa: E402
from repro.kernels import ops as jops                          # noqa: E402
from repro_torch.core import ref_ac as tref                    # noqa: E402
from repro_torch.core import trisolve as ttri                  # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.data import graphs as tgraphs                 # noqa: E402
from repro_torch.kernels import ops as tops                    # noqa: E402

NAMES = ["grid2d_tiny", "road_tiny", "powerlaw_micro"]
SUITE = {**tgraphs.SUITE_MICRO, **tgraphs.SUITE_TINY}
TOL = dict(rtol=3e-4, atol=3e-4)
FIELDS = ("row_ids", "cols", "vals", "level_of")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.fixture(scope="module")
def factors():
    """name -> (port ACFactor, reference ACFactor) over the same arrays."""
    out = {}
    for name in NAMES:
        ft = tref.factorize_sequential(SUITE[name](), key_from_seed(7))
        fj = jref.ACFactor(n=ft.n, col_ptr=ft.col_ptr.copy(),
                           rows=ft.rows.copy(), vals=ft.vals.copy(),
                           D=ft.D.copy())
        out[name] = ft, fj
    return out


def assert_same_schedule(t, j):
    assert (t.n, t.n_levels, t.K) == (j.n, j.n_levels, j.K)
    assert np.array_equal(t.row_ptr, np.asarray(j.row_ptr))
    for f in FIELDS:
        a, b = _bits(getattr(t, f).numpy()), _bits(getattr(j, f))
        assert a.shape == b.shape and np.array_equal(a, b), f


@pytest.mark.parametrize("name", NAMES)
def test_build_schedules_device_matches_reference(factors, name):
    ft, fj = factors[name]
    tf, tb = ttri.build_schedules_device(ft, device="cpu")
    jf, jb = jtri.build_schedules_device(fj)
    assert_same_schedule(tf, jf)
    assert_same_schedule(tb, jb)
    # K is the exact maximum in-degree, not a power of two
    indeg = np.bincount(ft.rows, minlength=ft.n)
    assert tf.K == max(int(indeg.max()), 1)


def test_build_schedules_device_without_edges():
    """A factor with no off-diagonal entries takes the empty-edge branch:
    one level, K = 1, identity row order."""
    n = 5
    arrays = dict(col_ptr=np.zeros(n + 1, np.int64),
                  rows=np.zeros(0, np.int32), vals=np.zeros(0, np.float32),
                  D=np.ones(n, np.float32))
    ft = tref.ACFactor(n=n, **arrays)
    fj = jref.ACFactor(n=n, **arrays)
    for t, j in zip(ttri.build_schedules_device(ft, device="cpu"),
                    jtri.build_schedules_device(fj)):
        assert_same_schedule(t, j)
        assert t.n_levels == 1 and t.K == 1


def test_trisolve_panels_matches_reference(factors):
    ft, fj = factors["grid2d_tiny"]
    tf, tb = ttri.build_schedules_device(ft, device="cpu")
    jf, jb = jtri.build_schedules_device(fj)
    rng = np.random.default_rng(4)
    b = rng.normal(size=ft.n).astype(np.float32)
    B = rng.normal(size=(ft.n, 3)).astype(np.float32)
    bt, Bt = torch.from_numpy(b), torch.from_numpy(B)
    y = tops.trisolve_panels(tf, bt)
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jops.trisolve_panels(jf, jnp.asarray(b), interpret=True)), **TOL)
    Y = tops.trisolve_panels(tb, Bt, flip=True)
    np.testing.assert_allclose(Y.numpy(), np.asarray(
        jops.trisolve_panels(jb, jnp.asarray(B), flip=True,
                             interpret=True)), **TOL)
    # the input is not modified, and a column of the block is its own
    # single-rhs solve bit for bit
    assert np.array_equal(Bt.numpy(), B)
    for c in range(3):
        assert torch.equal(Y[:, c], tops.trisolve_panels(
            tb, Bt[:, c].contiguous(), flip=True))


def test_trisolve_levels_matches_reference(factors):
    ft, fj = factors["grid2d_tiny"]
    fwd_t, _ = ttri.build_schedules(ft)
    fwd_j, _ = jtri.build_schedules(fj)
    lt = tops.schedule_to_ell(fwd_t)
    lj = jops.schedule_to_ell(fwd_j)
    for a, b in zip(lt, lj):
        for x, y in zip(a, b):
            assert np.array_equal(_bits(x), _bits(y))
    b = np.random.default_rng(5).normal(size=ft.n).astype(np.float32)
    y = tops.trisolve_levels(*lt[:3], torch.from_numpy(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jops.trisolve_levels(*lj[:3], b, interpret=True)), **TOL)
    np.testing.assert_allclose(y.numpy(), ttri.solve_levels_np(fwd_t, b),
                               **TOL)


def test_trisolve_masked_matches_reference(factors):
    """Row-indexed panels, one full-row SpMV per level; an over-padded
    level bound changes nothing."""
    ft, fj = factors["grid2d_tiny"]
    (fwd, _), = ttri.build_schedules_batched([ft.to_device("cpu")])
    b = np.zeros(fwd.n_pad, np.float32)
    b[:ft.n] = np.random.default_rng(6).normal(size=ft.n)
    bt = torch.from_numpy(b)
    y = tops.trisolve_masked(fwd.cols, fwd.vals, fwd.level_of, bt,
                             n_levels=fwd.n_levels)
    want = jops.trisolve_masked(jnp.asarray(fwd.cols.numpy()),
                                jnp.asarray(fwd.vals.numpy()),
                                jnp.asarray(fwd.level_of.numpy()),
                                jnp.asarray(b), n_levels=fwd.n_levels,
                                interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    y_over = tops.trisolve_masked(fwd.cols, fwd.vals, fwd.level_of, bt,
                                  n_levels=fwd.n_levels + 7)
    assert torch.equal(y, y_over)


@pytest.mark.parametrize("name", NAMES)
def test_make_preconditioner_matches_reference(factors, name):
    ft, fj = factors[name]
    apply_t = ttri.make_preconditioner(ft, device="cpu")
    apply_j = jtri.make_preconditioner(fj)
    rng = np.random.default_rng(8)
    r = rng.normal(size=ft.n).astype(np.float32)
    R = rng.normal(size=(ft.n, 3)).astype(np.float32)
    z = apply_t(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(z, np.asarray(apply_j(jnp.asarray(r))),
                               **TOL)
    np.testing.assert_allclose(z, ttri.precond_apply_np(ft, r), **TOL)
    Z = apply_t(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(Z, np.asarray(apply_j(jnp.asarray(R))),
                               **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_precond_apply_np_equals_reference(factors, name):
    ft, fj = factors[name]
    r = np.random.default_rng(9).normal(size=ft.n)
    assert np.array_equal(ttri.precond_apply_np(ft, r),
                          jtri.precond_apply_np(fj, r))


def test_graph_to_ell_equals_reference():
    g = SUITE["road_tiny"]()
    for a, b in zip(tops.graph_to_ell(g.src, g.dst, g.w, g.n),
                    jops.graph_to_ell(g.src, g.dst, g.w, g.n)):
        assert np.array_equal(_bits(a), _bits(b))


def test_host_factor_device_view_resolves_the_gpu(factors):
    """A factor without a device view goes to the GPU unless the CPU is
    asked for — never quietly to the CPU; without a GPU that is an
    error."""
    ft, _ = factors["road_tiny"]
    fresh = tref.ACFactor(n=ft.n, col_ptr=ft.col_ptr, rows=ft.rows,
                          vals=ft.vals, D=ft.D)
    if torch.cuda.is_available():
        assert fresh.to_device().device.type == "cuda"
        assert ttri.make_preconditioner(fresh) is not None
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fresh.to_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttri.make_preconditioner(fresh)
    cpu = fresh.to_device("cpu")
    assert cpu.device.type == "cpu"
    assert fresh.to_device() is cpu          # the cached view is kept
