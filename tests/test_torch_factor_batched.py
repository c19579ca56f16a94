"""Port parity: the batched engine and the batched schedule builder are
bit-identical to the reference's ``factorize_batched(...,
with_schedules=True)`` — factors, bucket stats, levels, panel cols, K,
n_levels and panel vals."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.data import graphs as jgraphs                       # noqa: E402
from repro.core import parac as jparac                         # noqa: E402
from repro.core import trisolve as jtri                        # noqa: E402
from repro_torch.data import graphs as tgraphs                 # noqa: E402
from repro_torch.core import parac as tparac                   # noqa: E402
from repro_torch.core import trisolve as ttri                  # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.kernels.ops import trisolve_fleet             # noqa: E402

NAMES = list(jgraphs.SUITE_MICRO) + list(jgraphs.SUITE_TINY)
SUITE_J = {**jgraphs.SUITE_MICRO, **jgraphs.SUITE_TINY}
SUITE_T = {**tgraphs.SUITE_MICRO, **tgraphs.SUITE_TINY}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.fixture(scope="module", params=[4, 64], ids=["chunk4", "chunk64"])
def fleets(request):
    chunk = request.param
    gj = [SUITE_J[n]() for n in NAMES]
    gt = [SUITE_T[n]() for n in NAMES]
    ref = jparac.factorize_batched(
        gj, jnp.stack([jax.random.key(i) for i in range(len(gj))]),
        chunk=chunk, with_schedules=True)
    port = tparac.factorize_batched(
        gt, [key_from_seed(i) for i in range(len(gt))], chunk=chunk,
        with_schedules=True, device="cpu")
    return ref, port


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_batched_factor_bitwise(fleets, i):
    (fj, _), (ft, _) = fleets
    a, b = fj[i], ft[i]
    for f in ("col_ptr", "rows", "vals", "D"):
        assert np.array_equal(_bits(getattr(a, f)), _bits(getattr(b, f))), f
    for k in ("rounds", "overflow", "fill_slack", "n_pad", "P_pad",
              "dmax_pad", "batch_size"):
        assert a.stats[k] == b.stats[k], k


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_batched_schedules_equal(fleets, i):
    (_, sj), (_, st) = fleets
    for x, y in zip(sj[i], st[i]):
        assert (x.n, x.n_pad, x.n_levels, x.K) == \
            (y.n, y.n_pad, y.n_levels, y.K)
        assert np.array_equal(np.asarray(x.level_of), y.level_of.numpy())
        assert np.array_equal(np.asarray(x.cols), y.cols.numpy())
        assert np.array_equal(_bits(x.vals), _bits(y.vals.numpy()))


def test_batched_equals_wavefront_per_graph(fleets):
    _, (ft, _) = fleets
    chunk = ft[0].stats["chunk"]
    for name, f in zip(NAMES[:3], ft[:3]):
        w = tparac.factorize_wavefront(SUITE_T[name](), key_from_seed(
            NAMES.index(name)), chunk=chunk, device="cpu")
        for k in ("col_ptr", "rows", "vals", "D"):
            assert np.array_equal(_bits(getattr(w, k)), _bits(getattr(f, k)))
        assert w.stats["rounds"] == f.stats["rounds"]


def test_host_schedules_match_reference_and_solve(fleets):
    """The host LevelSchedule builder and the masked fleet trisolve agree
    with the reference's host builder and float64 level solve."""
    (fj, _), (ft, st) = fleets
    i = NAMES.index("grid2d_tiny")
    hj, ht = jtri.build_schedules(fj[i]), ttri.build_schedules(ft[i])
    for a, b in zip(hj, ht):
        assert a.n_levels == b.n_levels
        for f in ("level_ptr", "e_dst", "e_src", "level_of"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert np.array_equal(_bits(a.e_val), _bits(b.e_val))
    r = np.random.default_rng(0).normal(size=ft[i].n).astype(np.float32)
    want = jtri.precond_apply_np(fj[i], r.astype(np.float64))
    assert np.allclose(ttri.precond_apply_np(ft[i], r.astype(np.float64)),
                       want)
    # the fleet trisolve on the packed panels = the host level solve
    fwd, bwd = st[i]
    y = torch.zeros((1, fwd.n_pad))
    y[0, :fwd.n] = torch.from_numpy(r)
    got = trisolve_fleet(fwd.cols[None], fwd.vals[None],
                         torch.zeros(1, dtype=torch.int32),
                         fwd.level_of[None], y, n_levels=fwd.n_levels)
    host = ttri.solve_levels_np(ht[0], r)
    assert np.allclose(got[0, :fwd.n].numpy(), host, rtol=1e-5, atol=1e-5)
