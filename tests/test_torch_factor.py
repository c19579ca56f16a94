"""Port parity: the wavefront factor is bit-identical to the reference's
``factorize_wavefront`` (rows, vals, D, col_ptr, rounds, overflow) on
every SUITE_MICRO / SUITE_TINY graph, and to the sequential oracles."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402

from repro.data import graphs as jgraphs                       # noqa: E402
from repro.core import parac as jparac                         # noqa: E402
from repro.core.ref_ac import factorize_sequential as jseq     # noqa: E402
from repro_torch.data import graphs as tgraphs                 # noqa: E402
from repro_torch.core import parac as tparac                   # noqa: E402
from repro_torch.core.ref_ac import factorize_sequential as tseq  # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402

NAMES = list(jgraphs.SUITE_MICRO) + list(jgraphs.SUITE_TINY)
KEY = 7


def _graphs(name):
    j = {**jgraphs.SUITE_MICRO, **jgraphs.SUITE_TINY}[name]()
    t = {**tgraphs.SUITE_MICRO, **tgraphs.SUITE_TINY}[name]()
    return j, t


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def assert_same_factor(a, b, stats=("rounds", "overflow", "fill_slack")):
    for f in ("col_ptr", "rows", "vals", "D"):
        x, y = _bits(getattr(a, f)), _bits(getattr(b, f))
        assert x.shape == y.shape and np.array_equal(x, y), f
    for k in stats:
        assert a.stats[k] == b.stats[k], (k, a.stats[k], b.stats[k])


@pytest.mark.parametrize("chunk", [4, 64])
@pytest.mark.parametrize("name", NAMES)
def test_wavefront_bitwise_vs_reference(name, chunk):
    gj, gt = _graphs(name)
    fj = jparac.factorize_wavefront(gj, jax.random.key(KEY), chunk=chunk)
    ft = tparac.factorize_wavefront(gt, key_from_seed(KEY), chunk=chunk,
                                    device="cpu")
    assert_same_factor(fj, ft, stats=("rounds", "overflow", "fill_slack",
                                      "pool_size", "dmax"))
    # the device view is the same factor
    dv = ft.device
    assert np.array_equal(dv.rows.numpy(), ft.rows)
    assert np.array_equal(dv.col_ptr.numpy(), ft.col_ptr.astype(np.int32))


def test_strict_retry_matches_reference():
    """Same final fill_slack and overflow as the reference's strict retry
    (grid2d(12,12,seed=3), key 7, chunk 32, fill_slack 1), same factor."""
    kw = dict(chunk=32, fill_slack=1, strict=True)
    fj = jparac.factorize_wavefront(jgraphs.grid2d(12, 12, seed=3),
                                    jax.random.key(7), **kw)
    ft = tparac.factorize_wavefront(tgraphs.grid2d(12, 12, seed=3),
                                    key_from_seed(7), device="cpu", **kw)
    assert ft.stats["fill_slack"] == fj.stats["fill_slack"]
    assert ft.stats["overflow"] == fj.stats["overflow"]
    assert_same_factor(fj, ft)
    # non-strict keeps the first slack and counts the dropped edges
    loose = tparac.factorize_wavefront(tgraphs.grid2d(12, 12, seed=3),
                                       key_from_seed(7), chunk=32,
                                       fill_slack=1, strict=False,
                                       device="cpu")
    assert loose.stats["fill_slack"] == 1 and loose.stats["overflow"] > 0


@pytest.mark.parametrize("name", list(jgraphs.SUITE_MICRO))
def test_sequential_oracles_agree(name):
    gj, gt = _graphs(name)
    fj = jseq(gj, jax.random.key(3))
    ft = tseq(gt, key_from_seed(3))
    assert_same_factor(fj, ft, stats=())
    # the engine reproduces its own sequential oracle for the same key
    fw = tparac.factorize_wavefront(gt, key_from_seed(3), chunk=8,
                                    fill_slack=64, device="cpu")
    assert_same_factor(ft, fw, stats=())


def test_partial_engine_run_freezes_finished_graphs():
    """A round taken after a graph finished is a no-op, round counter
    included: extra rounds past the end change nothing."""
    import numpy as np
    g = tgraphs.grid2d(6, 6, seed=3)
    built = tparac._build_pool(tparac._pool_edges(g, np.float32, "cpu"), 32)
    args = dict(n_pad=g.n, P_pad=built.P, W=64, chunk=8)
    s, st = tparac._init_engine([built], [key_from_seed(0)], **args)
    tparac._run_engine_batched(s, st, check_every=1)
    rounds = int(s.n_rounds[0])
    snap = [t.clone() for t in s]
    for _ in range(5):
        tparac._engine_round(s, st)
    for a, b in zip(snap, s):
        if a.dim() == 2 and a.shape[1] in (built.P + 1, g.n + 1):
            # drop slots/columns absorb masked writes and are never read
            a, b = a[:, :-1], b[:, :-1]
        assert torch.equal(a, b)
    assert int(s.n_rounds[0]) == rounds


def test_engine_requires_a_device_or_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparac.factorize_wavefront(tgraphs.grid2d(3, 3), key_from_seed(0))
