"""The engine's pools written on the device: the state and statics that
``parac._init_engine`` builds equal, array for array and bit for bit, the
reference's host-built pools (``repro.core.parac._build_pool``) padded
with ``INVALID_ID`` / 0 / the pool end / 0 and stacked; and under a
tracer the strict ladder uploads each member's edges once a call and
copies no pool from the host."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)

from repro.core import parac as jparac                         # noqa: E402
from repro_torch.core import parac                             # noqa: E402
from repro_torch.core.column_math import (INVALID_ID,          # noqa: E402
                                          column_uniforms, key_from_seed)
from repro_torch.core.laplacian import Graph                   # noqa: E402
from repro_torch.data import graphs                            # noqa: E402
from repro_torch.obs import tracing                            # noqa: E402
from repro_torch.obs.tracing import Tracer                     # noqa: E402


def _isolated():
    """n = 40 with edges among the first 24 vertices only: sixteen
    vertices own no edge and take none, plus multi-edges."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 24, 120)
    b = rng.integers(0, 24, 120)
    keep = a != b
    src = np.minimum(a, b)[keep].astype(np.int32)
    dst = np.maximum(a, b)[keep].astype(np.int32)
    w = rng.uniform(0.5, 2.0, src.size)
    return Graph(40, src, dst, w)


def _members(case):
    if case == "B1":
        return [graphs.grid2d(9, 7, seed=2)]
    if case == "B3-bucketed":
        # different n and m; vertices of zero owned degree
        return [graphs.grid2d(9, 7, seed=2), _isolated(),
                graphs.grid3d(4, 3, 5, "uniform", seed=1)]
    # core.dist's batched_factorize: one graph's pool under three keys
    return [graphs.grid2d(6, 6, seed=4)] * 3


def _pad(x, size, fill):
    return np.concatenate([x, np.full(size - x.shape[0], fill, x.dtype)])


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("slack", [8, 32])
@pytest.mark.parametrize("case", ["B1", "B3-bucketed", "dist-repeated"])
def test_device_pools_equal_the_reference_layout(case, slack):
    gs = _members(case)
    keys = [key_from_seed(i) for i in range(len(gs))]
    if case == "dist-repeated":
        built = [parac._build_pool(parac._pool_edges(gs[0], np.float32,
                                                     "cpu"), slack)] * 3
    else:
        built = [parac._build_pool(parac._pool_edges(g, np.float32, "cpu"),
                                   slack) for g in gs]
    ref = [jparac._build_pool(g, slack, np.float32) for g in gs]
    for b, r in zip(built, ref):
        assert (b.P, b.dmax) == (r[6], r[7])
    n_pad, P_pad = max(g.n for g in gs), max(r[6] for r in ref)
    if case == "B3-bucketed":
        n_pad, P_pad = parac._next_pow2(n_pad), parac._next_pow2(P_pad)
    W = max(parac._next_pow2(max(r[7] for r in ref)), 2)
    s, st = parac._init_engine(built, keys, n_pad=n_pad, P_pad=P_pad, W=W,
                               chunk=16, freeze_on_overflow=True)

    want = {k: [] for k in ("pool_row", "pool_val", "col_fill", "dep",
                            "col_base", "cap", "elim")}
    u = np.zeros((len(gs), n_pad, W), np.float32)
    for b, (g, r, key) in enumerate(zip(gs, ref, keys)):
        pool_row, pool_val, fill, dep, col_base, cap, P, _ = r
        want["pool_row"].append(_pad(pool_row, P_pad + 1, INVALID_ID))
        want["pool_val"].append(_pad(pool_val, P_pad + 1, 0))
        want["col_fill"].append(_pad(fill, n_pad + 1, 0))
        want["dep"].append(_pad(dep, n_pad + 1, 0))
        want["col_base"].append(_pad(col_base.astype(np.int64), n_pad + 1,
                                     P))
        want["cap"].append(_pad(cap, n_pad + 1, 0))
        e0 = np.zeros(n_pad + 1, bool)
        e0[g.n:] = True
        want["elim"].append(e0)
        u[b, :g.n] = column_uniforms(key, torch.arange(g.n), W).numpy()
    got = dict(s._asdict(), col_base=st.col_base, cap=st.cap)
    for k, rows in want.items():
        a, x = np.stack(rows), got[k].numpy()
        assert a.dtype == x.dtype and a.shape == x.shape, k
        assert np.array_equal(_bits(a), _bits(x)), k
    assert np.array_equal(_bits(u), _bits(st.u.numpy()))
    assert not s.D.any() and not s.n_rounds.any() and not s.overflow.any()
    assert s.D.dtype == torch.float32
    assert s.n_elim.tolist() == [n_pad - g.n for g in gs]
    assert s.n_elim.dtype == s.n_rounds.dtype == s.overflow.dtype \
        == torch.int32
    assert (st.W, st.chunk, st.freeze_on_overflow) == (W, 16, True)


def test_strict_ladder_uploads_edges_once_and_no_pool():
    """A fleet of three needing slack 4, 8 and 16 from 1: every rung's
    ``h2d_bytes`` within B × (16·m + 32·(n_pad + 1)) and equal on the two
    rungs that hold all three members at slacks 1 and 2; the edges
    uploaded on the first rung only; each factor that of its own
    ``factorize_wavefront``, bit for bit, whose ladder uploads the edges
    once too."""
    g12 = graphs.grid2d(12, 12, seed=3)
    gs = [graphs.grid2d(4, 4, seed=0), g12, g12]
    keys = [key_from_seed(0), key_from_seed(0), key_from_seed(7)]
    kw = dict(chunk=32, fill_slack=1, strict=True, max_retries=5,
              device="cpu")
    t = Tracer()
    tracing.attach(t)
    try:
        fs = parac.factorize_batched(gs, keys, **kw)
    finally:
        tracing.detach()
    spans = t.layer_spans()
    rungs = sorted((s for s in spans if s.name == "parac.attempt"),
                   key=lambda s: s.start)
    inits = {s.parent: s.attrs["h2d_bytes"] for s in spans
             if s.name == "parac.init"}
    pools = {s.parent: s.attrs["edges_uploaded"] for s in spans
             if s.name == "parac.pools"}
    assert [a.attrs["slack"] for a in rungs] == [1, 2, 4, 8, 16]
    members = [a.attrs["members"] for a in rungs]
    assert members == [3, 3, 3, 2, 1]
    m_all = sum(g.m for g in gs)
    assert [pools[a.sid] for a in rungs] == [m_all, 0, 0, 0, 0]
    h2d = [inits[a.sid] for a in rungs]
    assert h2d[0] == h2d[1] > 0
    n_pad = parac._next_pow2(max(g.n for g in gs))
    for a, b in zip(rungs, h2d):
        # the largest member and the bucket's vertex count bound any rung
        assert b <= a.attrs["members"] * (16 * max(g.m for g in gs)
                                          + 32 * (n_pad + 1))
    for g, key, f in zip(gs, keys, fs):
        t = Tracer()
        tracing.attach(t)
        try:
            w = parac.factorize_wavefront(g, key, **kw)
        finally:
            tracing.detach()
        for k in ("col_ptr", "rows", "vals", "D"):
            assert np.array_equal(_bits(getattr(w, k)), _bits(getattr(f, k)))
        spans = sorted(t.layer_spans(), key=lambda s: s.start)
        up = [s.attrs["edges_uploaded"] for s in spans
              if s.name == "parac.pools"]
        assert up == [g.m] + [0] * (len(up) - 1) and len(up) > 1
        assert {s.attrs["h2d_bytes"] for s in spans
                if s.name == "parac.init"} == {h2d[-1]}
