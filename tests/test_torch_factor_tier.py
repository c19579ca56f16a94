"""The port's factor tier on the CPU: serving through the adopt path bit
for bit equal to direct solves (affinity and rr), concurrent cold routes
riding one construction, burst coalescing and sibling dedup, the
coalescing window, adoption failover off a dead target, the frontend's
control-channel stats — and the tier's coalesced factors bit for bit
equal to the reference's ``factorize_batched`` on the same graphs and
keys."""
import concurrent.futures as cf
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes, and a cluster adds threads of its own
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.core.parac import factorize_batched as jbatched     # noqa: E402
from repro.data import graphs as jgraphs                       # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.core.solver import FactorCache                # noqa: E402
from repro_torch.data import graphs                            # noqa: E402
from repro_torch.serve import (                                # noqa: E402
    SolveCluster, SolveEngine, SolveFrontend)
import repro_torch.serve.cluster.factor_tier as ft             # noqa: E402

CACHE_KW = dict(chunk=32, fill_slack=64, strict=False)
CPU = torch.device("cpu")
NAMES = ["g2d", "road", "pl"]


def _gset(mod):
    return {"g2d": mod.grid2d(6, 6, seed=3),      # n = 36
            "road": mod.road_like(6, seed=4),     # n = 36
            "pl": mod.powerlaw(80, 4, seed=3)}    # n = 80


@pytest.fixture(scope="module")
def gset():
    return _gset(graphs)


def _rhs(rng, n, nrhs=1):
    b = rng.normal(size=(nrhs, n) if nrhs > 1 else n).astype(np.float32)
    return b - b.mean(axis=-1, keepdims=True)


def _cluster(gset, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("factor_replicas", 1)
    kw.setdefault("slots", 4)
    kw.setdefault("iters_per_tick", 8)
    kw.setdefault("cache_kw", CACHE_KW)
    kw.setdefault("devices", "cpu")
    cl = SolveCluster(**kw)
    for i, (name, g) in enumerate(gset.items()):
        cl.register(g, key_from_seed(i), graph_id=name)
    return cl


def _direct(cl, req, b):
    h = cl.replicas[req.replica].cache.get(req.graph_id)
    return h.solve(torch.from_numpy(np.atleast_2d(b)), tol=req.tol,
                   maxiter=req.maxiter)


def _assert_bitwise(req, ref):
    assert np.array_equal(np.atleast_2d(req.x).view(np.uint32),
                          ref.x.numpy().view(np.uint32))
    assert np.array_equal(np.atleast_1d(req.iters), ref.iters.numpy())
    assert np.array_equal(np.atleast_1d(req.relres),
                          ref.relres.numpy().astype(np.float64))


def _gated_tier(monkeypatch, **kw):
    """A one-worker CPU tier whose worker takes no batch until the
    returned event is set, so a test decides what is queued first."""
    gate = threading.Event()
    orig_take = ft.FactorTier._take_batch
    monkeypatch.setattr(ft.FactorTier, "_take_batch",
                        lambda self: (gate.wait(60), orig_take(self))[1])
    tier = ft.FactorTier(1, devices=[CPU], chunk=CACHE_KW["chunk"],
                         fill_slack=CACHE_KW["fill_slack"], strict=False,
                         **kw)
    return tier, gate


# ---------------------------------------------------------------------------
# Acceptance: serving through the factor-tier adopt path stays bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("routing", ["affinity", "rr"])
def test_tier_bit_exact_mixed_trace(gset, routing):
    """Every factor constructed on the tier and adopted across threads
    onto its serving replica; each request equals a direct
    ``handle.solve`` on that replica bit for bit."""
    rng = np.random.default_rng(11)
    spec = [("g2d", 1, 1e-6), ("pl", 2, 1e-5), ("road", 1, 1e-6),
            ("g2d", 3, 1e-6), ("pl", 1, 1e-6), ("road", 2, 1e-5)]
    blocks = [(gid, _rhs(rng, gset[gid].n, nr), tol)
              for gid, nr, tol in spec]
    with _cluster(gset, routing=routing) as cl:
        futs = [cl.submit(gid, b, tol=tol, maxiter=400)
                for gid, b, tol in blocks]
        done = [f.result(timeout=600) for f in futs]
        assert cl.drain(timeout=120)
        for (gid, b, tol), req in zip(blocks, done):
            assert req.status == "converged" and req.replica >= 0
            _assert_bitwise(req, _direct(cl, req, b))
        st = cl.stats()
        # the serving drivers never factored: every construction ran on
        # the tier and arrived by adoption
        tier = st.factor_tier
        factored = sum(w["factored"] for w in tier["per_replica"])
        assert factored == st.adoptions >= len(gset)
        assert all(r.cache["misses"] == 0 for r in st.per_replica)


def test_concurrent_cold_routes_ride_one_factorization(gset):
    N = 4
    rng = np.random.default_rng(3)
    b = _rhs(rng, gset["road"].n)
    with _cluster(gset, routing="affinity") as cl:
        with cf.ThreadPoolExecutor(max_workers=N) as pool:
            outer = [pool.submit(
                lambda: cl.submit("road", b, tol=1e-6,
                                  maxiter=300).result(timeout=600))
                for _ in range(N)]
            done = [f.result(timeout=600) for f in outer]
        st = cl.stats()
        tier = st.factor_tier
        assert tier["enqueued"] == 1                  # one construction
        assert sum(w["factored"] for w in tier["per_replica"]) == 1
        assert st.factor_dedups >= N - 1              # the rest rode it
        assert st.adoptions == 1
        assert len({np.asarray(r.x).tobytes() for r in done}) == 1
        assert all(r.status == "converged" for r in done)


def test_tier_coalesces_burst_and_dedups_siblings(gset, monkeypatch):
    """A burst of distinct cold graphs drains as one coalesced
    ``factorize_batched``; a duplicate placement id arriving while its
    job is queued becomes a sibling (one construction, two adoptions)."""
    tier, gate = _gated_tier(monkeypatch)
    rep = ft.EngineReplica(0, slots=4, cache_kw=CACHE_KW, device=CPU)
    try:
        futs = [tier.submit(n, gset[n], key_from_seed(i), target=rep)
                for i, n in enumerate(NAMES)]
        futs.append(tier.submit("pl", gset["pl"], key_from_seed(2),
                                target=rep))
        assert tier.queue_depth == 3      # dedup never lengthens queue
        gate.set()
        handles = [f.result(timeout=600) for f in futs]
        s = tier.stats()
        assert s["enqueued"] == 3 and s["dedups"] == 1
        assert s["adoptions"] == 4        # 3 jobs + 1 sibling adoption
        w = s["per_replica"][0]
        assert w["factored"] == 3 and w["batches"] == 1
        assert w["device"] == "cpu"
        assert s["coalesced_factorizations"] == 3
        assert s["factor_queue_depth"] == 0
        assert handles[2] is handles[3]   # the twin got the same handle
        assert rep.cache.adoptions == 3   # the sibling was a cache hit
    finally:
        tier.close()
        rep.close(drain=False)


def test_tier_factors_equal_reference_batched_factors(gset, monkeypatch):
    """The tier's one coalesced construction of the three graphs gives,
    per graph, the reference's ``factorize_batched`` factor bit for bit
    (col_ptr, rows, vals, D) under the same keys and parameters."""
    tier, gate = _gated_tier(monkeypatch)
    rep = ft.EngineReplica(0, slots=4, cache_kw=CACHE_KW, device=CPU)
    try:
        futs = [tier.submit(n, gset[n], key_from_seed(i), target=rep)
                for i, n in enumerate(NAMES)]
        gate.set()
        handles = [f.result(timeout=600) for f in futs]
        assert tier.stats()["coalesced_factorizations"] == 3
    finally:
        tier.close()
        rep.close(drain=False)
    jgs = _gset(jgraphs)
    jfs = jbatched([jgs[n] for n in NAMES],
                   jnp.stack([jax.random.key(i) for i in range(3)]),
                   chunk=CACHE_KW["chunk"],
                   fill_slack=CACHE_KW["fill_slack"], strict=False)
    for h, jf in zip(handles, jfs):
        f = h.factor
        for field in ("col_ptr", "rows", "vals", "D"):
            a = np.asarray(getattr(f, field))
            b = np.asarray(getattr(jf, field))
            assert a.shape == b.shape, field
            assert np.array_equal(a.view(np.uint8), b.astype(a.dtype)
                                  .view(np.uint8)), field


# ---------------------------------------------------------------------------
# Pending factor futures fail over off a dead target
# ---------------------------------------------------------------------------

def test_adoption_fails_over_when_target_dies_mid_factorization(
        gset, monkeypatch):
    """Crash the placement target while its construction is still on the
    tier: the finished payload re-targets to the healthy replica, the
    placement moves with it, and the request serves there bit for bit."""
    killed = threading.Event()
    real = ft.factorize_batched
    monkeypatch.setattr(
        ft, "factorize_batched",
        lambda *a, **kw: (killed.wait(60), real(*a, **kw))[1])
    rng = np.random.default_rng(5)
    b = _rhs(rng, gset["pl"].n)
    with _cluster(gset, routing="affinity") as cl:
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            outer = pool.submit(
                lambda: cl.submit("pl", b, tol=1e-6,
                                  maxiter=300).result(timeout=600))
            target = None
            for _ in range(600):
                with cl._lock:
                    pl = cl.router.placements.get("pl")
                    if pl:
                        target = next(iter(pl))
                        break
                time.sleep(0.01)
            assert target is not None
            cl.replicas[target].frontend.close(drain=False)
            killed.set()
            res = outer.result(timeout=600)
        survivor = 1 - target
        assert res.status == "converged" and res.replica == survivor
        st = cl.stats()
        assert st.factor_tier["failovers"] == 1
        assert st.ejections == 1
        with cl._lock:
            pl = dict(cl.router.placements["pl"])
        assert pl == {survivor: None}
        _assert_bitwise(res, _direct(cl, res, b))


# ---------------------------------------------------------------------------
# Control-channel stats measure the driver stall directly
# ---------------------------------------------------------------------------

def test_frontend_control_channel_stats(gset):
    eng = SolveEngine(FactorCache(device="cpu", **CACHE_KW), slots=2)
    with SolveFrontend(eng, max_queue=8) as fe:
        st = fe.stats()
        assert st.control_calls == 0 and st.control_s == 0.0
        assert st.factor_queue_depth == 0
        gate = fe.call(time.sleep, 0.05)      # holds the driver
        queued = fe.call(lambda: 7)           # waits behind it
        assert queued.result(timeout=30) == 7 and gate.result(timeout=30) \
            is None
        st = fe.stats()
        assert st.control_calls == 2
        assert st.control_s >= 0.05
        assert st.factor_queue_depth == 0     # drained
        assert st.as_dict()["control_s"] == st.control_s
    with _cluster(gset, factor_replicas=0) as cl:
        s = cl.stats().per_replica[0].frontend
        assert hasattr(s, "control_calls") and hasattr(s, "control_s")
