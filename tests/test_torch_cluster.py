"""The port's solve cluster on the CPU: the routing-policy units on stubs,
the cache probes the router rides on, served requests bit for bit equal
to a direct ``handle.solve`` on the serving replica (affinity and rr),
affinity's hit rate over rr on skewed traffic, hot-factor replication and
TTL demotion, health ejection, re-admission and shedding, ``auto`` over
the registered families, device pinning to ``torch.device``\\ s, the
cluster launcher and exact launch counts under threads.  Parity with the
reference package is in ``test_torch_cluster_parity.py``."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes, and a cluster adds threads of its own
torch.set_num_threads(1)

from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.core.solver import FactorCache                # noqa: E402
from repro_torch.data import graphs                            # noqa: E402
from repro_torch.kernels import runtime                        # noqa: E402
from repro_torch.serve import (                                # noqa: E402
    ClusterOverloadedError, SolveCluster, SolveEngine, SolveRequest)
from repro_torch.serve.cluster import (                        # noqa: E402
    FactorAffinityRouting, LeastLoadedRouting, RoundRobinRouting,
    make_routing, resolve_devices)

CACHE_KW = dict(chunk=32, fill_slack=64, strict=False)
# (graph, nrhs, tol) of the mixed trace: every graph, blocks and single
# columns, three tolerances
SPEC = [("g2d", 1, 1e-6), ("pl", 2, 1e-5), ("road", 1, 1e-6),
        ("g2d", 3, 1e-6), ("pl", 1, 1e-6), ("road", 2, 1e-5),
        ("g2d", 1, 1e-4), ("pl", 2, 1e-6)]


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
    kw.setdefault("slots", 4)
    kw.setdefault("iters_per_tick", 8)
    kw.setdefault("cache_kw", CACHE_KW)
    kw.setdefault("devices", "cpu")
    cl = SolveCluster(**kw)
    for i, (name, g) in enumerate(gset.items()):
        cl.register(g, key_from_seed(i), graph_id=name)
    return cl


def _direct(cl, req, b):
    """The request's rhs solved directly on the replica that served it."""
    h = cl.replicas[req.replica].cache.get(req.graph_id)
    return h.solve(torch.from_numpy(np.atleast_2d(b)), tol=req.tol,
                   maxiter=req.maxiter)


def _assert_bitwise(req, ref):
    assert np.array_equal(np.atleast_2d(req.x).view(np.uint32),
                          ref.x.numpy().view(np.uint32))
    assert np.array_equal(np.atleast_1d(req.iters), ref.iters.numpy())
    assert np.array_equal(np.atleast_1d(req.relres),
                          ref.relres.numpy().astype(np.float64))


# ---------------------------------------------------------------------------
# Core cache probes (the read-only surface the router rides on)
# ---------------------------------------------------------------------------

def test_cache_fresh_and_capacity_probe(gset):
    now = [0.0]
    c = FactorCache(clock=lambda: now[0], max_handles=4, device="cpu",
                    **CACHE_KW)
    c.factor(gset["road"], key_from_seed(0), graph_id="road", ttl_s=5.0)
    assert c.fresh("road") and not c.fresh("nope")
    p = c.capacity_probe()
    assert p["handles"] == 1 and p["free_handles"] == 3
    assert p["free_bytes"] is None          # no byte budget set
    assert p["device_bytes"] > 0
    now[0] = 6.0                            # past the TTL
    assert not c.fresh("road")
    assert "road" in c                      # fresh() never sweeps
    c.sweep_stale()
    assert "road" not in c                  # the sweep does


# ---------------------------------------------------------------------------
# Routing policies: unit semantics over stub replicas
# ---------------------------------------------------------------------------

class _Stub:
    def __init__(self, index, load=0, handles=0, free_rows=0,
                 free_handles=None, free_bytes=None):
        self.index = index
        self.load = load
        self._p = dict(handles=handles, free_handles=free_handles,
                       device_bytes=0, free_bytes=free_bytes,
                       fleet_free_rows=free_rows)

    def capacity_probe(self):
        return self._p


def test_round_robin_cycles_and_ignores_state():
    p = RoundRobinRouting()
    a, b = _Stub(0, load=100), _Stub(1, load=0)
    picks = [p.choose("g", [b], [a, b]).index for _ in range(4)]
    assert picks == [0, 1, 0, 1]            # blind to holders and load


def test_p2c_prefers_lower_load():
    p = LeastLoadedRouting(seed=0)
    a, b = _Stub(0, load=9), _Stub(1, load=1)
    assert p.choose("g", [], [a, b]) is b   # 2 candidates: plain min
    c = _Stub(2, load=5)
    picks = {p.choose("g", [], [a, b, c]).index for _ in range(20)}
    assert 0 not in picks                   # the loaded one never wins p2c


def test_affinity_prefers_holders_then_capacity():
    p = FactorAffinityRouting()
    a, b = _Stub(0, load=7), _Stub(1, load=2)
    assert p.choose("g", [a], [a, b]) is a  # holder beats lighter load
    assert p.choose("g", [a, b], [a, b]) is b   # holders tie-break: load
    roomy = _Stub(2, handles=0, free_rows=3)
    full = _Stub(3, handles=5)
    assert p.choose("g", [], [full, roomy]) is roomy   # miss: capacity
    assert make_routing("affinity").name == "affinity"
    with pytest.raises(ValueError):
        make_routing("random")


def test_auto_selects_among_registered_families_only(gset):
    """``precond="auto"`` chooses among the registered families — AC
    alone in the port — and a family that is not registered is refused."""
    with _cluster(gset, precond="auto", select_epsilon=1.0) as cl:
        assert cl.selector.families == ("ac",)
        rng = np.random.default_rng(2)
        for _ in range(3):
            r = cl.submit("road", _rhs(rng, gset["road"].n), tol=1e-5,
                          maxiter=300).result(timeout=120)
            assert r.status == "converged" and r.graph_id == "road"
        sel = cl.stats().selector
        assert sel["picks_by_family"] == {"ac": 3}
    with pytest.raises(ValueError):
        SolveCluster(precond="ichol", devices="cpu")


# ---------------------------------------------------------------------------
# Acceptance: cluster serving is bit-exact with direct per-replica solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("routing", ["affinity", "rr"])
def test_cluster_bit_exact_mixed_trace(gset, routing):
    """The mixed 3-graph trace routed through a 2-replica cluster (any
    policy) yields per-request x/iters/relres identical to a direct
    ``handle.solve`` on whichever replica served each request."""
    rng = np.random.default_rng(11)
    blocks = [(gid, _rhs(rng, gset[gid].n, nr), tol)
              for gid, nr, tol in SPEC]
    with _cluster(gset, routing=routing) as cl:
        futs = [cl.submit(gid, b, tol=tol, maxiter=400)
                for gid, b, tol in blocks]
        done = [f.result(timeout=300) for f in futs]
        assert cl.drain(timeout=120)
        served = {r.replica for r in done}
        assert served <= {0, 1} and len(served) == 2   # both replicas
        for (gid, b, tol), req in zip(blocks, done):
            assert req.status == "converged" and req.replica >= 0
            _assert_bitwise(req, _direct(cl, req, b))
        st = cl.stats()
        assert st.submitted == st.routed == len(SPEC) and st.shed == 0
        assert st.affinity_hits + st.affinity_misses == st.routed


def test_affinity_hit_rate_beats_rr_on_skewed_traffic(gset):
    """Skewed traffic (one hot graph): affinity pays one placement per
    graph; rr keeps landing graphs on replicas that don't hold them."""
    hit_rates = {}
    for routing in ("affinity", "rr"):
        rng = np.random.default_rng(7)
        gids = ["g2d", "road", "pl"]
        picks = [gids[i] for i in rng.choice(3, size=18, p=[.7, .2, .1])]
        with _cluster(gset, routing=routing) as cl:
            futs = [cl.submit(g, _rhs(rng, gset[g].n), tol=1e-4,
                              maxiter=300) for g in picks]
            for f in futs:
                f.result(timeout=300)
            st = cl.stats()
            hit_rates[routing] = st.hit_rate
            assert st.routed == len(picks)
    assert hit_rates["affinity"] > hit_rates["rr"]


# ---------------------------------------------------------------------------
# Hot-factor replication and TTL demotion
# ---------------------------------------------------------------------------

def test_hot_factor_replication_splits_then_demotes(gset):
    """A graph crossing the replication threshold is factored onto a
    second replica (TTL'd), traffic splits across both copies while it
    is hot, and the TTL expiry demotes the copy via the cache's own
    staleness sweep."""
    now = [0.0]
    with _cluster(gset, routing="affinity", replicate_above=3.0,
                  rate_window_s=1.0, replica_ttl_s=5.0,
                  clock=lambda: now[0]) as cl:
        rng = np.random.default_rng(5)
        n = gset["road"].n
        futs = [cl.submit("road", _rhs(rng, n), tol=1e-30, maxiter=100)
                for _ in range(8)]
        for f in futs:
            f.result(timeout=300)
        assert cl.stats().replications >= 1    # promoted to a 2nd replica
        for _ in range(600):                   # the twin lands async
            if any(rep.fresh("road") for rep in cl.replicas[1:]):
                break
            time.sleep(0.05)
        assert any(rep.fresh("road") for rep in cl.replicas[1:])
        futs = [cl.submit("road", _rhs(rng, n), tol=1e-30, maxiter=100)
                for _ in range(6)]
        served = {f.result(timeout=300).replica for f in futs}
        assert served == {0, 1}                # traffic actually split
        st = cl.stats()
        assert st.hot_graphs == 1
        assert sum(r.placements for r in st.per_replica) == 2
        now[0] = 10.0                          # past the copy's TTL
        cl.submit("road", _rhs(rng, n), tol=1e-4,
                  maxiter=300).result(timeout=300)
        st = cl.stats()
        assert st.demotions >= 1 and st.hot_graphs == 0


# ---------------------------------------------------------------------------
# Health: ejection, re-admission, shed
# ---------------------------------------------------------------------------

def test_dead_replica_ejected_and_rerouted(gset):
    with _cluster(gset, routing="affinity") as cl:
        rng = np.random.default_rng(3)
        n = gset["road"].n
        first = cl.submit("road", _rhs(rng, n), tol=1e-4,
                          maxiter=300).result(timeout=300)
        cl.replicas[first.replica].frontend.close(drain=True)  # wedge it
        second = cl.submit("road", _rhs(rng, n), tol=1e-4,
                           maxiter=300).result(timeout=300)
        assert second.replica != first.replica
        assert second.status == "converged"
        st = cl.stats()
        assert st.ejections == 1 and st.healthy == 1
        assert st.readmissions == 0            # dead drivers stay out


def test_overload_ejection_and_readmission(gset):
    """Backpressure rejections inside the health window eject a replica
    for the cooldown; it re-admits after (injected clock)."""
    now = [0.0]
    cl = _cluster(gset, routing="affinity", replicas=2, slots=1,
                  max_queue=1, overload="reject", eject_rejections=1,
                  health_window_s=1.0, readmit_cooldown_s=2.0,
                  clock=lambda: now[0])
    try:
        rng = np.random.default_rng(9)
        n = gset["road"].n
        # a blocker pins replica 0's only lane; the next submit fills
        # its 1-deep queue, the one after rejects -> instant ejection
        blocker = cl.submit("road", _rhs(rng, n), tol=1e-30, maxiter=4000)
        futs = [blocker]
        ejected = False
        for _ in range(6):
            futs.append(cl.submit("road", _rhs(rng, n), tol=1e-4,
                                  maxiter=300))
            if cl.stats().ejections >= 1:
                ejected = True
                break
        assert ejected
        assert cl.stats().healthy == 1         # replica 0 in cooldown
        futs[-1].result(timeout=300)
        spill = cl.submit("road", _rhs(rng, n), tol=1e-4, maxiter=300)
        assert spill.result(timeout=300).status == "converged"
        now[0] = 5.0                           # past the cooldown
        st = cl.stats()
        assert st.healthy == 2                 # routable again (pure read)
        assert st.readmissions == 0            # ...but stats never advances
        cl.submit("road", _rhs(rng, n), tol=1e-4,
                  maxiter=300).result(timeout=300)
        st = cl.stats()                        # a route re-admitted it
        assert st.healthy == 2 and st.readmissions == 1
    finally:
        cl.close(drain=False)


def test_all_replicas_down_sheds_with_cluster_overload(gset):
    with _cluster(gset, replicas=2) as cl:
        for rep in cl.replicas:
            rep.frontend.close(drain=True)
        rng = np.random.default_rng(1)
        with pytest.raises(ClusterOverloadedError):
            cl.submit("road", _rhs(rng, gset["road"].n))
        st = cl.stats()
        assert st.shed == 1 and st.healthy == 0
        assert st.submitted == st.routed + st.shed


def test_unregistered_graph_raises_keyerror_and_counts_shed(gset):
    with _cluster(gset) as cl:
        with pytest.raises(KeyError):
            cl.submit("mystery", np.zeros(8, np.float32))
        st = cl.stats()
        assert st.submitted == st.routed + st.shed == 1  # conservation
        assert not cl.router.placements                  # no stray entry


def test_routed_request_survives_eviction_before_engine_submit(gset):
    """A factor evicted between the router's freshness snapshot and the
    driver-side engine submit must not fail the request: the replica pins
    the routed handle on the request and the engine falls back to it."""
    c = FactorCache(device="cpu", **CACHE_KW)
    g = gset["road"]
    c.factor(g, key_from_seed(0), graph_id="road")
    eng = SolveEngine(c, slots=2, iters_per_tick=8)
    rng = np.random.default_rng(17)
    req = SolveRequest(rid=0, graph_id="road", b=_rhs(rng, g.n),
                       tol=1e-4, maxiter=300)
    req._handle = c.peek("road")     # what EngineReplica.submit does
    c.evict("road")                  # TTL sweep / LRU between route+submit
    eng.submit(req)
    done = eng.run_until_drained()
    assert done == [req] and req.status == "converged"


# ---------------------------------------------------------------------------
# Device pinning: torch.device specs and where the state reports it lives
# ---------------------------------------------------------------------------

def test_resolve_devices_spec_forms():
    cpu = torch.device("cpu")
    assert resolve_devices("cpu", 3) == [cpu] * 3
    assert resolve_devices("cpu, cpu", 3) == [cpu] * 3
    assert resolve_devices([cpu, "cpu"], 2) == [cpu, cpu]
    assert resolve_devices(cpu, 1) == [cpu]
    with pytest.raises(ValueError):
        resolve_devices("", 2)
    n_cuda = torch.cuda.device_count()
    if n_cuda == 0:
        # no silent CPU: no spec and no card raises, and so does a card
        # that is not there
        with pytest.raises(RuntimeError):
            resolve_devices(None, 2)
        with pytest.raises(RuntimeError):
            SolveCluster(replicas=1)
        for spec in ("0", [0], "cuda:0", "cuda"):
            with pytest.raises(ValueError):
                resolve_devices(spec, 2)
    else:
        want = [torch.device("cuda", i % n_cuda) for i in range(3)]
        assert resolve_devices(None, 3) == want
        assert resolve_devices("cuda", 1) == [torch.device("cuda", 0)]
        assert resolve_devices([0], 2) == [torch.device("cuda", 0)] * 2


def test_cluster_device_strings_in_stats(gset):
    """``devices="cpu,cpu,cpu"``: two solve replicas and a factor replica
    on the CPU; every device string the stats report is ``"cpu"``, the
    fleet bytes live there, and one bucket steps under one signature."""
    two = {k: gset[k] for k in ("g2d", "road")}          # n = 36: one bucket
    with _cluster(two, factor_replicas=1, devices="cpu,cpu,cpu") as cl:
        rng = np.random.default_rng(0)
        for name, g in two.items():
            b = _rhs(rng, g.n)
            r = cl.submit(name, b, tol=1e-6, maxiter=300).result(timeout=300)
            assert r.status == "converged"
            _assert_bitwise(r, _direct(cl, r, b))
        assert cl.drain(timeout=120)
        st = cl.stats()
        assert st.factor_tier["per_replica"][0]["device"] == "cpu"
        assert st.adoptions == 2
        # the second cold graph goes to the roomier replica: both serve
        for rep, rs in zip(cl.replicas, st.per_replica):
            assert rs.device == "cpu" and str(rep.device) == "cpu"
            assert rs.cache["device"] == "cpu" and rs.routed == 1
            bydev = rs.cache["fleet_device_bytes_by_device"]
            assert set(bydev) == {"cpu"} and bydev["cpu"] > 0
            es = rep.frontend.stats().engine
            assert es.step_compiles == es.buckets


# ---------------------------------------------------------------------------
# The launcher, and the launch counters under threads
# ---------------------------------------------------------------------------

def test_cluster_launcher_on_cpu(capsys, tmp_path):
    import json
    from repro_torch.launch import cluster as launcher
    out = tmp_path / "cluster.json"
    launcher.main(["--suite", "micro", "--requests", "6", "--device", "cpu",
                   "--factor-replicas", "1", "--json", str(out)])
    text = capsys.readouterr().out
    assert "served 6/6 requests" in text
    m = json.loads(out.read_text())
    assert m["completed"] == m["requests"] == 6
    assert m["cluster"]["submitted"] == m["cluster"]["routed"] == 6
    assert {r["device"] for r in m["cluster"]["per_replica"]} == {"cpu"}
    with pytest.raises(KeyError):
        launcher.main(["--suite", "micro", "--requests", "2", "--device",
                       "cpu", "--precond", "spai"])


def test_launch_counts_exact_under_threads():
    """Eight threads adding to one counter lose nothing; a reset zeroes
    every name."""
    name = "test_counter"
    runtime.reset_launches()
    start = threading.Barrier(8)

    def add():
        start.wait()
        for _ in range(20000):
            runtime.count_launch(name)

    threads = [threading.Thread(target=add) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert runtime.LAUNCHES[name] == 8 * 20000
    runtime.reset_launches()
    assert runtime.LAUNCHES[name] == 0
    del runtime.LAUNCHES[name]
