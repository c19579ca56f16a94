"""The port's solve cluster against the reference package on the CPU:
the routing policies' choices and the adaptive selector's picks on the
same seeded states and call sequences, one sequential rr trace through
both packages' clusters (one reference run, in a module fixture: each
request's replica, iterations and x, and the deterministic
``ClusterStats`` counters), and ``launch/top.py``'s reading of the
cluster's Prometheus scrape."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes, and a cluster adds threads of its own
torch.set_num_threads(1)
import jax                                                     # noqa: E402

from repro.data import graphs as jgraphs                       # noqa: E402
from repro.serve import SolveCluster as JCluster               # noqa: E402
from repro.serve import cluster as jcluster                    # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.data import graphs                            # noqa: E402
from repro_torch.serve import AdaptiveSelector, SolveCluster   # noqa: E402
from repro_torch.serve.cluster import make_routing             # noqa: E402

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


@pytest.mark.parametrize("name", ["rr", "p2c", "affinity"])
def test_routing_choices_match_reference(name):
    """Over 200 seeded routing states (loads, capacity probes, holder
    and pending subsets) each policy picks the replica the reference's
    picks."""
    rng = np.random.default_rng(4)
    ours, ref = make_routing(name, seed=3), jcluster.make_routing(name,
                                                                  seed=3)
    for _ in range(200):
        k = int(rng.integers(1, 6))
        stubs = [_Stub(i, load=int(rng.integers(0, 4)),
                       handles=int(rng.integers(0, 3)),
                       free_rows=int(rng.integers(0, 3)),
                       free_handles=(None if rng.random() < 0.5
                                     else int(rng.integers(0, 3))),
                       free_bytes=(None if rng.random() < 0.5
                                   else int(rng.integers(0, 2)) << 20))
                 for i in range(k)]
        holders = [s for s in stubs if rng.random() < 0.3]
        pending = [s for s in stubs
                   if s not in holders and rng.random() < 0.3]
        a = ours.choose("g", holders, stubs, pending)
        b = ref.choose("g", holders, stubs, pending)
        assert a.index == b.index


def test_selector_picks_match_reference():
    """The same families, seed and sequence of pick / observe /
    quarantine calls give the same picks and the same counters and
    estimates as the reference's selector."""
    fams = ("ac", "ichol", "amg", "spai")
    ours = AdaptiveSelector(fams, epsilon=0.3, seed=5)
    ref = jcluster.AdaptiveSelector(fams, epsilon=0.3, seed=5)
    rng = np.random.default_rng(6)
    for _ in range(400):
        gid = str(rng.choice(["a", "b", "c"]))
        op = rng.random()
        if op < 0.5:
            dl = None if rng.random() < 0.5 else float(rng.uniform(0, 1))
            assert ours.pick(gid, deadline_s=dl) == \
                ref.pick(gid, deadline_s=dl)
        elif op < 0.95:
            kw = dict(wall_s=float(rng.uniform(0, 2)),
                      serve_s=(None if rng.random() < 0.2
                               else float(rng.uniform(0, 1))),
                      construct_s=(None if rng.random() < 0.7
                                   else float(rng.uniform(0, 5))),
                      iters=int(rng.integers(1, 300)),
                      ok=bool(rng.random() < 0.9),
                      deadline_ok=bool(rng.random() < 0.8))
            fam = str(rng.choice(fams))
            ours.observe(gid, fam, **kw)
            ref.observe(gid, fam, **kw)
        else:
            fam = str(rng.choice(fams))
            ours.quarantine(gid, fam)
            ref.quarantine(gid, fam)
    assert ours.stats() == ref.stats()


# ---------------------------------------------------------------------------
# Parity: a sequential rr trace through both packages' clusters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rr_trace(gset):
    """The mixed trace, one request at a time with each result awaited,
    through a 2-replica rr cluster with one factor replica — once in the
    reference package, once in the port (same graphs, keys, rhs)."""
    rng = np.random.default_rng(11)
    blocks = [(gid, _rhs(rng, gset[gid].n, nr), tol)
              for gid, nr, tol in SPEC]
    jcl = JCluster(replicas=2, factor_replicas=1, routing="rr", slots=4,
                   iters_per_tick=8, cache_kw=CACHE_KW)
    try:
        for i, (name, g) in enumerate(_gset(jgraphs).items()):
            jcl.register(g, jax.random.key(i), graph_id=name)
        jdone = [jcl.submit(gid, b, tol=tol, maxiter=400).result(timeout=600)
                 for gid, b, tol in blocks]
        jst = jcl.stats()
    finally:
        jcl.close()
    with _cluster(gset, routing="rr", factor_replicas=1) as cl:
        done = [cl.submit(gid, b, tol=tol, maxiter=400).result(timeout=600)
                for gid, b, tol in blocks]
        direct = [_direct(cl, r, b) for r, (_, b, _) in zip(done, blocks)]
        st = cl.stats()
    return jdone, jst, done, direct, st


def test_rr_trace_matches_reference_cluster(rr_trace):
    jdone, _, done, direct, _ = rr_trace
    for jr, r, ref in zip(jdone, done, direct):
        assert r.status == jr.status == "converged"
        assert r.replica == jr.replica
        assert np.array_equal(np.atleast_1d(r.iters),
                              np.atleast_1d(np.asarray(jr.iters)))
        xj = np.atleast_2d(np.asarray(jr.x))
        err = np.linalg.norm(np.atleast_2d(r.x) - xj, axis=1) \
            / np.linalg.norm(xj, axis=1)
        assert err.max() <= 1e-4
        _assert_bitwise(r, ref)


def test_rr_trace_cluster_stats_match_reference(rr_trace):
    _, jst, _, _, st = rr_trace
    for f in ("submitted", "routed", "affinity_hits", "affinity_misses",
              "replications", "shed", "adoptions", "factor_dedups"):
        assert getattr(st, f) == getattr(jst, f), f
    assert [r.routed for r in st.per_replica] == \
        [r.routed for r in jst.per_replica]
    for f in ("coalesced_factorizations", "enqueued", "adoptions", "dedups"):
        assert st.factor_tier[f] == jst.factor_tier[f], f
    assert st.affinity_misses == 6 and st.affinity_hits == 2



def test_top_reads_the_cluster_scrape(gset, tmp_path):
    """``launch/top.py`` over the port cluster's Prometheus render: the
    affinity hit rate and completions it reads are the cluster's, and it
    summarizes the text exactly as the reference's ``top`` does."""
    import io
    from repro.launch import top as jtop
    from repro_torch.launch import top
    from repro_torch.obs import MetricsRegistry, render
    reg = MetricsRegistry()
    with _cluster(gset, metrics=reg) as cl:
        rng = np.random.default_rng(8)
        for g in ("road", "road", "g2d", "road"):
            cl.submit(g, _rhs(rng, gset[g].n), tol=1e-5,
                      maxiter=300).result(timeout=300)
        st = cl.stats()
        text = render(reg)
    info = top.summarize_endpoint(top.parse_prom(text))
    assert info["hit_rate"] == pytest.approx(st.hit_rate)
    assert info["completed"] == {"converged": 4.0}
    assert info == jtop.summarize_endpoint(jtop.parse_prom(text))
    path = tmp_path / "scrape.prom"
    path.write_text(text)
    buf = io.StringIO()
    assert top.once([str(path)], out=buf) == 0
    assert "affinity" in buf.getvalue()
