"""The port's serving stack on the CPU: the engine against the reference
engine on one shared trace (one reference engine run, in a module
fixture), every served request bit for bit equal to a direct
``handle.solve`` inside the port (also across a fleet compaction), the
admission policies, deadline and ``maxiter`` statuses, the cache's TTL,
tick expiry, compaction and ``adopt``, the family registry, the async
frontend and the serve launcher."""
import asyncio
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.core.ref_ac import factorize_sequential as jseq     # noqa: E402
from repro.core.solver import FactorCache as JCache            # noqa: E402
from repro.data import graphs as jgraphs                       # noqa: E402
from repro.serve import SolveEngine as JEngine                 # noqa: E402
from repro.serve import SolveRequest as JRequest               # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.core.convert import factor_from_numpy         # noqa: E402
from repro_torch.core.solver import (                          # noqa: E402
    PRECOND_FAMILIES, FactorCache, get_family, register_family)
from repro_torch.data import graphs                            # noqa: E402
from repro_torch.obs import (FlightRecorder, MetricsRegistry,  # noqa: E402
                             Tracer, render)
from repro_torch.serve import (                                # noqa: E402
    DeadlineAdmission, EngineOverloadedError, FIFOAdmission,
    PriorityAdmission, SolveEngine, SolveFrontend, SolveRequest,
    make_policy)

CACHE_KW = dict(chunk=16, fill_slack=32)
# (graph, nrhs, tol) of the shared trace: both buckets, blocks and
# single columns, two tolerances
TRACE = [("grid2d_micro", 1, 1e-6), ("powerlaw_micro", 2, 1e-5),
         ("road_micro", 1, 1e-6), ("grid2d_micro", 3, 1e-4),
         ("powerlaw_micro", 1, 1e-6), ("road_micro", 2, 1e-5)]


def _rhs(rng, n, nrhs):
    b = rng.normal(size=(nrhs, n) if nrhs > 1 else n).astype(np.float32)
    return b - b.mean(axis=-1, keepdims=True)


def _blocks(sizes, seed=11):
    rng = np.random.default_rng(seed)
    return [(gid, _rhs(rng, sizes[gid], nr), tol) for gid, nr, tol in TRACE]


def _direct(cache, r):
    return cache.get(r.graph_id).solve(
        torch.from_numpy(np.atleast_2d(r.b)), tol=r.tol, maxiter=r.maxiter)


def _assert_bitwise(r, ref):
    assert np.array_equal(np.atleast_2d(r.x).view(np.uint32),
                          ref.x.numpy().view(np.uint32))
    assert np.array_equal(np.atleast_1d(r.iters), ref.iters.numpy())
    # the engine stores relres as Python floats (float64), each the
    # float32 it gathered: equal values are equal bits
    assert np.array_equal(np.atleast_1d(r.relres),
                          ref.relres.numpy().astype(np.float64))


@pytest.fixture(scope="module")
def micro():
    return {name: make() for name, make in graphs.SUITE_MICRO.items()}


@pytest.fixture(scope="module")
def cache(micro):
    c = FactorCache(device="cpu", **CACHE_KW)
    c.factor_batched(list(micro.values()),
                     [key_from_seed(i) for i in range(len(micro))],
                     graph_ids=list(micro))
    return c


@pytest.fixture(scope="module")
def shared_trace(micro, cache):
    """The trace served by the reference engine (once) and by the port's,
    same graphs, keys, engine shape and right-hand sides."""
    blocks = _blocks({k: g.n for k, g in micro.items()})
    jgs = {name: make() for name, make in jgraphs.SUITE_MICRO.items()}
    jc = JCache(**CACHE_KW)
    jc.factor_batched(list(jgs.values()),
                      [jax.random.key(i) for i in range(len(jgs))],
                      graph_ids=list(jgs))
    jeng = JEngine(jc, slots=4, iters_per_tick=8)
    jreqs = [JRequest(rid=i, graph_id=gid, b=b, tol=tol, maxiter=300)
             for i, (gid, b, tol) in enumerate(blocks)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    eng = SolveEngine(cache, slots=4, iters_per_tick=8)
    reqs = [SolveRequest(rid=i, graph_id=gid, b=b, tol=tol, maxiter=300)
            for i, (gid, b, tol) in enumerate(blocks)]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    return jreqs, jeng.stats(), reqs, eng, done


# ---------------------------------------------------------------------------
# The engine against the reference's, and against the port's direct solves
# ---------------------------------------------------------------------------

def test_engine_matches_reference_engine(shared_trace):
    jreqs, jstats, reqs, eng, done = shared_trace
    assert len(done) == len(reqs)
    for jr, r in zip(jreqs, reqs):
        assert r.status == jr.status == "converged"
        assert np.array_equal(np.atleast_1d(r.iters),
                              np.atleast_1d(np.asarray(jr.iters)))
        xj = np.atleast_2d(np.asarray(jr.x))
        err = np.linalg.norm(np.atleast_2d(r.x) - xj, axis=1) \
            / np.linalg.norm(xj, axis=1)
        assert err.max() <= 1e-4
    assert eng.stats().as_dict() == jstats.as_dict()


def test_served_requests_bitwise_equal_direct_solves(shared_trace, cache):
    _, _, reqs, eng, _ = shared_trace
    for r in reqs:
        _assert_bitwise(r, _direct(cache, r))
    st = eng.stats()
    assert st.step_compiles == st.buckets == 2
    assert st.cols_in == st.cols_out == sum(nr for _, nr, _ in TRACE)
    assert st.admitted_reqs == st.completed == len(reqs)


def test_engine_rejects_bad_requests_and_drains(cache, micro):
    eng = SolveEngine(cache, slots=2)
    n = micro["road_micro"].n
    with pytest.raises(KeyError):
        eng.submit(SolveRequest(rid=0, graph_id="nope", b=np.zeros(4)))
    with pytest.raises(ValueError):        # wider than the engine
        eng.submit(SolveRequest(rid=1, graph_id="road_micro",
                                b=np.zeros((3, n))))
    with pytest.raises(ValueError):        # wrong n
        eng.submit(SolveRequest(rid=2, graph_id="road_micro",
                                b=np.zeros(n + 1)))
    assert not eng._pinned
    zero = SolveRequest(rid=3, graph_id="road_micro",
                        b=np.zeros(n, np.float32))
    eng.submit(zero)
    assert eng.run_until_drained(max_ticks=3) == [zero]
    assert zero.converged and int(zero.iters[0]) == 0
    assert zero._handle is None and not eng.busy


def test_engine_records_metrics_traces_and_flight(cache, micro):
    """An instrumented run: one trace per request whose stage spans sum
    to its end-to-end latency, the completed counter in the rendered
    text, and admit/retire flight events joined by trace id."""
    reg, tracer, flight = MetricsRegistry(), Tracer(), FlightRecorder()
    eng = SolveEngine(cache, slots=4, iters_per_tick=8, metrics=reg,
                      tracer=tracer, flight=flight)
    reqs = [SolveRequest(rid=i, graph_id=gid, b=b, tol=tol, maxiter=300)
            for i, (gid, b, tol) in enumerate(
                _blocks({k: g.n for k, g in micro.items()}, seed=3))]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    traces = {tr.rid: tr for tr in tracer.traces()}
    assert len(traces) == len(done) == len(reqs)
    for r in done:
        tr = traces[r.rid]
        assert tr.family == "ac" and tr.policy == "fifo"
        assert tr.span_sum_s == pytest.approx(r.latency_s, rel=0.05)
    text = render(reg)
    total = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                if line.startswith("repro_engine_completed_total{"))
    assert total == len(reqs)
    evs = flight.events()
    admits = {e["trace_id"] for e in evs if e["kind"] == "admit"}
    retires = {e["trace_id"] for e in evs if e["kind"] == "retire"}
    assert admits == retires == {r.trace_id for r in reqs}


# ---------------------------------------------------------------------------
# Admission policies: pure unit semantics (no engine, no device)
# ---------------------------------------------------------------------------

def _fake(rid, nrhs, *, seq, priority=0, skips=0):
    """Policy-only request: admission reads nrhs/priority/_seq/skips."""
    r = SolveRequest(rid=rid, graph_id="x", b=np.zeros((nrhs, 4)),
                     priority=priority)
    r._seq = seq
    r.sched_skips = skips
    return r


def test_fifo_is_head_of_line_blocking():
    p = FIFOAdmission()
    wide = _fake(0, 4, seq=0)
    narrow = _fake(1, 1, seq=1)
    assert p.select([wide, narrow], 2, now=0.0) == []   # head blocks all
    assert narrow.sched_skips == 0 and p.backfill_skips == 0
    assert p.select([wide, narrow], 5, now=0.0) == [wide, narrow]
    assert p.max_skips == 0                              # FIFO never skips


def test_priority_orders_classes_before_arrival():
    p = PriorityAdmission(max_skips=4)
    late_urgent = _fake(0, 1, seq=5, priority=0)
    early_lazy = _fake(1, 1, seq=1, priority=5)
    assert p.select([early_lazy, late_urgent], 2, now=0.0) == \
        [late_urgent, early_lazy]


def test_backfill_skips_blocked_head_and_counts():
    p = PriorityAdmission(max_skips=3)
    wide = _fake(0, 4, seq=0)
    n1, n2 = _fake(1, 1, seq=1), _fake(2, 1, seq=2)
    assert p.select([wide, n1, n2], 2, now=0.0) == [n1, n2]
    assert wide.sched_skips == 1            # one skip *round*, not per req
    assert p.backfill_skips == 1 and p.skipped_reqs == 1


def test_starvation_bound_seals_queue_at_max_skips():
    p = PriorityAdmission(max_skips=2)
    wide = _fake(0, 4, seq=0)
    rounds_with_backfill = 0
    for i in range(6):                       # endless narrow stream
        if p.select([wide, _fake(10 + i, 1, seq=10 + i)], 2, now=0.0):
            rounds_with_backfill += 1
    assert rounds_with_backfill == 2 == wide.sched_skips == p.max_skips
    assert p.backfill_skips <= p.max_skips * p.skipped_reqs
    assert p.barrier_rounds == 4
    assert p.select([wide, _fake(99, 1, seq=99)], 4, now=0.0)[0] is wide


def test_deadline_policy_orders_edf():
    p = DeadlineAdmission(max_skips=2)
    assert p.evict_hopeless
    no_dl = _fake(0, 1, seq=0)
    soon = _fake(1, 1, seq=1)
    soon._deadline_abs = 5.0
    later = _fake(2, 1, seq=2)
    later._deadline_abs = 50.0
    assert p.select([no_dl, later, soon], 3, now=0.0) == \
        [soon, later, no_dl]


def test_make_policy_names():
    assert isinstance(make_policy("fifo"), FIFOAdmission)
    assert make_policy("priority", max_skips=7).max_skips == 7
    assert make_policy("deadline").name == "deadline"
    with pytest.raises(ValueError):
        make_policy("lifo")


def test_seal_backfill_admits_only_provably_short():
    p = PriorityAdmission(max_skips=1)
    wide = _fake(0, 3, seq=0, skips=1)          # already at its bound
    short = _fake(1, 1, seq=1)
    short.maxiter = 16                          # 2 ticks at ipt=8
    long_ = _fake(2, 1, seq=2)
    long_.maxiter = 300                         # 38 ticks
    take = p.select([wide, short, long_], 2, now=0.0,
                    busy_bounds=(10,), iters_per_tick=8)
    assert take == [short]
    assert p.sealed_backfills == 1
    assert p.backfill_skips == 0 and wide.sched_skips == 1
    p2 = PriorityAdmission(max_skips=1, work_conserving=False)
    assert p2.select([wide, short], 2, now=0.0, busy_bounds=(10,),
                     iters_per_tick=8) == []
    assert p2.sealed_backfills == 0


def test_engine_backfill_past_a_blocked_wide_head(cache, micro):
    """Engine level: with a priority policy, narrow requests ride the
    free lanes behind a wide head that does not fit yet; under FIFO they
    wait for it."""
    n = micro["road_micro"].n
    finish = {}
    for policy in ("fifo", "priority"):
        rng = np.random.default_rng(21)
        eng = SolveEngine(cache, slots=3, iters_per_tick=8,
                          admission=make_policy(policy, max_skips=8))
        blocker = SolveRequest(rid=0, graph_id="road_micro",
                               b=_rhs(rng, n, 1), tol=1e-30, maxiter=32)
        wide = SolveRequest(rid=1, graph_id="road_micro",
                            b=_rhs(rng, n, 3), tol=1e-4, maxiter=300)
        ns = [SolveRequest(rid=2 + i, graph_id="road_micro",
                           b=_rhs(rng, n, 1), tol=1e-3, maxiter=300)
              for i in range(2)]
        for r in (blocker, wide, *ns):
            eng.submit(r)
        assert len(eng.run_until_drained()) == 4
        st = eng.stats()
        assert st.admitted_reqs == st.completed == 4
        assert st.backfill_skips <= st.max_skips * max(st.skipped_reqs, 0)
        finish[policy] = [r.finish_tick for r in ns]
        if policy == "fifo":
            assert all(t > wide.admit_tick for t in finish["fifo"])
        else:
            assert all(t < wide.admit_tick for t in finish["priority"])
            assert wide.converged
    assert max(finish["priority"]) < min(finish["fifo"])


# ---------------------------------------------------------------------------
# Deadline eviction and maxiter status (injected clock)
# ---------------------------------------------------------------------------

def test_deadline_eviction_frees_slot_and_reports_missed(cache, micro):
    n = micro["road_micro"].n
    now = [0.0]
    eng = SolveEngine(cache, slots=1, iters_per_tick=4,
                      admission=make_policy("deadline"),
                      clock=lambda: now[0])
    rng = np.random.default_rng(41)
    hopeless = SolveRequest(rid=0, graph_id="road_micro", b=_rhs(rng, n, 1),
                            tol=1e-30, maxiter=10_000, deadline_s=5.0)
    follower = SolveRequest(rid=1, graph_id="road_micro", b=_rhs(rng, n, 1),
                            tol=1e-3, maxiter=300)
    eng.submit(hopeless)
    eng.submit(follower)
    assert eng.tick() == [] and not hopeless._evicted
    now[0] = 6.0                        # past the 5 s deadline
    assert eng.tick() == [hopeless]
    assert hopeless.status == "deadline_missed"
    assert not hopeless.converged and hopeless.x is not None
    assert int(hopeless.iters[0]) < 10_000
    assert eng.run_until_drained() == [follower]
    assert follower.status == "converged"
    st = eng.stats()
    assert st.deadline_evictions == 1
    assert st.admitted_reqs == st.completed == 2


def test_maxiter_and_met_deadline_statuses(cache, micro):
    n = micro["road_micro"].n
    rng = np.random.default_rng(44)
    eng = SolveEngine(cache, slots=2, iters_per_tick=8,
                      admission=make_policy("deadline"))
    capped = SolveRequest(rid=0, graph_id="road_micro", b=_rhs(rng, n, 1),
                          tol=1e-30, maxiter=16)
    met = SolveRequest(rid=1, graph_id="road_micro", b=_rhs(rng, n, 1),
                       tol=1e-4, maxiter=300, deadline_s=600.0)
    eng.submit(capped)
    eng.submit(met)
    eng.run_until_drained()
    assert capped.status == "maxiter" and not capped.converged
    assert int(capped.iters[0]) == 16
    assert met.status == "converged" and eng.deadline_evictions == 0
    _assert_bitwise(capped, _direct(cache, capped))


# ---------------------------------------------------------------------------
# FactorCache lifecycle: staleness, compaction, adopt, the registry
# ---------------------------------------------------------------------------

def test_factor_cache_ttl_and_tick_expiry(micro):
    now = [0.0]
    c = FactorCache(device="cpu", clock=lambda: now[0], **CACHE_KW)
    g, k = micro["road_micro"], key_from_seed(0)
    c.factor(g, k, graph_id="old", ttl_s=10.0)
    c.factor(micro["grid2d_micro"], k, graph_id="keep")   # immortal
    now[0] = 5.0
    h = c.factor(g, k, graph_id="old", ttl_s=10.0)       # hit, re-admitted
    assert c.hits == 1 and h.born_s == 5.0
    assert c.fresh("old") and c.peek("old") is h
    now[0] = 16.0
    assert not c.fresh("old")
    assert c.sweep_stale() == 1
    assert "old" not in c and "keep" in c
    assert c.stats()["expirations"] == 1
    # tick-driven expiry, advanced by an engine
    c.factor(g, k, graph_id="aging", max_age_ticks=3)
    eng = SolveEngine(c, slots=2, iters_per_tick=4)
    req = SolveRequest(rid=0, graph_id="aging",
                       b=_rhs(np.random.default_rng(23), g.n, 1),
                       tol=1e-6, maxiter=300)
    eng.submit(req)
    assert eng.run_until_drained() == [req] and req.converged
    assert c.now_ticks == eng.ticks
    if c.now_ticks <= 3:
        c.advance_ticks(4)
    with pytest.raises(KeyError):
        c.get("aging")
    assert c.stats()["expirations"] == 2


def test_compaction_mid_serve_is_bit_exact(micro):
    """Three factors of one graph in one fleet; the first two are
    evicted while the third serves, and the fleet compacts after each
    eviction (capacity 4 to 2 to 1; the third factor's row moves from 2
    to 0, below the index a free lane still holds from the first
    request).  The engine re-syncs its lanes once: the served results
    equal direct solves bit for bit, before and after."""
    g = micro["grid2d_micro"]
    flight = FlightRecorder()
    c = FactorCache(device="cpu", k_tiering=False, flight=flight,
                    **CACHE_KW)
    c.factor_batched([g] * 3, [key_from_seed(i) for i in range(3)],
                     graph_ids=["a", "b", "c"])
    h = c.get("c")
    fleet = h.fleet
    assert h.fleet_row == 2 and fleet.capacity == 4
    rng = np.random.default_rng(5)
    eng = SolveEngine(c, slots=2, iters_per_tick=2)
    first = SolveRequest(rid=0, graph_id="c", b=_rhs(rng, g.n, 2),
                         tol=1e-6, maxiter=300)
    eng.submit(first)
    eng.run_until_drained()
    _assert_bitwise(first, _direct(c, first))
    second = SolveRequest(rid=1, graph_id="c", b=_rhs(rng, g.n, 1),
                          tol=1e-6, maxiter=300)
    before = _direct(c, second)
    eng.submit(second)
    eng.tick()
    assert eng.busy                        # in flight across the compaction
    c.evict("a")
    c.evict("b")
    assert fleet.generation == 2 and h.fleet_row == 0
    assert fleet.capacity == 1 and c.stats()["compactions"] == 2
    assert [e["kind"] for e in flight.events()].count("compaction") == 2
    eng.run_until_drained()
    assert eng.stats().fleet_resyncs == 1
    _assert_bitwise(second, before)
    _assert_bitwise(second, _direct(c, second))
    assert c.stats()["fleet_device_bytes"] == c.stats()["fleet_live_bytes"]


def test_adopt_reference_factor_carries_state(micro):
    """A factor built by the reference package, carried across as numpy
    arrays, is adopted (no factor runs), solves as the reference's cache
    solves with it, and serves bit for bit as the port's direct solve."""
    jg = jgraphs.SUITE_MICRO["road_micro"]()
    g = micro["road_micro"]
    fj = jseq(jg, jax.random.key(3))
    f = factor_from_numpy(fj.col_ptr, fj.rows, fj.vals, fj.D)
    flight = FlightRecorder()
    c = FactorCache(device="cpu", flight=flight)
    h = c.adopt(g, f, graph_id="road", construct_s=1.5)
    assert c.adopt(g, f, graph_id="road") is h            # idempotent
    st = c.stats()
    assert st["adoptions"] == 1 and st["misses"] == 0 and st["hits"] == 1
    assert h.construct_s == 1.5
    (ev,) = [e for e in flight.events() if e["kind"] == "adopt"]
    assert ev["gid"] == "road" and ev["construct_s"] == 1.5
    assert np.array_equal(h.factor.vals.view(np.uint32),
                          np.asarray(fj.vals).view(np.uint32))
    b = _rhs(np.random.default_rng(8), g.n, 2)
    jc = JCache()
    jc.attach(jg, fj, graph_id="road")
    rj = jc.solve("road", jnp.asarray(b), tol=1e-6, maxiter=300)
    rt = c.solve("road", torch.from_numpy(b), tol=1e-6, maxiter=300)
    assert np.array_equal(np.asarray(rj.iters), rt.iters.numpy())
    xj = np.asarray(rj.x)
    assert np.linalg.norm(xj - rt.x.numpy()) <= 1e-4 * np.linalg.norm(xj)
    # the matvec through the fleet row is the graph's Laplacian
    from repro_torch.core.laplacian import laplacian_matvec_np
    x = np.random.default_rng(9).normal(size=g.n).astype(np.float32)
    assert np.allclose(h.matvec(torch.from_numpy(x)).numpy(),
                       laplacian_matvec_np(g, x.astype(np.float64)),
                       rtol=1e-5, atol=1e-5)
    eng = SolveEngine(c, slots=2)
    req = SolveRequest(rid=0, graph_id="road", b=b, tol=1e-6, maxiter=300)
    eng.submit(req)
    eng.run_until_drained()
    _assert_bitwise(req, _direct(c, req))


def test_family_registry_and_cache_probes(cache, micro):
    assert sorted(PRECOND_FAMILIES) == ["ac"]
    assert get_family("ac").kind == "factor"
    with pytest.raises(KeyError, match="unknown preconditioner family"):
        cache.factor(micro["road_micro"], key_from_seed(0), family="ichol")
    with pytest.raises(ValueError):
        register_family("bad", "dense", lambda g, key, **kw: None)
    probe = cache.capacity_probe()
    assert probe["handles"] == len(cache) == 3
    assert probe["free_bytes"] is None and probe["free_handles"] is None
    assert probe["fleet_free_rows"] == sum(f.free_rows
                                           for f in cache.fleets.values())
    st = cache.stats()
    assert set(st) == set(JCache().stats())
    assert st["fleet_device_bytes_by_device"] == {
        "cpu": st["fleet_device_bytes"]}
    assert all(f.resident_device == "cpu" for f in cache.fleets.values())
    spare = FactorCache(device="cpu", **CACHE_KW)
    spare.factor(micro["road_micro"], key_from_seed(0))
    spare.clear()
    assert len(spare) == 0


# ---------------------------------------------------------------------------
# SolveFrontend: async bit-exactness, backpressure, lifecycle, crashes
# ---------------------------------------------------------------------------

def test_frontend_async_bit_exact_vs_direct(cache, micro):
    blocks = _blocks({k: g.n for k, g in micro.items()}, seed=17)
    eng = SolveEngine(cache, slots=4, iters_per_tick=8)

    async def drive(fe):
        return await asyncio.gather(*[
            fe.solve(gid, b, tol=tol, maxiter=300) for gid, b, tol in blocks])

    with SolveFrontend(eng, max_queue=64) as fe:
        results = asyncio.run(drive(fe))
        fs = fe.stats()
    assert fs.submitted == fs.completed == len(blocks)
    assert fs.failed == 0 and fs.rejected == 0
    for req in results:
        assert req.status == "converged"
        _assert_bitwise(req, _direct(cache, req))
    st = eng.stats()
    assert st.cols_in == st.cols_out == sum(nr for _, nr, _ in TRACE)


def test_frontend_errors_backpressure_and_close(cache, micro):
    n = micro["road_micro"].n
    rng = np.random.default_rng(51)
    eng = SolveEngine(cache, slots=1, iters_per_tick=4)
    fe = SolveFrontend(eng, max_queue=2, overload="reject")
    try:
        with pytest.raises(KeyError):
            fe.submit("nope", np.zeros(4, np.float32)).result(timeout=30)
        with pytest.raises(ValueError):
            fe.submit("road_micro", np.zeros(7, np.float32)).result(
                timeout=30)
        futs = [fe.submit("road_micro", _rhs(rng, n, 1), tol=1e-30,
                          maxiter=64)]
        rejected = 0
        for _ in range(8):
            try:
                futs.append(fe.submit("road_micro", _rhs(rng, n, 1),
                                      tol=1e-3, maxiter=300))
            except EngineOverloadedError:
                rejected += 1
        assert rejected >= 1 and fe.stats().rejected == rejected
    finally:
        fe.close(drain=True, timeout=300)
    for f in futs:
        assert f.done() and f.result(timeout=0).x is not None
    fs = fe.stats()
    assert fs.failed == 2 and fs.completed == len(futs)
    assert fs.queue_depth == 0 and not fe.alive
    with pytest.raises(RuntimeError):
        fe.submit("road_micro", np.zeros(n, np.float32))


def test_frontend_call_runs_on_driver_thread(cache):
    eng = SolveEngine(cache, slots=2)
    with SolveFrontend(eng) as fe:
        ident = fe.call(lambda: threading.current_thread().name)
        assert ident.result(timeout=30) == "solve-frontend"

        def boom():
            raise ValueError("nope")
        with pytest.raises(ValueError):
            fe.call(boom).result(timeout=30)
        assert fe.alive
        assert fe.call(lambda: 42).result(timeout=30) == 42
    with pytest.raises(RuntimeError):
        fe.call(lambda: 0)


def test_frontend_close_nodrain_and_driver_crash(cache, micro):
    n = micro["road_micro"].n
    rng = np.random.default_rng(62)
    eng = SolveEngine(cache, slots=1, iters_per_tick=4)
    fe = SolveFrontend(eng, max_queue=64)
    blocker = fe.submit("road_micro", _rhs(rng, n, 1), tol=1e-30,
                        maxiter=40_000)
    queued = fe.submit("road_micro", _rhs(rng, n, 1), tol=1e-3)
    for _ in range(600):
        if eng.stats().in_flight_reqs >= 1:
            break
        time.sleep(0.01)
    fe.close(drain=False)
    for f in (blocker, queued):
        with pytest.raises(RuntimeError):
            f.result(timeout=30)
    # a wedged engine fails every pending future instead of hanging it
    eng = SolveEngine(cache, slots=1, iters_per_tick=4)
    fe = SolveFrontend(eng, max_queue=16)
    fut = fe.submit("road_micro", _rhs(rng, n, 1), tol=1e-30,
                    maxiter=40_000)
    eng._step_fn = None
    with pytest.raises(RuntimeError, match="driver crashed"):
        fut.result(timeout=60)
    assert not fe.alive and fe.driver_error is not None
    fe.close(drain=False)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sync", "async"])
def test_serve_launcher_on_cpu(capsys, tmp_path, mode):
    import json
    from repro_torch.launch import serve
    out = tmp_path / "m.json"
    argv = ["--suite", "micro", "--requests", "6", "--slots", "4",
            "--device", "cpu", "--policy", "deadline",
            "--deadline-ms", "600000", "--json", str(out)]
    serve.main(argv + (["--async"] if mode == "async" else []))
    text = capsys.readouterr().out
    assert f"mode={mode} policy=deadline precond=ac device=cpu" in text
    assert "served 6/6 requests" in text
    m = json.loads(out.read_text())
    assert m["converged"] == m["completed"] == 6
    assert m["engine"]["admitted_reqs"] == 6
    with pytest.raises(KeyError, match="unknown preconditioner family"):
        serve.main(["--suite", "micro", "--device", "cpu",
                    "--precond", "spai"])
