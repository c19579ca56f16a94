"""Layer spans (``repro_torch.obs.tracing``): the recorder, where the port's
stages open them, and what they record.  No test asserts a time: coverage
is checked as nesting (children inside their parent, one after another)."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)

from repro_torch.core import parac                             # noqa: E402
from repro_torch.core.column_math import key_from_seed         # noqa: E402
from repro_torch.core.solver import Solver                     # noqa: E402
from repro_torch.data import graphs                            # noqa: E402
from repro_torch.obs import tracing                            # noqa: E402
from repro_torch.obs.tracing import (NOOP_SPAN, SPAN_PREFIX,   # noqa: E402
                                     RequestTrace, Span, Tracer, span)
from repro_torch.serve import SolveEngine, SolveFrontend       # noqa: E402


@pytest.fixture
def tracer():
    t = Tracer()
    tracing.attach(t)
    yield t
    tracing.detach()


@pytest.fixture(scope="module")
def solver():
    """A cache holding grid2d 8x8's factor (``solver.h``)."""
    s = Solver(chunk=32, fill_slack=4, strict=True, device="cpu")
    s.h = s.factor(graphs.grid2d(8, 8, seed=1), key_from_seed(0))
    return s


def _rhs(n, k, seed=0):
    B = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)
    return torch.from_numpy(B - B.mean(axis=1, keepdims=True))


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.sid]


def _assert_tiles(spans, parent):
    """``parent``'s children lie inside it, on its thread, one after
    another; returns their names in order."""
    kids = sorted(_children(spans, parent), key=lambda s: s.start)
    assert kids
    for a, b in zip(kids, kids[1:]):
        assert a.end <= b.start
    for k in kids:
        assert parent.start <= k.start and k.end <= parent.end
        assert k.tid == parent.tid
    return [k.name for k in kids]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_detached_site_records_nothing_and_returns_the_noop(monkeypatch):
    """Detached (the default), a site is the shared no-op: no clock
    reading, no ``record_function``, no record anywhere; a whole factor
    and solve run through every site so."""
    class Trap:
        def __getattr__(self, name):
            raise AssertionError(f"detached span site touched {name}")

    monkeypatch.setattr(tracing, "time", Trap())
    monkeypatch.setattr(tracing, "_PROFILER", Trap())
    idle = Tracer()
    assert tracing._ACTIVE is None
    sp = span("parac.attempt")
    assert sp is NOOP_SPAN and not sp
    with sp as inner:
        inner.set(kept=1)
        assert inner is NOOP_SPAN
    h = Solver(chunk=32, fill_slack=1, strict=True, device="cpu").factor(
        graphs.grid2d(6, 6, seed=2), key_from_seed(1))
    assert bool(h.solve(_rhs(h.n, 2), tol=1e-5, maxiter=200).converged.all())
    assert idle.layer_spans() == [] and idle.spans_dropped == 0


def test_spans_nest_per_thread(tracer):
    """Each thread has its own stack: a span's parent is the span open on
    its own thread, whatever other threads have open."""
    gate = threading.Barrier(2)

    def work(tag):
        with span(f"outer.{tag}") as o:
            o.set(tag=tag)
            gate.wait()
            with span(f"inner.{tag}"):
                gate.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    spans = tracer.layer_spans()
    assert len(spans) == 4
    for tag, th in zip("ab", threads):
        (o,), (i,) = (_by_name(spans, f"{k}.{tag}") for k in ("outer",
                                                              "inner"))
        assert o.parent is None and i.parent == o.sid
        assert o.tid == i.tid == th.ident and o.attrs == {"tag": tag}
        assert o.start <= i.start <= i.end <= o.end
    assert len({s.sid for s in spans}) == 4


def test_span_store_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(tracing, "SPAN_CAPACITY", 2)
    t = Tracer()
    for k in range(3):
        with t.span("x", k=k):
            pass
    assert [s.attrs["k"] for s in t.layer_spans()] == [1, 2]
    assert t.spans_dropped == 1


def test_chrome_export_without_layer_spans_is_unchanged():
    """With no layer spans the export is the request rows alone, as
    before layer spans existed."""
    t = Tracer()
    t.record(RequestTrace(rid=3, graph_id="g", replica=1, status="ok",
                          spans=[Span("queue", 1.0, 1.5),
                                 Span("solve", 1.5, 2.0)],
                          attrs={"iters": 4}))
    args = {"rid": 3, "graph_id": "g", "trace_id": "", "family": "",
            "policy": "", "status": "ok", "device": "", "iters": 4}
    assert t.chrome_events() == [
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "replica 1"}},
        {"name": "queue", "ph": "X", "cat": "request", "pid": 1, "tid": 3,
         "ts": 0.0, "dur": 0.5e6, "args": args},
        {"name": "solve", "ph": "X", "cat": "request", "pid": 1, "tid": 3,
         "ts": 0.5e6, "dur": 0.5e6, "args": args}]
    assert Tracer().chrome_events() == []


def test_chrome_export_puts_layer_spans_on_thread_rows():
    t = Tracer()
    with t.span("engine.tick", stepped=1):
        with t.span("engine.step"):
            pass
    ev = t.chrome_events()
    layer = [e for e in ev if e.get("cat") == "layer"]
    assert [e["name"] for e in layer] == ["engine.step", "engine.tick"]
    assert {e["pid"] for e in layer} == {0}
    assert {e["tid"] for e in layer} == {threading.get_ident()}
    assert layer[1]["args"] == {"stepped": 1} and layer[1]["ts"] == 0.0
    names = {(e["name"], e["args"]["name"]) for e in ev if e["ph"] == "M"}
    assert ("process_name", "engine") in names
    assert ("thread_name", threading.current_thread().name) in names


# ---------------------------------------------------------------------------
# the factor: the strict ladder
# ---------------------------------------------------------------------------

G12 = dict(chunk=32, fill_slack=1, strict=True, max_retries=5,
           device="cpu")


def _ladder(spans):
    attempts = sorted(_by_name(spans, "parac.attempt"),
                      key=lambda s: s.start)
    for a in attempts:
        names = _assert_tiles(spans, a)
        assert names == ["parac.pools", "parac.init", "parac.rounds"] \
            + ["parac.finalize"] * a.attrs["kept"]
        rounds, = _by_name(_children(spans, a), "parac.rounds")
        checks = _children(spans, rounds)
        assert {c.name for c in checks} == {"parac.check"}
        assert len(checks) == -(-a.attrs["launched"] // 8)
        if a.attrs["kept"] < a.attrs["members"]:
            # a discarded member froze at its first dropped edge (``rounds``
            # is where the last one stopped); with none kept, the attempt
            # stopped within one check of it
            assert a.attrs["overflow"] > 0
            assert a.attrs["rounds"] <= a.attrs["launched"]
            if a.attrs["kept"] == 0:
                assert a.attrs["launched"] - a.attrs["rounds"] < 8
    return attempts


def _wavefront_rounds(g, key, prev):
    """The ``rounds`` of each rung of ``g``'s own ladder, from a tracer of
    its own (``prev`` is attached again after)."""
    t = Tracer()
    tracing.attach(t)
    try:
        parac.factorize_wavefront(g, key, **G12)
    finally:
        tracing.attach(prev)
    return [a.attrs["rounds"] for a in _ladder(t.layer_spans())]


@pytest.mark.parametrize("path", ["wavefront", "batched"])
def test_attempt_spans_match_the_ladder(tracer, path):
    """grid2d 12x12, key 7, needs slack 16 from 1; beside it in the fleet,
    key 0 needs 8 and a 4x4 grid 4: one attempt span per rung, slacks
    doubling, ``kept`` the members finalized there."""
    g12 = graphs.grid2d(12, 12, seed=3)
    if path == "wavefront":
        f = parac.factorize_wavefront(g12, key_from_seed(7), **G12)
        fs = [f]
    else:
        fs = parac.factorize_batched(
            [graphs.grid2d(4, 4, seed=0), g12, g12],
            [key_from_seed(0), key_from_seed(0), key_from_seed(7)], **G12)
    attempts = _ladder(tracer.layer_spans())
    assert [a.attrs["slack"] for a in attempts] == [1, 2, 4, 8, 16]
    assert [a.attrs["attempt"] for a in attempts] == list(range(5))
    kept = [a.attrs["kept"] for a in attempts]
    members = [a.attrs["members"] for a in attempts]
    assert sum(kept) == len(fs)
    assert members == [len(fs) - sum(kept[:k]) for k in range(5)]
    if path == "wavefront":
        assert kept == [0, 0, 0, 0, 1]
        last = attempts[-1].attrs
        assert last["rounds"] == f.stats["rounds"]
        assert last["overflow"] == f.stats["overflow"] == 0
    else:
        assert kept == [0, 0, 1, 1, 1]
        # each member kept in the rung of its own final slack
        assert sorted(f.stats["fill_slack"] for f in fs) == [4, 8, 16]
        for a in attempts:
            assert a.attrs["W"] >= 2
        # a rung's ``rounds`` is where its last discarded member froze, as
        # that member's own ladder has it, whatever its kept members ran
        own = [_wavefront_rounds(graphs.grid2d(4, 4, seed=0),
                                 key_from_seed(0), tracer),
               _wavefront_rounds(g12, key_from_seed(0), tracer),
               _wavefront_rounds(g12, key_from_seed(7), tracer)]
        for k, a in enumerate(attempts):
            dropped = [r[k] for r in own if len(r) > k + 1]
            assert a.attrs["rounds"] == max(
                dropped or [r[k] for r in own if len(r) > k])


def test_factor_children_tile_solver_factor(tracer):
    """``solver.factor`` holds the ladder's attempts then the admission
    (with its schedules), nothing else; a cache hit opens no span."""
    s = Solver(**G12)
    g = graphs.grid2d(12, 12, seed=3)
    s.factor(g, key_from_seed(7))
    s.factor(g, key_from_seed(7))
    spans = tracer.layer_spans()
    top, = _by_name(spans, "solver.factor")
    assert top.parent is None and top.attrs == {"members": 1,
                                                "family": "ac"}
    assert _assert_tiles(spans, top) == ["parac.attempt"] * 5 \
        + ["solver.admit"]
    admit, = _by_name(spans, "solver.admit")
    assert _assert_tiles(spans, admit) == ["trisolve.schedules"]


def test_fleet_factor_spans(tracer):
    """``factor_batched``: one ``solver.factor`` over the fleet's ladder,
    its schedules in one pass, then one admission."""
    c = Solver(**G12)
    g = graphs.grid2d(12, 12, seed=3)
    c.factor_batched([g, g], [key_from_seed(0), key_from_seed(7)])
    spans = tracer.layer_spans()
    top, = _by_name(spans, "solver.factor")
    assert top.attrs == {"members": 2, "family": "ac"}
    names = _assert_tiles(spans, top)
    assert names[-2:] == ["trisolve.schedules", "solver.admit"]
    assert set(names[:-2]) == {"parac.attempt"}
    assert sum(a.attrs["kept"] for a in _by_name(spans, "parac.attempt")) \
        == 2


# ---------------------------------------------------------------------------
# the solve and the served tick
# ---------------------------------------------------------------------------

def test_solve_children_tile_pcg_solve(tracer, solver):
    """``pcg.solve`` is its init, then a flag read before every
    iteration and one after the last; each iteration holds one apply."""
    res = solver.h.solve(_rhs(64, 3), tol=1e-5, maxiter=200)
    spans = tracer.layer_spans()
    top, = _by_name(spans, "pcg.solve")
    it = int(res.iters.max())
    assert top.attrs == {"lanes": 3, "iters": it}
    assert _assert_tiles(spans, top) == ["pcg.init"] \
        + ["pcg.check", "pcg.iter"] * it + ["pcg.check"]
    init, = _by_name(spans, "pcg.init")
    assert _assert_tiles(spans, init) == ["pcg.precondition"]
    for s in _by_name(spans, "pcg.iter"):
        assert _assert_tiles(spans, s) == ["pcg.precondition"]


def test_engine_spans_on_the_frontend_driver_thread(tracer, solver):
    """The engine's ticks record on the frontend's driver thread, the
    PCG's spans nested in each stepped bucket; the driver's waits, its
    ingress and its control calls beside them."""
    gid = solver.h.graph_id
    eng = SolveEngine(solver, slots=4, iters_per_tick=4)
    with SolveFrontend(eng) as fe:
        fe.call(lambda: None).result(timeout=60)
        futs = [fe.submit(gid, b, tol=1e-5, maxiter=200)
                for b in _rhs(64, 3, seed=1).numpy()]
        done = [f.result(timeout=120) for f in futs]
        thread = fe._thread.ident
    assert all(r.status == "converged" for r in done)
    spans = tracer.layer_spans()
    ticks = _by_name(spans, "engine.tick")
    assert ticks and {t.tid for t in ticks} == {thread}
    assert all(t.parent is None for t in ticks)
    assert sum(t.attrs["retired"] for t in ticks) == 3
    assert sum(t.attrs["admitted"] for t in ticks) == 3
    stepped = 0
    for t in ticks:
        names = _assert_tiles(spans, t)
        assert names[:2] == ["engine.resync", "engine.admit"]
        assert set(names[2:]) <= {"engine.step", "engine.flags",
                                  "engine.retire"}
        assert names.count("engine.step") == t.attrs["stepped"]
        stepped += t.attrs["stepped"]
    for s in _by_name(spans, "engine.step"):
        assert set(_assert_tiles(spans, s)) <= {"pcg.check", "pcg.iter"}
    for name in ("frontend.wait", "frontend.ingress", "frontend.control"):
        got = _by_name(spans, name)
        assert got and {s.tid for s in got} == {thread}, name
    assert stepped and len(_by_name(spans, "engine.step")) == stepped


def test_annotations_under_a_cpu_profiler(tracer, solver):
    """While a torch profiler session runs, each span is also a profiler
    annotation under the fixed prefix; outside one, none is opened."""
    from torch.profiler import ProfilerActivity, profile
    B = _rhs(64, 2, seed=2)
    solver.h.solve(B, tol=1e-5, maxiter=200)         # outside the session
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = solver.h.solve(B, tol=1e-5, maxiter=200)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith(SPAN_PREFIX)]
    it = int(res.iters.max())
    assert names.count(SPAN_PREFIX + "pcg.solve") == 1
    assert names.count(SPAN_PREFIX + "pcg.iter") == it
    assert names.count(SPAN_PREFIX + "pcg.check") == it + 1
    assert names.count(SPAN_PREFIX + "pcg.precondition") == it + 1
    assert len(_by_name(tracer.layer_spans(), "pcg.solve")) == 2
