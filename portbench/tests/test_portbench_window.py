"""The end-to-end metrics are taken over the whole window: a time per
call is the window over the calls it holds, the last call started before
the deadline finishing inside it; a served request's latency runs from
its due time, so a stall on the submitting side counts."""
import time

import pytest

from portbench_small import harness, run_cell


def _slowed(monkeypatch, module, name, pause):
    real = getattr(module, name)

    def slow(*a, **kw):
        time.sleep(pause)
        return real(*a, **kw)
    monkeypatch.setattr(module, name, slow)


def _closed_loop(ctx, metric, span, last_started=1):
    """The metric is the window over its calls; the window ends with the
    last call, and the last ``last_started`` calls (a pass) began before
    the deadline only in their first."""
    (win,) = ctx.spans.of("window")
    calls = ctx.spans.of(span)
    assert ctx.e2e[metric] == pytest.approx((win.end - win.start)
                                            / len(calls))
    assert calls[-last_started].start < win.start + ctx.seconds <= win.end
    assert calls[-1].end == win.end
    return calls


def test_factor_s_is_the_window_over_its_calls(monkeypatch):
    """Calls run in whole passes over the key list: the pass in which the
    deadline falls is finished inside the window."""
    drv = harness.driver("factor_loop")
    _slowed(monkeypatch, drv, "_factor", 0.4)
    ctx, _ = run_cell("uniform64.factor", seconds=1.0)
    keys = len(ctx.traffic["keys"])
    calls = _closed_loop(ctx, "factor_s", "factor.call", last_started=keys)
    assert len(calls) % keys == 0
    deadline = ctx.spans.of("window")[0].start + ctx.seconds
    assert len(calls) == keys or calls[-keys - 1].end < deadline
    assert ctx.e2e["factor_s"] >= 0.4


def test_solve_s_is_the_window_over_its_calls():
    ctx, _ = run_cell("contrast64.solve8", seconds=1.0)
    calls = _closed_loop(ctx, "solve_s", "solve.call")
    assert ctx.attempted == 8 * len(calls)


def test_a_stalled_submission_counts_from_the_due_time(monkeypatch):
    """One submission held back 0.6 s: that request's latency, and every
    one due while it was held, include the stall, as does the
    generator's lag; the engine's own stamps (submit to finish) would
    not show it."""
    from repro_torch.serve import frontend
    real = frontend.SolveFrontend.submit_request
    held = {}

    def submit(self, req):
        if req.rid == 3 and not held:
            held[req.rid] = time.perf_counter()
            time.sleep(0.6)
        return real(self, req)
    monkeypatch.setattr(frontend.SolveFrontend, "submit_request", submit)
    ctx, line = run_cell("uniform64.serve", seconds=2.0, rate=4.0)
    assert line["correct"]
    lat = ctx.counters["latency_s"]
    lag = ctx.counters["generator_lag_s"]
    assert lag[3] >= 0.6 and lat[3] >= 0.6
    assert max(lag) == lag[3]
    assert ctx.e2e["latency_p95_ms"] >= 1e3 * sorted(lat)[
        int(0.95 * (len(lat) - 1))] - 1e-6
