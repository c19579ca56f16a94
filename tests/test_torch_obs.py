"""The port's copy of the observability package (``repro_torch.obs``):
the engine-free cases of the reference's observability and flight
recorder tests, run against the port's modules, and one parity case —
the same seeded updates into the reference's registry and the port's
render byte-identical Prometheus text."""
import json
import re
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.obs import (
    CardinalityError, DEFAULT_LATENCY_BUCKETS_S, FlightRecorder,
    HealthMonitor, MetricsRegistry, MetricsServer, NULL, NULL_FLIGHT,
    SustainedThresholdDetector, percentile, quantile_from_counts, render,
    trace_from_request)
from repro_torch.obs.prometheus import CONTENT_TYPE

_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_labeled(text):
    """``{metric: [(labels dict, value)]}`` from exposition text."""
    out = {}
    for line in text.splitlines():
        m = _SAMPLE.match(line.strip())
        if not m or line.startswith("#"):
            continue
        name, raw, val = m.groups()
        out.setdefault(name, []).append(
            (dict(_LABEL.findall(raw or "")), float(val)))
    return out


def test_concurrent_counter_and_histogram_updates():
    """N threads hammering one counter child and one histogram child
    must not lose updates: inc is a lock-guarded read-modify-write
    (bare += loses under GIL preemption)."""
    reg = MetricsRegistry()
    c = reg.counter("t_total", "test counter")
    h = reg.histogram("t_seconds", "test histogram")
    n_threads, per_thread = 8, 2000

    def work(k):
        for i in range(per_thread):
            c.inc()
            h.observe((k * per_thread + i) % 7 * 1e-4)

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n_threads * per_thread
    total, _, counts = h._default.snapshot()
    assert total == n_threads * per_thread
    assert sum(counts) == total


def test_labeled_children_are_cached_and_checked():
    reg = MetricsRegistry()
    c = reg.counter("by_replica_total", "per replica", ("replica",))
    assert c.labels(replica="0") is c.labels(replica=0)   # str-keyed
    c.labels(replica="0").inc(3)
    assert c.labels(replica="0").value == 3
    with pytest.raises(ValueError):
        c.labels(shard="0")                # wrong label name


def test_cardinality_cap_raises():
    """Past the cap, labels() raises instead of leaking series — an
    unbounded label value (request id) must fail at the call site."""
    reg = MetricsRegistry()
    c = reg.counter("capped_total", "capped", ("rid",), max_series=8)
    for i in range(8):
        c.labels(rid=i).inc()
    with pytest.raises(CardinalityError):
        c.labels(rid="one-too-many")


def test_registry_idempotent_and_kind_checked():
    reg = MetricsRegistry()
    a = reg.counter("dup_total")
    assert reg.counter("dup_total") is a
    with pytest.raises(ValueError):
        reg.gauge("dup_total")


def test_windowed_rate_gauge_stats_and_quantile():
    """The ring answers the three questions the detector and reports
    ask: counter rate, gauge stats, and histogram quantile — windowed
    via explicit, injected timestamps."""
    reg = MetricsRegistry()
    c = reg.counter("arrivals_total")
    g = reg.gauge("depth")
    h = reg.histogram("lat_seconds")
    for i in range(11):                       # t = 0..10, 2 arrivals/s
        c.inc(2)
        g.set(float(i))
        h.observe(0.01 if i < 8 else 1.0)
        reg.sample(now=float(i))
    assert reg.rate("arrivals_total", window_s=5.0, now=10.0) == \
        pytest.approx(2.0)
    st = reg.gauge_stats("depth", window_s=4.0, now=10.0)
    assert st["n"] == 5 and st["max"] == 10.0
    assert st["mean"] == pytest.approx(8.0)
    # windowed quantile sees only the last 3 (slow) observations
    q = reg.quantile("lat_seconds", 0.5, window_s=3.0, now=10.0)
    assert 0.5 < q <= 1.58                    # in the ~1 s bucket
    # lifetime quantile is dominated by the 8 fast observations
    assert reg.quantile("lat_seconds", 0.5) < 0.1


def test_null_registry_is_inert():
    c = NULL.counter("x_total")
    c.inc()
    c.labels(anything="goes").observe(1.0)    # no schema, no error
    assert c.value == 0.0
    assert NULL.rate("x_total", window_s=1.0) == 0.0


def test_quantile_from_counts_and_percentile_agree():
    rng = np.random.default_rng(0)
    xs = rng.exponential(0.02, size=2000)
    counts = [0] * (len(DEFAULT_LATENCY_BUCKETS_S) + 1)
    from repro_torch.obs import bucket_index
    for x in xs:
        counts[bucket_index(DEFAULT_LATENCY_BUCKETS_S, x)] += 1
    exact = percentile(xs, 95)
    est = quantile_from_counts(DEFAULT_LATENCY_BUCKETS_S, counts, 0.95)
    # bucket resolution is ~1.58x: the estimate lands within one ratio
    assert exact / 1.6 <= est <= exact * 1.6


_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [0-9.eE+-]+(?:inf)?$")


def _parse_prom(text):
    """Minimal exposition-format check: every non-comment line is
    ``name{labels} value``; returns {sample_name: [(labels, value)]}."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        assert _LINE.match(line), f"malformed exposition line: {line!r}"
        head, val = line.rsplit(" ", 1)
        name = head.split("{", 1)[0]
        out.setdefault(name, []).append((head, float(val)))
    return out


def test_render_round_trips_as_prometheus_text():
    reg = MetricsRegistry()
    reg.counter("req_total", "requests", ("replica", "status")) \
        .labels(replica=0, status='conv"erged\\').inc(5)
    reg.gauge("depth", "queue depth").set(3)
    h = reg.histogram("lat_seconds", "latency")
    for v in (1e-4, 2e-3, 0.5):
        h.observe(v)
    text = render(reg)
    assert "# HELP req_total requests" in text
    assert "# TYPE lat_seconds histogram" in text
    samples = _parse_prom(text)
    assert samples["req_total"][0][1] == 5.0
    assert '\\"' in samples["req_total"][0][0]      # label escaping
    assert samples["depth"][0][1] == 3.0
    # cumulative buckets, monotone, +Inf == _count == 3
    buckets = [v for _, v in samples["lat_seconds_bucket"]]
    assert buckets == sorted(buckets) and buckets[-1] == 3.0
    assert any(head.endswith('le="+Inf"} 3') or 'le="+Inf"' in head
               for head, _ in samples["lat_seconds_bucket"])
    assert samples["lat_seconds_count"][0][1] == 3.0
    assert samples["lat_seconds_sum"][0][1] == pytest.approx(0.5021)


def test_metrics_server_scrape():
    reg = MetricsRegistry()
    reg.counter("scrape_total").inc(7)
    with MetricsServer(reg, port=0, host="127.0.0.1") as srv:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=5) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == CONTENT_TYPE
            body = resp.read().decode()
        assert _parse_prom(body)["scrape_total"][0][1] == 7.0
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/nope", timeout=5)


def test_metrics_server_fixed_port_replay_and_idempotent_close():
    """Back-to-back runs on a fixed ``--metrics-port`` (the replay
    workflow) must rebind immediately — SO_REUSEADDR, not a TIME_WAIT
    stall — and ``close`` must be callable from both a finally block
    and an exit handler without raising."""
    import socket
    reg = MetricsRegistry()
    reg.counter("replay_total").inc(3)
    with socket.socket() as s:                 # reserve a concrete port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for _ in range(2):                         # run, close, run again
        srv = MetricsServer(reg, port=port, host="127.0.0.1")
        assert srv.port == port
        url = f"http://127.0.0.1:{port}/metrics"
        with urllib.request.urlopen(url, timeout=5) as resp:
            body = resp.read().decode()
        assert _parse_prom(body)["replay_total"][0][1] == 3.0
        srv.close()
        srv.close()                            # idempotent second close
    # closed for real: the port no longer answers
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url, timeout=1)


def test_trace_partition_sums_to_e2e_synthetic():
    class R:
        rid = 1
        graph_id = "g"
        status = "converged"
        submit_time = 10.0
        admit_time = 10.5
        finish_time = 11.0
        first_tick_time = 10.6
        route_s = 0.1
        factor_wait_s = 0.2
        factor_mode = "adopt"
        iters = np.array([4, 9])
        nrhs = 2
        replica = 3

    tr = trace_from_request(R())
    names = [s.name for s in tr.spans]
    assert names == ["route", "adopt", "queue", "first_tick", "solve"]
    # contiguous partition: each span starts where the previous ended
    for a, b in zip(tr.spans, tr.spans[1:]):
        assert b.start == pytest.approx(a.end)
    assert tr.span_sum_s == pytest.approx(tr.e2e_s)
    assert tr.e2e_s == pytest.approx(1.0)
    assert tr.attrs["iters"] == 9 and tr.replica == 3


def test_trace_skips_unpaid_stages_and_unfinished_requests():
    class Warm:
        rid = 2
        graph_id = "g"
        status = "converged"
        submit_time = 5.0
        admit_time = 5.0
        finish_time = 5.4
        first_tick_time = 0.0
        route_s = 0.0
        factor_wait_s = 0.0
        factor_mode = ""
        iters = None
        nrhs = 1
        replica = -1

    tr = trace_from_request(Warm())
    assert [s.name for s in tr.spans] == ["solve"]
    assert tr.span_sum_s == pytest.approx(0.4)

    class Unfinished(Warm):
        finish_time = 0.0

    assert trace_from_request(Unfinished()) is None


def _feed(reg, det, depths, *, t0=0.0, dt=0.1):
    g = reg.gauge("repro_cluster_queue_depth")
    c = reg.counter("repro_cluster_arrivals_total")
    t = t0
    for d in depths:
        g.set(d)
        c.inc(max(d, 0))
        reg.sample(now=t)
        det.update(t)
        t += dt
    return t


def test_detector_flags_sustained_burst_and_cools():
    reg = MetricsRegistry()
    # sustain/cool sit strictly between sample-spacing multiples so
    # float accumulation of the 0.1 s feed steps can't straddle them
    det = SustainedThresholdDetector(
        reg, high_queue=8.0, low_queue=2.0, window_s=0.5,
        sustain_s=0.25, cool_s=0.25, idle_down_s=1.95)
    t = _feed(reg, det, [0, 1, 0, 1])                 # stationary: quiet
    assert det.state == "ok" and det.transitions == 0
    t = _feed(reg, det, [20, 25, 30, 25, 20, 25], t0=t)   # the storm
    assert det.state == "overloaded"
    assert det.recommendation == "scale_up"
    t = _feed(reg, det, [0] * 10, t0=t)               # drains + cools
    assert det.state == "ok" and det.transitions == 2
    # long idle flips the recommendation to scale_down
    _feed(reg, det, [0] * 25, t0=t)
    assert det.recommendation == "scale_down"
    st = det.stats()
    assert st["detector"] == "sustained_threshold"
    assert st["updates"] == det.updates


def test_detector_ignores_single_spike():
    """Hysteresis: one hot sample inside a quiet stream neither trips
    the detector nor leaves residue (the windowed mean absorbs it)."""
    reg = MetricsRegistry()
    det = SustainedThresholdDetector(
        reg, high_queue=8.0, low_queue=2.0, window_s=0.5,
        sustain_s=0.3, cool_s=0.3)
    _feed(reg, det, [0, 1, 30, 1, 0, 1, 0, 1, 0, 1])
    assert det.state == "ok" and det.transitions == 0


def test_detector_validates_hysteresis_band():
    with pytest.raises(ValueError):
        SustainedThresholdDetector(MetricsRegistry(), high_queue=2.0,
                                   low_queue=2.0)


def _read_dump(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def test_ring_bounds_memory_and_counts_drops():
    fl = FlightRecorder(capacity=4)
    ev = fl.bind("admit", replica=0)
    for i in range(10):
        ev(rid=i)
    evs = fl.events()
    assert len(evs) == 4                      # bounded: oldest fell off
    assert [e["rid"] for e in evs] == [6, 7, 8, 9]
    st = fl.stats()
    assert st["recorded"] == 10 and st["dropped"] == 6
    assert fl.events(last=2)[0]["rid"] == 8


def test_bound_event_merges_static_and_call_fields():
    fl = FlightRecorder()
    fl.bind("retire", replica=3, component="engine")(
        rid=7, trace_id="t000001", status="converged")
    (e,) = fl.events()
    assert e["kind"] == "retire" and e["replica"] == 3
    assert e["component"] == "engine" and e["rid"] == 7
    assert e["trace_id"] == "t000001"
    assert e["seq"] == 1 and isinstance(e["t"], float)


def test_null_flight_is_inert():
    NULL_FLIGHT.bind("admit", replica=0)(rid=1)
    NULL_FLIGHT.record("retire", rid=1)
    NULL_FLIGHT.incident("whatever")
    assert NULL_FLIGHT.dump("whatever") is None
    assert NULL_FLIGHT.events() == []
    assert NULL_FLIGHT.stats()["recorded"] == 0
    assert NULL_FLIGHT.flush() is True


def test_concurrent_recording_loses_nothing_and_tears_nothing():
    """8 threads x 2000 bound-event records: every event lands exactly
    once (unique, gapless seqs) and every event carries both its static
    and per-call fields — no lost updates, no torn dicts."""
    n_threads, per_thread = 8, 2000
    fl = FlightRecorder(capacity=n_threads * per_thread)
    evs = [fl.bind("admit", thread=k) for k in range(n_threads)]

    def work(k):
        for i in range(per_thread):
            evs[k](i=i, trace_id=f"t{k}:{i}")

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = fl.stats()
    assert st["recorded"] == n_threads * per_thread
    assert st["dropped"] == 0
    out = fl.events()
    assert len(out) == n_threads * per_thread
    assert sorted(e["seq"] for e in out) == \
        list(range(1, n_threads * per_thread + 1))
    seen = set()
    for e in out:
        assert e["kind"] == "admit"
        assert e["trace_id"] == f"t{e['thread']}:{e['i']}"   # not torn
        seen.add((e["thread"], e["i"]))
    assert len(seen) == n_threads * per_thread               # not lost


def test_sync_dump_writes_parseable_jsonl_with_context(tmp_path):
    reg = MetricsRegistry()
    reg.counter("repro_engine_ticks_total").inc(5)
    fl = FlightRecorder(postmortem_dir=str(tmp_path))
    fl.attach(stats_fn=lambda: {"routed": 12}, registry=reg)
    fl.bind("admit", replica=0)(rid=1, trace_id="t000001")
    fl.bind("retire", replica=0)(rid=1, trace_id="t000001",
                                 status="converged")
    path = fl.dump("bug report!", note="manual")
    assert path.endswith("postmortem-001-bug_report_.jsonl")
    lines = _read_dump(path)
    head = lines[0]
    assert head["type"] == "incident" and head["reason"] == "bug report!"
    assert head["context"] == {"note": "manual"}
    assert head["recorder"]["recorded"] == 2
    events = [ln for ln in lines if ln["type"] == "event"]
    assert [e["kind"] for e in events] == ["admit", "retire"]
    assert all(e["trace_id"] == "t000001" for e in events)
    (cs,) = [ln for ln in lines if ln["type"] == "cluster_stats"]
    assert cs["stats"] == {"routed": 12}
    (ms,) = [ln for ln in lines if ln["type"] == "metrics"]
    assert ms["series"]["repro_engine_ticks_total"][""] == 5.0
    assert path in fl.stats()["dump_paths"]


def test_incident_dumps_are_capped_but_explicit_dumps_are_not(tmp_path):
    fl = FlightRecorder(postmortem_dir=str(tmp_path), max_dumps=2)
    for i in range(4):
        fl.incident(f"crash_{i}")
    assert fl.flush(timeout=10)
    st = fl.stats()
    assert st["incidents"] == 4 and st["dumps"] == 2   # cap held
    assert len(st["dump_paths"]) == 2
    path = fl.dump("post_cap")                          # explicit: uncapped
    assert path is not None and _read_dump(path)[0]["reason"] == "post_cap"


def test_no_postmortem_dir_records_but_never_dumps():
    fl = FlightRecorder()
    fl.incident("driver_crash", replica=0)
    assert fl.flush(timeout=5)
    st = fl.stats()
    assert st["incidents"] == 1 and st["dumps"] == 0
    # the incident itself still landed in the ring
    assert fl.events()[-1]["kind"] == "incident"
    assert fl.dump("nope") is None


def test_slo_miss_streak_raises_incident_and_resets(tmp_path):
    fl = FlightRecorder(postmortem_dir=str(tmp_path), slo_miss_streak=3)
    retire = fl.bind("retire", replica=0)
    retire(rid=0, status="deadline_missed")
    retire(rid=1, status="deadline_missed")
    retire(rid=2, status="converged")          # streak resets
    assert fl.stats()["incidents"] == 0
    for rid in (3, 4, 5):
        retire(rid=rid, status="deadline_missed")
    assert fl.flush(timeout=10)
    st = fl.stats()
    assert st["incidents"] == 1 and st["dumps"] == 1
    lines = _read_dump(st["dump_paths"][0])
    assert lines[0]["reason"] == "slo_miss_streak"
    assert lines[0]["context"] == {"streak": 3}
    # the dump's trailing events reconstruct the losing streak
    misses = [ln for ln in lines if ln["type"] == "event"
              and ln.get("status") == "deadline_missed"]
    assert len(misses) == 5


def test_flight_gauges_exported_through_registry():
    reg = MetricsRegistry()
    fl = FlightRecorder()
    fl.attach(registry=reg)
    fl.attach(registry=reg)                    # idempotent re-attach
    fl.bind("admit")(rid=0)
    fl.incident("boom")
    text = render(reg)
    assert "repro_flight_events 2" in text     # admit + incident event
    assert "repro_flight_incidents 1" in text
    assert "repro_flight_dumps 0" in text


def test_drift_detector_latches_quarantines_and_records_flight_event():
    reg = MetricsRegistry()
    fl = FlightRecorder()
    fired = []
    hm = HealthMonitor(reg, min_samples=3, flight=fl,
                       on_quarantine=lambda g, f: fired.append((g, f)))
    for it in (10, 10, 30):                   # fast EWMA jumps past 1.5x
        hm.observe_retirement(gid="mesh", family="amg", iters=it,
                              relres=1e-7, status="converged")
    assert fired == [("mesh", "amg")]
    snap = hm.snapshot()
    assert snap["drifting"] == ["mesh::amg"] and snap["quarantines"] == 1
    assert snap["families"]["amg"]["drifting"] == 1
    (drift_ev,) = [e for e in fl.events() if e["kind"] == "health_drift"]
    assert drift_ev["gid"] == "mesh" and drift_ev["family"] == "amg"
    assert drift_ev["efficiency"] > 1.5
    # latched: further degradation does not re-fire the quarantine
    hm.observe_retirement(gid="mesh", family="amg", iters=50,
                          relres=1e-7, status="converged")
    assert fired == [("mesh", "amg")] and hm.snapshot()["quarantines"] == 1
    text = render(reg)
    assert 'repro_health_quarantines_total{family="amg"} 1' in text
    assert 'repro_health_drift{family="amg"} 1' in text


def test_health_streaks_track_worst_graph_and_reset():
    hm = HealthMonitor(MetricsRegistry(), min_samples=100)
    for _ in range(3):
        hm.observe_retirement(gid="g", family="ac", iters=None,
                              relres=None, status="maxiter")
    hm.observe_retirement(gid="h", family="ac", iters=5, relres=1e-6,
                          status="converged", deadline_missed=True)
    fam = hm.snapshot()["families"]["ac"]
    assert fam["max_maxiter_streak"] == 3
    assert fam["max_deadline_miss_streak"] == 1
    hm.observe_retirement(gid="g", family="ac", iters=4, relres=1e-6,
                          status="converged")
    assert hm.snapshot()["families"]["ac"]["max_maxiter_streak"] == 0


def test_quarantine_callback_exception_never_escapes():
    hm = HealthMonitor(min_samples=2,
                       on_quarantine=lambda g, f: 1 / 0)
    for it in (10, 40):
        hm.observe_retirement(gid="g", family="ac", iters=it,
                              relres=1e-6, status="converged")
    assert hm.snapshot()["quarantines"] == 1   # fired, exception swallowed


def test_fleet_gauges_collect_from_engine_and_cache_watermark():
    reg = MetricsRegistry()
    hm = HealthMonitor(reg)
    lane = SimpleNamespace(req=SimpleNamespace(
        _handle=SimpleNamespace(n=40, n_pad=64)))
    eng = SimpleNamespace(
        _buckets={("ac", 64, 4): SimpleNamespace(n_active=2)},
        lanes=[lane, None])
    bytes_now = [1000.0]
    cache = SimpleNamespace(stats=lambda: {
        "fleet_device_bytes_by_device": {"dev0": bytes_now[0]}})
    hm.watch_engine(eng)
    hm.watch_cache(cache)
    samples = _parse_labeled(render(reg))
    (labels, v) = samples["repro_fleet_lane_occupancy"][0]
    assert labels == {"family": "ac", "n_pad": "64", "k_tier": "4"}
    assert v == 2.0
    assert samples["repro_fleet_sweep_waste_ratio"][0][1] == \
        pytest.approx(1.0 - 40 / 64)
    assert samples["repro_fleet_bytes_watermark"][0][1] == 1000.0
    bytes_now[0] = 10.0                        # watermark never regresses
    samples = _parse_labeled(render(reg))
    assert samples["repro_fleet_bytes_watermark"][0][1] == 1000.0
    assert hm.snapshot()["fleet_bytes_watermark"] == {"dev0": 1000.0}


def _seeded_updates(obs, seed):
    """One seeded sequence of counter, gauge and histogram updates (with
    label sets and time-series samples) into a fresh registry of the
    ``obs`` package given."""
    rng = np.random.default_rng(seed)
    reg = obs.MetricsRegistry()
    c = reg.counter("repro_engine_completed_total", "requests retired",
                    labels=("replica", "status"))
    g = reg.gauge("repro_engine_queue_depth", "requests waiting",
                  labels=("replica",))
    h = reg.histogram("repro_engine_latency_seconds", "latency",
                      labels=("replica",))
    plain = reg.histogram("repro_engine_tick_seconds", "tick wall")
    for step in range(200):
        rep = str(int(rng.integers(0, 3)))
        status = ("converged", "maxiter", 'dead"line\\missed')[
            int(rng.integers(0, 3))]
        c.labels(replica=rep, status=status).inc(float(rng.integers(1, 4)))
        g.labels(replica=rep).set(float(rng.normal()))
        h.labels(replica=rep).observe(float(rng.exponential(0.05)))
        plain.observe(float(rng.uniform(0.0, 2.0)))
        if step % 20 == 0:
            reg.sample(now=float(step))
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_render_matches_reference_byte_for_byte(seed):
    import repro.obs as ref_obs
    import repro_torch.obs as port_obs
    ref = ref_obs.render(_seeded_updates(ref_obs, seed))
    port = port_obs.render(_seeded_updates(port_obs, seed))
    assert port == ref
    assert "repro_engine_completed_total" in port
