"""Solve-cluster launcher: replay a seeded request trace through a
multi-replica :class:`repro_torch.serve.SolveCluster` and report routing
and latency numbers per policy — on the GPU unless told otherwise.

    PYTHONPATH=src python -m repro_torch.launch.cluster --suite tiny \
        --replicas 2 --routing affinity --requests 48 --skew 1.2 \
        --arrival-rate 100 --replicate-above 50
    PYTHONPATH=src python -m repro_torch.launch.cluster --suite micro \
        --device cpu                 # the plain PyTorch path on the CPU

The trace is the same seeded-Poisson mixed trace the single-engine
service replays (``repro_torch.launch.serve.make_trace``), optionally
**skewed** (Zipf-like graph choice) so one hot graph dominates — the
workload where factor-affinity routing and hot-factor replication pay.
Requests are *registered* with the cluster, never pre-factored: the
replay shows the cold-placement cost on first touch, the affinity-hit
economics after, and (with ``--replicate-above``) the hot graph being
promoted onto a second replica.

``--devices`` takes the torch form (``cuda:0,cuda:1``, card indices
``0,1`` or ``cpu``; fewer entries than replicas round-robin, so one card
hosts every replica), ``--device`` is the shorthand for one device for
all of them.  ``--precond`` names the preconditioner family; the port
registers ``ac`` only, so any other name (and ``auto``, which chooses
among the others) fails with the family registry's ``KeyError``.
"""
from __future__ import annotations

import argparse
import json
import time


def build_cluster(*, suite="tiny", replicas=2, routing="affinity",
                  slots=8, iters_per_tick=8, chunk=128, fill_slack=32,
                  policy="fifo", max_skips=None, max_queue=256,
                  overload="reject", replicate_above=None,
                  rate_window_s=1.0, replica_ttl_s=30.0,
                  precond="ac", select_epsilon=0.1, seed=0,
                  factor_replicas=0, devices=None,
                  metrics=None, tracer=None, detector=None,
                  flight=None, health=None):
    """Stand up the cluster and register (not factor) the suite graphs.
    Returns ``(cluster, sizes)`` with graph ids = suite names."""
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.solver import get_family
    from repro_torch.data import graphs
    from repro_torch.launch.serve import SMALL_NAMES
    from repro_torch.serve import SolveCluster

    if precond == "auto":
        # the adaptive selector chooses among every family: all must exist
        for fam in ("ichol", "amg", "spai"):
            get_family(fam)
    elif precond != "ac":
        get_family(precond)

    spec = graphs.SUITE_MICRO if suite == "micro" else \
        graphs.SUITE_TINY if suite == "tiny" else \
        {k: graphs.SUITE[k] for k in SMALL_NAMES}
    built = {name: make() for name, make in spec.items()}
    cluster = SolveCluster(
        replicas=replicas, routing=routing, slots=slots,
        iters_per_tick=iters_per_tick, admission=policy,
        max_skips=max_skips, max_queue=max_queue, overload=overload,
        replicate_above=replicate_above, rate_window_s=rate_window_s,
        replica_ttl_s=replica_ttl_s, precond=precond,
        select_epsilon=select_epsilon, seed=seed,
        factor_replicas=factor_replicas, devices=devices,
        metrics=metrics, tracer=tracer, detector=detector,
        flight=flight, health=health,
        cache_kw=dict(chunk=chunk, fill_slack=fill_slack, strict=False))
    for i, (name, g) in enumerate(built.items()):
        cluster.register(g, key_from_seed(i), graph_id=name)
    return cluster, {name: g.n for name, g in built.items()}


def replay_trace_cluster(cluster, trace):
    """Open-loop replay: submit each request at its ``arrival_s`` (the
    router runs in the submitting thread; replica driver threads do the
    serving), wait for all futures, return the shared service metrics
    plus routing counters.  Shed requests (ClusterOverloadedError) are
    dropped and counted, exactly like the frontend's reject mode."""
    import concurrent.futures
    from repro_torch.serve import ClusterOverloadedError
    from repro_torch.launch.serve import trace_metrics
    futs = []
    t0 = time.perf_counter()
    for req in trace:
        now = time.perf_counter() - t0
        if req.arrival_s > now:
            time.sleep(req.arrival_s - now)
        try:
            futs.append(cluster.submit_request(req))
        except ClusterOverloadedError:
            pass                       # shed: counted in ClusterStats
    concurrent.futures.wait(futs)
    t_serve = time.perf_counter() - t0
    done = [f.result() for f in futs if f.exception() is None]
    metrics = trace_metrics(trace, done, t_serve)
    cs = cluster.stats()
    metrics["cluster"] = cs.as_dict()
    metrics["per_replica_completed"] = {
        r.index: r.frontend.completed for r in cs.per_replica}
    return metrics, done


def run_cluster(*, suite="tiny", requests=48, replicas=2,
                routing="affinity", slots=8, iters_per_tick=8,
                max_nrhs=4, chunk=128, seed=0, skew=None,
                arrival_rate=None, policy="fifo", max_skips=None,
                max_queue=256, overload="reject", replicate_above=None,
                rate_window_s=1.0, replica_ttl_s=30.0,
                precond="ac", select_epsilon=0.1, deadline_ms=None,
                factor_replicas=0, devices=None,
                metrics=None, tracer=None, detector=None,
                flight=None, health=None):
    """Build the cluster, replay one trace, close, return metrics."""
    from repro_torch.launch.serve import make_trace
    cluster, sizes = build_cluster(
        suite=suite, replicas=replicas, routing=routing, slots=slots,
        iters_per_tick=iters_per_tick, chunk=chunk, policy=policy,
        max_skips=max_skips, max_queue=max_queue, overload=overload,
        replicate_above=replicate_above, rate_window_s=rate_window_s,
        replica_ttl_s=replica_ttl_s, precond=precond,
        select_epsilon=select_epsilon, seed=seed,
        factor_replicas=factor_replicas, devices=devices,
        metrics=metrics, tracer=tracer, detector=detector,
        flight=flight, health=health)
    gids = list(sizes)
    trace = make_trace(gids, sizes, requests, seed=seed,
                       max_nrhs=min(max_nrhs, slots),
                       arrival_rate=arrival_rate, skew=skew,
                       deadline_s=deadline_ms / 1e3 if deadline_ms
                       else None)
    try:
        metrics, done = replay_trace_cluster(cluster, trace)
    finally:
        cluster.close()
    metrics = dict(suite=suite, graphs=len(gids), replicas=replicas,
                   routing=routing, slots=slots, policy=policy,
                   precond=precond, skew=skew,
                   arrival_rate=arrival_rate, seed=seed,
                   factor_replicas=factor_replicas,
                   **metrics)
    return metrics, done


# -- factor storm: cold construction burst over a warm solve stream --------

def _storm_suite(k: int, seed: int):
    """``k`` cold graphs shaped like the micro suite (same pow2 shape
    buckets, fresh seeds): their adoptions reuse the warm fleet's
    already-sized fleet stacks, so the disaggregated run measures the
    steady-state adopt cost, not a stack growth."""
    from repro_torch.data import graphs
    makers = [lambda s: graphs.grid2d(6, 6, seed=s),
              lambda s: graphs.powerlaw(80, 4, seed=s),
              lambda s: graphs.road_like(6, seed=s)]
    return [(f"storm_{i}", makers[i % len(makers)](seed + 101 + i))
            for i in range(k)]


def run_factor_storm(*, replicas=2, factor_replicas=0, storm_graphs=4,
                     warm_dt_s=0.25, settle_s=2.0, slots=8,
                     iters_per_tick=8, chunk=128, seed=0,
                     max_queue=1024, devices=None,
                     metrics=None, tracer=None,
                     flight=None, health=None):
    """The disaggregation benchmark: a steady warm solve stream with a
    burst of cold factorizations layered on top.

    The micro suite is pre-factored and pre-solved (warm placements,
    kernels built), then a submitter thread streams one warm solve
    every ``warm_dt_s`` while ``storm_graphs`` cold graphs are all
    submitted at once from a thread pool.  Colocated
    (``factor_replicas=0``) the constructions run on the serving
    drivers and the warm stream stalls behind them (visible in
    ``control_s``); disaggregated they queue on the factor tier and the
    drivers only pay adoptions.  The warm stream runs until the storm
    resolves (plus ``settle_s``), so it spans the storm on any machine
    speed; warm-request e2e p95 is the headline number.

    Each run carries its own :class:`~repro_torch.obs.MetricsRegistry` (or a
    caller-supplied one — e.g. the bench's ``--prom`` dump) and a
    :class:`~repro_torch.obs.SustainedThresholdDetector` watching the cluster
    queue gauge, so the storm doubles as the overload-detection fixture:
    the colocated burst should trip it, a quiet stream should not.  The
    detector snapshot rides back in the ``overload`` key."""
    import threading
    import concurrent.futures as cf
    import numpy as np
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.obs import MetricsRegistry, SustainedThresholdDetector
    from repro_torch.obs.histogram import summarize
    from repro_torch.serve import ClusterOverloadedError

    registry = metrics if metrics is not None else MetricsRegistry()
    # thresholds sized to the storm shape: the warm stream alone keeps
    # the cluster queue near zero, while a colocated burst stalls the
    # drivers and piles warm submits up well past a handful
    detector = SustainedThresholdDetector(
        registry, high_queue=3.0, low_queue=1.0,
        window_s=0.5, sustain_s=0.2, cool_s=0.5)
    cluster, sizes = build_cluster(
        suite="micro", replicas=replicas, routing="affinity",
        slots=slots, iters_per_tick=iters_per_tick, chunk=chunk,
        max_queue=max_queue, seed=seed,
        factor_replicas=factor_replicas, devices=devices,
        metrics=registry, tracer=tracer, detector=detector,
        flight=flight, health=health)
    try:
        warm_gids = list(sizes)
        rng = np.random.default_rng(seed)
        from repro_torch.data import graphs as graphmod
        spec = graphmod.SUITE_MICRO
        # warm placements and the kernels' first-use build: the storm
        # must hit a steady-state cluster, not a cold one
        for i, (name, make) in enumerate(spec.items()):
            cluster.factor(make(), key_from_seed(i), graph_id=name)
        warm_rhs = {g: rng.standard_normal(sizes[g]).astype(np.float32)
                    for g in warm_gids}
        for g in warm_gids:
            cluster.submit(g, warm_rhs[g], tol=1e-5).result()

        storm = _storm_suite(storm_graphs, seed)
        for i, (name, g) in enumerate(storm):
            cluster.register(g, key_from_seed(1000 + i), graph_id=name)
        # rhs drawn up front: the shared Generator is not thread-safe
        # and the storm submits from a pool
        storm_rhs = {name: rng.standard_normal(g.n).astype(np.float32)
                     for name, g in storm}

        warm_futs, warm_shed = [], [0]
        stop = threading.Event()

        def warm_loop():
            i = 0
            while not stop.is_set():
                gid = warm_gids[i % len(warm_gids)]
                try:
                    warm_futs.append(
                        cluster.submit(gid, warm_rhs[gid], tol=1e-5))
                except (ClusterOverloadedError, RuntimeError):
                    warm_shed[0] += 1
                i += 1
                time.sleep(warm_dt_s)

        streamer = threading.Thread(target=warm_loop, daemon=True)
        t0 = time.perf_counter()
        streamer.start()
        # the storm: every cold graph at once (a cold submit blocks its
        # submitter on the factor future, hence the pool)
        with cf.ThreadPoolExecutor(max_workers=len(storm)) as pool:
            storm_futs = [
                pool.submit(
                    lambda name=name: cluster.submit(
                        name, storm_rhs[name], tol=1e-5).result())
                for name, g in storm]
            storm_res = [f.result() for f in storm_futs]
        storm_s = time.perf_counter() - t0
        time.sleep(settle_s)
        stop.set()
        streamer.join(timeout=10.0)
        cluster.drain(timeout=120.0)

        lat = sorted(
            max(r.finish_time - r.submit_time, 0.0)
            for r in (f.result() for f in warm_futs
                      if f.exception() is None))
        cs = cluster.stats().as_dict()
        return dict(
            factor_replicas=factor_replicas, replicas=replicas,
            storm_graphs=len(storm), storm_s=storm_s,
            storm_converged=sum(r.status == "converged"
                                for r in storm_res),
            warm_requests=len(lat), warm_shed=warm_shed[0],
            warm_dt_s=warm_dt_s, seed=seed,
            **summarize(lat, prefix="warm_", unit="s"),
            solve_control_s=sum(r["frontend"]["control_s"]
                                for r in cs["per_replica"]),
            solve_control_calls=sum(r["frontend"]["control_calls"]
                                    for r in cs["per_replica"]),
            adoptions=cs["adoptions"], factor_dedups=cs["factor_dedups"],
            overload=cs["overload"], cluster=cs,
            flight=(flight.stats() if flight is not None else None))
    finally:
        cluster.close(drain=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", default="tiny",
                    choices=["micro", "tiny", "small"])
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--routing", default="affinity",
                    choices=["affinity", "p2c", "rr"],
                    help="cluster routing policy (factor affinity / "
                         "power-of-two-choices / round robin)")
    ap.add_argument("--replicate-above", type=float, default=None,
                    help="hot-factor replication threshold (req/s over "
                         "the rate window); omit to disable")
    ap.add_argument("--replica-ttl-s", type=float, default=30.0,
                    help="TTL stamped on replicated hot-factor copies "
                         "(drives demotion via cache staleness)")
    ap.add_argument("--factor-replicas", type=int, default=0,
                    help="dedicated factor-tier replicas (0 = colocated "
                         "construction on the serving drivers)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated device assignment for solve "
                         "then factor replicas (e.g. 'cuda:0,cuda:1', "
                         "'0,1,2' or 'cpu'); default round-robins the "
                         "CUDA cards")
    ap.add_argument("--device", default=None,
                    help="one torch device for every replica (shorthand "
                         "for --devices; 'cpu' to ask for the plain path)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--iters-per-tick", type=int, default=8)
    ap.add_argument("--max-nrhs", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skew", type=float, default=None,
                    help="Zipf-like graph-choice skew (hot-graph trace); "
                         "omit for the round-robin mixed trace")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="open-loop Poisson arrival rate (req/s)")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "priority", "deadline"],
                    help="per-replica admission policy")
    ap.add_argument("--max-skips", type=int, default=None)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--overload", default="reject",
                    choices=["block", "reject"])
    ap.add_argument("--precond", default="ac",
                    choices=["ac", "ichol", "amg", "spai", "auto"],
                    help="preconditioner family requests serve under "
                         "(the port registers 'ac' only: the others and "
                         "'auto' fail with the family registry's error)")
    ap.add_argument("--select-epsilon", type=float, default=0.1,
                    help="exploration probability for --precond auto")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="stamp every request with this SLO budget "
                         "(the adaptive selector filters on it)")
    ap.add_argument("--json", default=None,
                    help="write metrics (incl. ClusterStats) to JSON")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve a Prometheus /metrics scrape endpoint "
                         "on this port for the run (0 = ephemeral)")
    ap.add_argument("--trace-json", default=None,
                    help="export per-request lifecycle spans as Chrome "
                         "trace_event JSON (chrome://tracing, Perfetto)")
    ap.add_argument("--postmortem-dir", default=None,
                    help="arm the flight recorder: any incident (driver "
                         "crash, replica ejection, sustained overload, "
                         "SLO-miss streak) dumps the recent event ring "
                         "plus a stats/metrics sample to JSONL here")
    args = ap.parse_args(argv)
    if args.device is not None and args.devices is not None:
        ap.error("--device and --devices are exclusive")
    devices = args.devices if args.devices is not None else args.device

    from repro_torch.obs import (MetricsRegistry, SustainedThresholdDetector,
                           Tracer, maybe_serve)
    registry = (MetricsRegistry() if args.metrics_port is not None
                else None)
    tracer = Tracer() if args.trace_json else None
    detector = (SustainedThresholdDetector(registry)
                if registry is not None else None)
    flight = health = None
    if args.postmortem_dir or registry is not None:
        from repro_torch.obs import FlightRecorder, HealthMonitor
        flight = FlightRecorder(postmortem_dir=args.postmortem_dir,
                                slo_miss_streak=8)
        flight.attach(registry=registry)
        health = HealthMonitor(registry, flight=flight)
    server = maybe_serve(registry, args.metrics_port)
    if server is not None:
        print(f"metrics: http://localhost:{server.port}/metrics")

    try:
        metrics, done = run_cluster(
            suite=args.suite, requests=args.requests,
            replicas=args.replicas,
            routing=args.routing, slots=args.slots,
            iters_per_tick=args.iters_per_tick, max_nrhs=args.max_nrhs,
            chunk=args.chunk, seed=args.seed, skew=args.skew,
            arrival_rate=args.arrival_rate, policy=args.policy,
            max_skips=args.max_skips, max_queue=args.max_queue,
            overload=args.overload, replicate_above=args.replicate_above,
            replica_ttl_s=args.replica_ttl_s, precond=args.precond,
            select_epsilon=args.select_epsilon,
            deadline_ms=args.deadline_ms,
            factor_replicas=args.factor_replicas, devices=devices,
            metrics=registry, tracer=tracer, detector=detector,
            flight=flight, health=health)
    finally:
        if server is not None:
            server.close()
        if flight is not None:
            flight.flush(timeout=5.0)
            fs = flight.stats()
            if fs["dump_paths"]:
                print("post-mortem dumps: "
                      + ", ".join(fs["dump_paths"]))
    if tracer is not None and args.trace_json:
        n_ev = tracer.export_chrome(args.trace_json)
        print(f"wrote {args.trace_json} ({n_ev} trace events)")

    c = metrics["cluster"]
    print(f"suite={metrics['suite']} replicas={metrics['replicas']} "
          f"routing={c['policy']} policy={metrics['policy']} "
          f"precond={metrics['precond']} skew={metrics['skew']}")
    if c.get("selector"):
        sel = c["selector"]
        print(f"selector: picks={sel['picks']} "
              f"by_family={sel['picks_by_family']} "
              f"explores={sel['explores']} cold={sel['cold_picks']} "
              f"deadline_misses={sel['deadline_misses']}")
    print(f"served {metrics['completed']}/{metrics['requests']} requests "
          f"({metrics['rhs_total']} rhs, {metrics['converged']} converged) "
          f"in {metrics['serve_s']:.2f}s; shed={c['shed']}")
    print(f"routing: hit_rate={c['hit_rate']:.2f} "
          f"(hits={c['affinity_hits']} misses={c['affinity_misses']}) "
          f"replications={c['replications']} demotions={c['demotions']} "
          f"ejections={c['ejections']} hot_graphs={c['hot_graphs']}")
    if c.get("overload"):
        ov = c["overload"]
        print(f"overload: state={ov['state']} "
              f"rec={ov['recommendation']} "
              f"transitions={ov['transitions']} "
              f"queue_mean={ov['queue_mean']:.1f}")
    if c.get("factor_tier"):
        ft = c["factor_tier"]
        print(f"factor tier: replicas={ft['replicas']} "
              f"factored={sum(w['factored'] for w in ft['per_replica'])} "
              f"coalesced={ft['coalesced_factorizations']} "
              f"dedups={ft['dedups']} adoptions={ft['adoptions']} "
              f"failovers={ft['failovers']} "
              f"factor_s={ft['factor_s']:.1f}")
    print(f"e2e p50={metrics['latency_p50_s']*1e3:.0f}ms "
          f"p95={metrics['latency_p95_s']*1e3:.0f}ms  "
          f"queueing p95={metrics['queue_wait_p95_s']*1e3:.0f}ms  "
          f"per-replica completed="
          f"{metrics['per_replica_completed']}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(metrics, fh, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
