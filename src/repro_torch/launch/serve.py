"""Solve-service launcher: multi-tenant continuous-batching engine over
a generated graph suite, replaying a mixed request trace — on the GPU
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --suite tiny \
        --requests 24 --slots 8 --iters-per-tick 8 --arrival-rate 50

Spins up a :class:`FactorCache` (batched fleet factorization + batched
schedule construction), submits a seeded trace of interleaved single-
and multi-RHS requests with mixed tolerances, drains the device-resident
:class:`SolveEngine`, and reports throughput and latency percentiles —
the service-level view of the paper's factor-once / serve-many
economics.

With ``--arrival-rate R`` the trace becomes **open-loop**: request
inter-arrival gaps are seeded Poisson (exponential with mean ``1/R``
seconds) and the replay submits each request at its arrival time rather
than all at once, so the report separates *queueing delay*
(submit → lane admission) and *end-to-end* latency from pure *service*
latency (admission → finish).  Without it the replay is closed-loop
(every request arrives at t=0) and queueing delay measures head-of-line
blocking only.

``--async`` drives the same replay through the
:class:`repro_torch.serve.SolveFrontend` — a background engine-driver thread
with futures resolved on retirement and a bounded ingress queue — and
``--policy {fifo,priority,deadline}`` selects the admission scheduler
(``--max-skips`` bounds backfill; ``--deadline-ms`` stamps a per-request
SLO budget that the deadline policy orders by and enforces via
hopeless-lane eviction):

    PYTHONPATH=src python -m repro_torch.launch.serve --suite tiny \
        --requests 24 --arrival-rate 50 --async --policy deadline \
        --deadline-ms 2000

``--precond`` names the preconditioner family the suite serves under
(``ac``, ``ichol``, ``amg``, ``spai``), or ``auto``: every family is
built for every graph and an :class:`AdaptiveSelector` picks one per
request from serving telemetry (sync replay only).  ``amg`` and ``spai``
build a dense ``n × n`` operator on the host, so they are for graphs of a
few thousand vertices (``--suite small`` at most):

    PYTHONPATH=src python -m repro_torch.launch.serve --suite micro \
        --precond auto --device cpu
"""
from __future__ import annotations

import argparse
import json
import time


from repro_torch.obs.histogram import percentile

# suite names resolved against the canonical registry in
# repro_torch.data.graphs
# (no local re-definitions: one source of truth for generator params/seeds)
SMALL_NAMES = ("grid2d_64", "grid3d_uniform_16", "powerlaw_4k")


def make_trace(gids, sizes, n_requests, *, seed=0, max_nrhs=4,
               tols=(1e-4, 1e-6), arrival_rate=None, deadline_s=None,
               skew=None):
    """Seeded mixed trace: round-robin-ish graph choice, ~1/3 multi-RHS,
    alternating tolerances — deliberately interleaved so consecutive
    requests rarely share a factor.  All randomness (rhs content *and*
    Poisson arrival gaps) comes from the one seeded generator, so a
    trace is reproducible across runs and artifacts.  ``deadline_s``
    stamps every request with the same relative SLO budget (deadline
    policies order by it and evict hopeless lanes).

    ``skew`` switches graph choice from round-robin to a seeded
    Zipf-like draw (weight ∝ 1/(rank+1)^skew over ``gids`` order) — the
    hot-graph workload the cluster's factor-affinity routing and
    hot-factor replication are measured on."""
    import numpy as np
    from repro_torch.serve import SolveRequest
    rng = np.random.default_rng(seed)
    if skew is not None:
        w = 1.0 / np.arange(1, len(gids) + 1) ** float(skew)
        picks = rng.choice(len(gids), size=n_requests, p=w / w.sum())
    reqs = []
    arrival = 0.0
    for rid in range(n_requests):
        gid = gids[int(picks[rid])] if skew is not None \
            else gids[rid % len(gids)]
        n = sizes[gid]
        nrhs = int(rng.integers(2, max_nrhs + 1)) \
            if (max_nrhs > 1 and rid % 3 == 2) else 1
        b = rng.normal(size=(nrhs, n) if nrhs > 1 else n).astype(np.float32)
        b -= b.mean(axis=-1, keepdims=True)
        if arrival_rate:
            arrival += float(rng.exponential(1.0 / arrival_rate))
        reqs.append(SolveRequest(rid=rid, graph_id=gid, b=b,
                                 tol=tols[rid % len(tols)], maxiter=500,
                                 arrival_s=arrival, deadline_s=deadline_s))
    return reqs


def build_service(*, suite="tiny", slots=8, iters_per_tick=8, chunk=128,
                  fill_slack=32, memory_budget_mb=None, policy="fifo",
                  max_skips=None, precond="ac", precond_params=None,
                  metrics=None, tracer=None, flight=None, health=None,
                  device=None):
    """Stand up the service: generate the graph suite, admit the fleet
    to a :class:`FactorCache`, wrap it in a :class:`SolveEngine` with
    the named admission policy.  ``precond`` selects the preconditioner
    family the suite is factored under (``"ac"`` uses the batched
    fleet factorization; other registered families construct per graph;
    ``"auto"`` factors the AC fleet and every other registered family on
    every graph, under ``"<graph>::<family>"`` ids, so the adaptive
    replay chooses among resident factors).  ``device``: where the
    cache lives (default: the GPU).  Returns
    ``(engine, sizes, factor_s, registry)`` — ``registry`` maps
    ``graph_id -> (graph, key)`` so adaptive replays can construct
    additional families lazily; reuse the engine across trace replays
    so the kernels' first-use build is paid once."""
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.solver import FactorCache, PRECOND_FAMILIES
    from repro_torch.data import graphs
    from repro_torch.serve import SolveEngine, make_policy

    spec = graphs.SUITE_MICRO if suite == "micro" else \
        graphs.SUITE_TINY if suite == "tiny" else \
        {k: graphs.SUITE[k] for k in SMALL_NAMES}
    built = {name: make() for name, make in spec.items()}
    keys = {name: key_from_seed(i) for i, name in enumerate(built)}
    cache = FactorCache(
        chunk=chunk, fill_slack=fill_slack, strict=False,
        memory_budget_bytes=(memory_budget_mb * (1 << 20)
                             if memory_budget_mb else None),
        flight=flight, device=device)
    t0 = time.perf_counter()
    if precond in ("ac", "auto"):
        cache.factor_batched(list(built.values()),
                             [keys[name] for name in built],
                             graph_ids=list(built.keys()))
        if precond == "auto":
            # pre-build every other family too: the adaptive replay's
            # selector then chooses among *resident* factors, so an
            # exploration pick pays its serve cost, not a mid-trace
            # construction stall that would punish whatever request
            # happened to trigger it
            for fam in sorted(PRECOND_FAMILIES):
                if fam == "ac":
                    continue
                for name, g in built.items():
                    cache.factor(g, keys[name], graph_id=f"{name}::{fam}",
                                 family=fam)
    else:
        for name, g in built.items():
            cache.factor(g, keys[name], graph_id=name, family=precond,
                         precond_params=precond_params)
    _sync(cache.device)
    t_factor = time.perf_counter() - t0
    eng = SolveEngine(cache, slots=slots, iters_per_tick=iters_per_tick,
                      admission=make_policy(policy, max_skips=max_skips),
                      metrics=metrics, tracer=tracer,
                      flight=flight, health=health)
    if health is not None:
        health.watch_engine(eng)
        health.watch_cache(cache)
    registry = {name: (g, keys[name]) for name, g in built.items()}
    return eng, {name: g.n for name, g in built.items()}, t_factor, registry


def _sync(device) -> None:
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trace_metrics(trace, done, t_serve):
    """Service metrics over completed requests — shared by the sync and
    async replay paths so their reports are directly comparable."""
    import numpy as np
    e2e = [r.latency_s for r in done]
    queue = [r.queue_wait_s for r in done]
    service = [r.service_s for r in done]
    rhs_total = sum(r.nrhs for r in done)
    return dict(
        requests=len(trace), completed=len(done), rhs_total=rhs_total,
        converged=int(sum(bool(r.converged) for r in done)),
        deadline_missed=int(sum(r.status == "deadline_missed"
                                for r in done)),
        serve_s=t_serve,
        requests_per_s=len(done) / t_serve if t_serve > 0 else 0.0,
        rhs_per_s=rhs_total / t_serve if t_serve > 0 else 0.0,
        latency_p50_s=percentile(e2e, 50),
        latency_p95_s=percentile(e2e, 95),
        latency_max_s=percentile(e2e, 100),
        queue_wait_p50_s=percentile(queue, 50),
        queue_wait_p95_s=percentile(queue, 95),
        service_p50_s=percentile(service, 50),
        service_p95_s=percentile(service, 95),
        iters_total=int(sum(int(np.sum(r.iters)) for r in done
                            if r.iters is not None)))


def replay_trace(eng, trace):
    """Replay a trace (open-loop when requests carry arrival offsets:
    each request is submitted at its ``arrival_s``), drain the engine,
    return service metrics.  Queueing delay (submit → admission) and
    end-to-end latency (submit → finish) are reported separately from
    service latency (admission → finish)."""
    from collections import deque
    pending = deque(trace)
    done = []
    t0 = time.perf_counter()
    while pending or eng.busy:
        now = time.perf_counter() - t0
        while pending and pending[0].arrival_s <= now:
            eng.submit(pending.popleft())
        if eng.busy:
            done.extend(eng.tick())
        elif pending:
            time.sleep(min(pending[0].arrival_s - now, 0.01))
    t_serve = time.perf_counter() - t0
    return trace_metrics(trace, done, t_serve), done


def replay_trace_auto(eng, trace, *, registry, selector):
    """Adaptive-family replay: each request's preconditioner family is
    picked by ``selector`` at submit time (cold graphs fall back to AC),
    the family's factor is constructed lazily into the engine's cache on
    first pick (the construction stall is *in* the open-loop clock —
    exploration pays its real cost), and every retirement is fed back
    via ``selector.observe``.  Same metrics dict as
    :func:`replay_trace`."""
    import numpy as np
    from collections import deque
    pending = deque(trace)
    done = []
    t0 = time.perf_counter()

    def _observe(r):
        base, _, fam = r.graph_id.partition("::")
        missed = r.status == "deadline_missed" or (
            r.deadline_s is not None and r.latency_s > r.deadline_s)
        # the lifecycle stamps carry the deconflated signal: pure
        # service seconds as the serve estimate, the lazily-paid
        # construction (stamped below) as its own component
        serve = r.service_s if r.admit_time > 0.0 else r.latency_s
        selector.observe(
            base, fam or "ac", wall_s=r.latency_s, serve_s=serve,
            construct_s=r.factor_wait_s if r.factor_mode else None,
            iters=int(np.max(r.iters)) if r.iters is not None else None,
            ok=r.status == "converged", deadline_ok=not missed)

    while pending or eng.busy:
        now = time.perf_counter() - t0
        while pending and pending[0].arrival_s <= now:
            req = pending.popleft()
            fam = selector.pick(req.graph_id, deadline_s=req.deadline_s)
            gid = req.graph_id if fam == "ac" \
                else f"{req.graph_id}::{fam}"
            if not eng.cache.fresh(gid):
                g, key = registry[req.graph_id]
                t_f0 = time.perf_counter()
                eng.cache.factor(g, key, graph_id=gid, family=fam)
                req.factor_wait_s = time.perf_counter() - t_f0
                req.factor_mode = "factor"
            req.graph_id = gid
            eng.submit(req)
        if eng.busy:
            for r in eng.tick():
                _observe(r)
                done.append(r)
        elif pending:
            time.sleep(min(pending[0].arrival_s - now, 0.01))
    t_serve = time.perf_counter() - t0
    return trace_metrics(trace, done, t_serve), done


def replay_trace_async(frontend, trace):
    """Open-loop replay through the async frontend: the caller thread
    only *submits* (at each request's ``arrival_s``); the frontend's
    driver thread runs the engine and resolves futures on retirement.
    Returns the same metrics dict as :func:`replay_trace`."""
    import concurrent.futures
    from repro_torch.serve import EngineOverloadedError
    futs = []
    t0 = time.perf_counter()
    for req in trace:
        now = time.perf_counter() - t0
        if req.arrival_s > now:
            time.sleep(req.arrival_s - now)
        try:
            futs.append(frontend.submit_request(req))
        except EngineOverloadedError:
            pass           # reject-mode backpressure: shed, keep going
            # (frontend.stats().rejected counts it; completed < requests
            # in the metrics shows the shortfall)
    concurrent.futures.wait(futs)
    t_serve = time.perf_counter() - t0
    done = [f.result() for f in futs if f.exception() is None]
    return trace_metrics(trace, done, t_serve), done


def run_service(*, suite="tiny", requests=24, slots=8, iters_per_tick=8,
                max_nrhs=4, chunk=128, fill_slack=32, seed=0,
                memory_budget_mb=None, warmup_requests=0,
                arrival_rate=None, policy="fifo", max_skips=None,
                deadline_ms=None, use_async=False, max_queue=256,
                overload="block", precond="ac", precond_params=None,
                select_epsilon=0.2, skew=None, return_engine=False,
                metrics=None, tracer=None, flight=None, health=None,
                device=None):
    """Build the service, replay a trace, return a metrics dict.  With
    ``warmup_requests`` > 0 a throwaway trace is replayed first through
    the *same* engine so the measured replay excludes the kernels'
    first-use build.
    ``use_async`` routes the replay through :class:`SolveFrontend`
    (background driver thread, futures, bounded ingress queue).
    ``precond`` fixes the serving preconditioner family, or ``"auto"``
    replays through an :class:`~repro_torch.serve.AdaptiveSelector`
    (sync replay only); ``skew`` makes the trace Zipf-hot."""
    if precond == "auto" and use_async:
        raise ValueError("--precond auto uses the sync replay loop "
                         "(selector feedback rides eng.tick retirement)")
    eng, sizes, t_factor, registry = build_service(
        suite=suite, slots=slots, iters_per_tick=iters_per_tick,
        chunk=chunk, fill_slack=fill_slack,
        memory_budget_mb=memory_budget_mb, policy=policy,
        max_skips=max_skips, precond=precond,
        precond_params=precond_params, metrics=metrics, tracer=tracer,
        flight=flight, health=health, device=device)
    gids = list(sizes)
    deadline_s = deadline_ms / 1e3 if deadline_ms else None
    selector = None
    if precond == "auto":
        from repro_torch.serve import AdaptiveSelector
        selector = AdaptiveSelector(seed=seed, epsilon=select_epsilon)
    if warmup_requests:
        # same seed: the warmup trace is a prefix-identical replay (sans
        # arrival gaps), so every kernel the measured trace launches is
        # already built.  No deadlines: a slow first tick must not evict
        # warmup lanes.
        if selector is not None:
            # a first pass *outside* the selector: serve every family on
            # every graph at every pow2 admission width the trace can
            # produce, so each (family, bucket)'s first serve (the
            # kernels' build, the first allocations at its shapes) is
            # paid before the selector times any family and cannot pass
            # for the family being expensive
            import numpy as np
            from repro_torch.core.parac import _next_pow2
            from repro_torch.serve import SolveRequest
            wrng = np.random.default_rng(seed + 1)
            widths = sorted({_next_pow2(j)
                             for j in range(1, min(max_nrhs, slots) + 1)})
            fam_trace = []
            for name in gids:
                for fam in ("ac", "ichol", "amg", "spai"):
                    for j in widths:
                        wb = wrng.normal(
                            size=(j, sizes[name])).astype(np.float32)
                        wb -= wb.mean(axis=1, keepdims=True)
                        fam_trace.append(SolveRequest(
                            rid=-1 - len(fam_trace),
                            graph_id=(name if fam == "ac"
                                      else f"{name}::{fam}"),
                            b=wb if j > 1 else wb[0],
                            tol=1e-6, maxiter=500))
            replay_trace(eng, fam_trace)
        warm = make_trace(gids, sizes, warmup_requests, seed=seed,
                          max_nrhs=min(max_nrhs, slots), skew=skew)
        if selector is not None:
            replay_trace_auto(eng, warm, registry=registry,
                              selector=selector)
        else:
            replay_trace(eng, warm)
    trace = make_trace(gids, sizes, requests, seed=seed,
                       max_nrhs=min(max_nrhs, slots),
                       arrival_rate=arrival_rate, deadline_s=deadline_s,
                       skew=skew)
    ticks_before = eng.ticks                 # exclude warmup from metrics
    frontend_stats = None
    if use_async:
        from repro_torch.serve import SolveFrontend
        with SolveFrontend(eng, max_queue=max_queue,
                           overload=overload, metrics=metrics,
                           flight=flight) as fe:
            metrics, done = replay_trace_async(fe, trace)
            fs = fe.stats()
            frontend_stats = dict(submitted=fs.submitted,
                                  completed=fs.completed,
                                  failed=fs.failed, rejected=fs.rejected,
                                  queue_peak=fs.queue_peak,
                                  max_queue=fs.max_queue)
    elif selector is not None:
        metrics, done = replay_trace_auto(eng, trace, registry=registry,
                                          selector=selector)
    else:
        metrics, done = replay_trace(eng, trace)
    ticks = eng.ticks - ticks_before
    metrics = dict(suite=suite, graphs=len(gids), slots=slots,
                   iters_per_tick=iters_per_tick, factor_s=t_factor,
                   ticks=ticks,
                   ticks_per_s=(ticks / metrics["serve_s"]
                                if metrics["serve_s"] > 0 else 0.0),
                   arrival_rate=arrival_rate, seed=seed,
                   policy=policy, mode="async" if use_async else "sync",
                   precond=precond, device=str(eng.cache.device),
                   selector=(selector.stats() if selector is not None
                             else None),
                   frontend=frontend_stats,
                   cache=eng.cache.stats(),
                   engine=eng.stats().as_dict(),
                   tracing=(tracer.stats() if tracer is not None else None),
                   **metrics)
    if return_engine:      # benchmarks reuse the factored cache (sweeps)
        return metrics, done, eng
    return metrics, done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", default="tiny",
                    choices=["micro", "tiny", "small"])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--iters-per-tick", type=int, default=8)
    ap.add_argument("--max-nrhs", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="open-loop Poisson arrival rate (requests/sec); "
                         "omit for closed-loop (all arrive at t=0)")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="drive the replay through the SolveFrontend "
                         "(background engine thread + futures)")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "priority", "deadline"],
                    help="admission scheduler (fifo = head-of-line "
                         "blocking; priority/deadline backfill narrow "
                         "requests past a blocked wide head)")
    ap.add_argument("--max-skips", type=int, default=None,
                    help="backfill starvation bound (admission rounds a "
                         "blocked request may be skipped)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="stamp every request with this SLO budget; the "
                         "deadline policy orders by it and evicts "
                         "hopeless lanes (status=deadline_missed)")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="async frontend ingress bound (backpressure)")
    ap.add_argument("--overload", default="block",
                    choices=["block", "reject"],
                    help="async backpressure: block submitters or "
                         "reject with EngineOverloadedError")
    ap.add_argument("--precond", default="ac",
                    choices=["ac", "ichol", "amg", "spai", "auto"],
                    help="preconditioner family the suite serves under; "
                         "'auto' = adaptive per-graph selection "
                         "(epsilon-greedy on serving telemetry); amg and "
                         "spai build a dense n x n operator on the host, "
                         "for graphs of a few thousand vertices")
    ap.add_argument("--select-epsilon", type=float, default=0.2,
                    help="exploration probability for --precond auto")
    ap.add_argument("--skew", type=float, default=None,
                    help="Zipf-like graph-choice skew (hot-graph trace)")
    ap.add_argument("--memory-budget-mb", type=int, default=None)
    ap.add_argument("--json", default=None,
                    help="write service metrics to this JSON file")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve a Prometheus scrape endpoint on this "
                         "port for the replay's lifetime "
                         "(curl localhost:PORT/metrics)")
    ap.add_argument("--trace-json", default=None,
                    help="record per-request lifecycle spans and the "
                         "layer spans (factor stages, PCG iterations, "
                         "engine ticks) and write Chrome trace_event JSON "
                         "here (chrome://tracing / Perfetto)")
    ap.add_argument("--postmortem-dir", default=None,
                    help="arm the flight recorder: structured lifecycle "
                         "events ring-buffer in memory, and any incident "
                         "(driver crash, SLO-miss streak) dumps the last "
                         "events + a metrics sample to JSONL files here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to ask "
                         "for the plain path)")
    args = ap.parse_args(argv)

    from repro_torch.obs import MetricsRegistry, Tracer, maybe_serve
    from repro_torch.obs import tracing
    registry = MetricsRegistry() \
        if (args.metrics_port is not None) else None
    tracer = Tracer() if args.trace_json else None
    if tracer is not None:
        tracing.attach(tracer)      # the layer spans land in the same file
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
        metrics, done = run_service(
            suite=args.suite, requests=args.requests, slots=args.slots,
            iters_per_tick=args.iters_per_tick, max_nrhs=args.max_nrhs,
            chunk=args.chunk, seed=args.seed,
            memory_budget_mb=args.memory_budget_mb,
            arrival_rate=args.arrival_rate, policy=args.policy,
            max_skips=args.max_skips, deadline_ms=args.deadline_ms,
            use_async=args.use_async, max_queue=args.max_queue,
            overload=args.overload, precond=args.precond,
            select_epsilon=args.select_epsilon, skew=args.skew,
            metrics=registry, tracer=tracer, flight=flight, health=health,
            device=args.device)
    finally:
        if tracer is not None:
            tracing.detach()
        if server is not None:
            server.close()
        if flight is not None:
            flight.flush(timeout=5.0)
            fs = flight.stats()
            if fs["dump_paths"]:
                print("post-mortem dumps: "
                      + ", ".join(fs["dump_paths"]))
    if tracer is not None:
        n = tracer.export_chrome(args.trace_json)
        print(f"wrote {n} trace events to {args.trace_json}")

    print(f"suite={metrics['suite']} graphs={metrics['graphs']} "
          f"factor_batched={metrics['factor_s']:.2f}s "
          f"mode={metrics['mode']} policy={metrics['policy']} "
          f"precond={metrics['precond']} device={metrics['device']}")
    if metrics["selector"]:
        sel = metrics["selector"]
        print(f"selector: picks={sel['picks']} "
              f"by_family={sel['picks_by_family']} "
              f"explores={sel['explores']} cold={sel['cold_picks']} "
              f"deadline_misses={sel['deadline_misses']}")
    print(f"served {metrics['completed']}/{metrics['requests']} requests "
          f"({metrics['rhs_total']} rhs, {metrics['converged']} converged) "
          f"in {metrics['serve_s']:.2f}s over {metrics['slots']} slots, "
          f"{metrics['ticks']} ticks ({metrics['ticks_per_s']:.1f}/s)")
    print(f"throughput: {metrics['requests_per_s']:.1f} req/s "
          f"({metrics['rhs_per_s']:.1f} rhs/s incl. kernel build)  "
          f"e2e p50={metrics['latency_p50_s']*1e3:.0f}ms "
          f"p95={metrics['latency_p95_s']*1e3:.0f}ms "
          f"max={metrics['latency_max_s']*1e3:.0f}ms")
    print(f"queueing: p50={metrics['queue_wait_p50_s']*1e3:.0f}ms "
          f"p95={metrics['queue_wait_p95_s']*1e3:.0f}ms  "
          f"service: p50={metrics['service_p50_s']*1e3:.0f}ms "
          f"p95={metrics['service_p95_s']*1e3:.0f}ms"
          + (f"  (open-loop @ {metrics['arrival_rate']:.1f} req/s)"
             if metrics["arrival_rate"] else "  (closed-loop)"))
    eng_d = metrics["engine"]
    if eng_d["policy"] != "fifo" or metrics["deadline_missed"]:
        print(f"scheduler[{eng_d['policy']}]: "
              f"admitted={eng_d['admitted_reqs']} "
              f"backfill_skips={eng_d['backfill_skips']} "
              f"(bound {eng_d['max_skips']}/req, "
              f"{eng_d['skipped_reqs']} skipped) "
              f"deadline_evictions={eng_d['deadline_evictions']} "
              f"missed={metrics['deadline_missed']}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(metrics, fh, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
