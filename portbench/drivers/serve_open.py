"""Open loop of solve requests through the service: a ``FactorCache``
holding the configuration's graph factored under each of ``keys``, a
``SolveEngine`` of ``slots`` lanes at ``iters_per_tick``, and a
``SolveFrontend`` whose driver thread runs the engine.  Requests arrive
at Poisson times at ``rate`` a second; they alternate over the
resident factors, every third asks for 2 to ``max_nrhs`` columns, and
their tolerances alternate over ``tols`` (the mix of the service's own
trace generator), the same in every run (``mix``).  Right-hand sides
are mean-zero normal columns drawn on the device from the seed in the
set-up.

Every request due in the window is submitted at its due time by this
process's main thread, and timed from its due time to its retirement;
after the window the requests still open are drained (up to
``DRAIN_S``) and counted.  A request that fails, is refused or never
retires counts as missing: its latency is the wait until the drain gave
up, beyond any limit a latency is held to.

Traffic parameters: ``rate``, ``keys``, ``slots``, ``iters_per_tick``,
``mix_seed``, ``max_nrhs``, ``tols``.

Checked against the reference: every retired request's status and the
true residual (float64, the graph's own Laplacian) of each of its
columns over its tol.
"""
from __future__ import annotations

import concurrent.futures
import time

import numpy as np
import torch

from portbench import graphs
from portbench import reference as ref
from portbench.tracing import Tracer

WARMUP_REQUESTS = 6     # served in the set-up: every width and tol of the mix
DRAIN_S = 60.0          # how long the requests open at the deadline may take
TRACE_FROM = 0.9        # --trace 1 traces from this share of the window
TRACE_S = 1.0           # for so many seconds
CONTROL_REQUESTS = 4    # the first requests of the mix the control solves


class Due:
    """One request of the mix: due time (seconds into the window), graph
    id, tol and its columns' offset in the drawn block."""

    def __init__(self, rid, due, gid, tol, lo, hi):
        self.rid, self.due, self.gid, self.tol = rid, due, gid, tol
        self.lo, self.hi = lo, hi


def mix(tr: dict, gids, seconds: float, start: int = 0):
    """The requests due in ``[0, seconds)``: Poisson arrivals, graph ids
    in turn, every third request 2..max_nrhs columns, tols in turn, drawn
    from the traffic's own ``mix_seed``: every run offers the same
    arrivals and sizes (the 95th percentile of a window's latencies moved
    by a third from one draw of arrivals to another, against a tenth
    between two runs of one draw), and ``--seed`` draws the right-hand
    sides."""
    rng = np.random.default_rng([int(tr["mix_seed"]), start])
    out, t, col = [], 0.0, 0
    rid = start
    while True:
        t += float(rng.exponential(1.0 / float(tr["rate"])))
        if t >= seconds:
            return out, col
        k = int(rng.integers(2, int(tr["max_nrhs"]) + 1)) \
            if rid % 3 == 2 else 1
        out.append(Due(rid, t, gids[rid % len(gids)],
                       float(tr["tols"][rid % len(tr["tols"])]), col,
                       col + k))
        col += k
        rid += 1


def _columns(ctx, n: int, cols: int, salt: int) -> np.ndarray:
    """``cols`` mean-zero normal columns ``(cols, n)`` drawn on the
    device from the seed in blocks, returned on the host."""
    gen = torch.Generator(device=ctx.device).manual_seed(
        (ctx.seed * 1_000_003 + salt) % (1 << 62))
    out = np.empty((cols, n), np.float32)
    for a in range(0, cols, 256):
        b = min(a + 256, cols)
        B = torch.randn((b - a, n), generator=gen, device=ctx.device)
        out[a:b] = (B - B.mean(dim=1, keepdim=True)).cpu().numpy()
    return out


def _request(d: Due, B: np.ndarray, maxiter: int):
    from repro_torch.serve import SolveRequest
    b = B[d.lo] if d.hi - d.lo == 1 else B[d.lo:d.hi]
    return SolveRequest(rid=d.rid, graph_id=d.gid, b=b, tol=d.tol,
                        maxiter=maxiter)


def setup(ctx):
    from repro_torch.core.laplacian import Graph
    from repro_torch.core.solver import FactorCache
    from repro_torch.serve import SolveEngine, SolveFrontend
    tr, f = ctx.traffic, ctx.config["factor"]
    g = graphs.build(ctx.config["graph"], ctx.base)
    G = Graph(g.n, g.src, g.dst, g.w)
    keys = [np.array(k, np.uint32) for k in tr["keys"]]
    cache = FactorCache(chunk=f["chunk"], fill_slack=f["fill_slack"],
                        strict=f["strict"], max_retries=f["max_retries"],
                        max_handles=len(keys), device=ctx.device)
    gids = [f"g{i}" for i in range(len(keys))]
    for gid, key in zip(gids, keys):
        cache.factor(G, key, graph_id=gid)
    eng = SolveEngine(cache, slots=int(tr["slots"]),
                      iters_per_tick=int(tr["iters_per_tick"]))
    fe = SolveFrontend(eng, max_queue=1 << 30, overload="reject")
    maxiter = int(ctx.config["solve"]["maxiter"])
    due, cols = mix(tr, gids, ctx.seconds)
    B = _columns(ctx, g.n, cols, 0)
    # warm-up: every width and tol of the mix, on every factor
    w = WARMUP_REQUESTS
    warm, wcols = mix(dict(tr, rate=1.0), gids, float(w) + 1.0,
                      start=1 << 20)
    Bw = _columns(ctx, g.n, wcols, 1)
    futs = [fe.submit_request(_request(d, Bw, maxiter)) for d in warm[:w]]
    concurrent.futures.wait(futs)
    for fu in futs:
        fu.result()
    return dict(g=g, fe=fe, eng=eng, due=due, B=B, maxiter=maxiter,
                gids=gids)


def window(ctx, state):
    tr = ctx.traffic
    fe, eng, due, B = state["fe"], state["eng"], state["due"], state["B"]
    reqs = [_request(d, B, state["maxiter"]) for d in due]
    ticks0 = eng.stats().ticks
    # --trace 1 traces the window's last part on the frontend's driver
    # thread, which launches every kernel of the engine (torch.profiler
    # follows the thread that starts it), between two of its rounds; the
    # profiler slows that thread, so the per-layer metrics are read over
    # the requests due before the trace began
    tracer = Tracer() if ctx.trace else None
    t_trace = TRACE_FROM * ctx.seconds
    trace_calls = []
    futs, lag = [], []
    t0 = time.perf_counter()
    cut, ticks_cut = float("inf"), None
    for d, req in zip(due, reqs):
        if tracer is not None and len(trace_calls) < 2 and d.due >= (
                t_trace + len(trace_calls) * TRACE_S):
            if not trace_calls:
                cut, ticks_cut = t0 + d.due, eng.ticks
                trace_calls.append(fe.call(tracer.start))
            else:
                trace_calls.append(fe.call(tracer.stop, reduce=False))
        wait = t0 + d.due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        req.submit_time = 0.0
        try:
            futs.append(fe.submit_request(req))
        except RuntimeError:
            futs.append(None)
        lag.append(time.perf_counter() - (t0 + d.due))
    if len(trace_calls) == 1:
        trace_calls.append(fe.call(tracer.stop, reduce=False))
    live = [f for f in futs if f is not None]
    concurrent.futures.wait(live, timeout=DRAIN_S)
    t_close = time.perf_counter()
    for fu in trace_calls:
        fu.result()
    if tracer is not None:
        ctx.summary = tracer.reduce()
    lat, qwait, service, pre_lag, col_iters, out = [], [], [], [], 0, []
    failed = 0
    for d, req, fu, lg in zip(due, reqs, futs, lag):
        ok = fu is not None and fu.done() and fu.exception() is None
        if not ok or req.status != "converged":
            # missing: it waited at least until the drain gave up
            failed += 1
            lat.append(t_close - (t0 + d.due))
        else:
            lat.append(req.finish_time - (t0 + d.due))
        if ok:
            out.append((d, np.atleast_2d(req.x), req.status))
        if t0 + d.due >= cut:
            continue
        pre_lag.append(lg)
        if ok:
            qwait.append(req.admit_time - (t0 + d.due))
            service.append(req.finish_time - req.admit_time)
            if req.finish_time < cut:
                col_iters += int(np.sum(req.iters))
    ticks = (ticks_cut if ticks_cut is not None else eng.stats().ticks) \
        - ticks0
    ctx.e2e["latency_p95_ms"] = 1e3 * float(np.percentile(lat, 95))
    ctx.attempted, ctx.failed = len(due), failed
    ctx.counters.update(
        requests=len(due), window_s=t_close - t0, ticks=ticks,
        slots=int(tr["slots"]), iters_per_tick=int(tr["iters_per_tick"]),
        column_iters=col_iters)
    for name, xs in (("latency", lat), ("queue_wait", qwait),
                     ("service", service), ("generator_lag", pre_lag)):
        ctx.counters[f"{name}_s"] = xs
    return dict(g=state["g"], B=B, served=out, failed=failed)


def close(state):
    state["fe"].close(drain=False, timeout=1.0)


def check(ctx, out):
    g = out["g"]
    dev = ctx.device
    lap = ref.Laplacian(g.n, g.src, g.dst, g.w, device=dev)
    ratios = []
    for d, X, status in out["served"]:
        rr = ref.true_relres(lap, torch.as_tensor(X, device=dev).T,
                             torch.as_tensor(out["B"][d.lo:d.hi],
                                             device=dev).T)
        ratios += (rr / d.tol).tolist()
    ctx.check("resid_ratio", ref.worst(ratios))
    ctx.check("unserved", out["failed"])


def control(ctx, dtype):
    """The reference in ``dtype`` in the program's place: its factor of
    each resident key and its PCG on the first ``CONTROL_REQUESTS``
    requests of the window's mix."""
    tr, s = ctx.traffic, ctx.config["solve"]
    g = graphs.build(ctx.config["graph"], ctx.base)
    dev = ctx.device
    gids = [f"g{i}" for i in range(len(tr["keys"]))]
    lap = ref.Laplacian(g.n, g.src, g.dst, g.w, dtype=dtype, device=dev)
    applies = {gid: ref.Apply(ref.factor(g.n, g.src, g.dst, g.w,
                                         np.array(k, np.uint32), dtype=dtype,
                                         device=dev), dtype=dtype, device=dev)
               for gid, k in zip(gids, tr["keys"])}
    due, cols = mix(tr, gids, ctx.seconds)
    B = _columns(ctx, g.n, cols, 0)
    served, failed = [], 0
    for d in due[:CONTROL_REQUESTS]:
        b = torch.as_tensor(B[d.lo:d.hi], device=dev).T
        o = ref.pcg(lap, applies[d.gid], b, d.tol, int(s["maxiter"]),
                    dtype=dtype)
        ok = bool(np.all(o.relres <= d.tol))
        failed += not ok
        served.append((d, o.x.T.float().cpu().numpy(),
                       "converged" if ok else "maxiter"))
    return dict(g=g, B=B, served=served, failed=failed)
