"""Closed loop of solves against one factor: the set-up factors the
configuration's graph once with the traffic's ``key`` (the deployment's
resident factor: the same set-up work under every seed) and solves one
batch to warm up; in the window one client makes back-to-back
``handle.solve(B)`` calls, each ``B`` a fresh ``(nrhs, n)`` block of
mean-zero normal columns drawn on the device from the seed, to the
configuration's tol and maxiter.

Traffic parameters: ``key``; ``nrhs``.

Checked against the reference: every column of every call in the window,
its true residual (float64, the graph's own Laplacian) over its tol; that
every column converged; and for the drawn calls the iterations against
the reference's PCG in float64 with the reference's factor.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import graphs
from portbench import reference as ref
from portbench import yardstick
from portbench.tracing import Tracer

TRACE_CALLS = (2, 4)   # the calls --trace 1 traces, [first, stop)
CHECK_CALLS = 1        # calls, drawn from the seed, the reference PCG follows


def _rhs(ctx, n: int, nrhs: int, i: int) -> torch.Tensor:
    """Call ``i``'s right-hand sides, ``(nrhs, n)``, from the seed."""
    gen = torch.Generator(device=ctx.device).manual_seed(
        (ctx.seed * 1_000_003 + i) % (1 << 62))
    B = torch.randn((nrhs, n), generator=gen, device=ctx.device)
    return B - B.mean(dim=1, keepdim=True)


def setup(ctx):
    from repro_torch.core.laplacian import Graph
    from repro_torch.core.solver import Solver
    f = ctx.config["factor"]
    g = graphs.build(ctx.config["graph"], ctx.base)
    rng = np.random.default_rng(ctx.seed)
    key = np.asarray(ctx.traffic["key"], np.uint32)
    solver = Solver(chunk=f["chunk"], fill_slack=f["fill_slack"],
                    strict=f["strict"], max_retries=f["max_retries"],
                    device=ctx.device)
    h = solver.factor(Graph(g.n, g.src, g.dst, g.w), key)
    s = ctx.config["solve"]
    h.solve(_rhs(ctx, g.n, int(ctx.traffic["nrhs"]), -1), tol=s["tol"],
            maxiter=s["maxiter"])
    return dict(g=g, key=key, solver=solver, handle=h, rng=rng)


def window(ctx, state):
    from repro_torch.kernels.runtime import LAUNCHES
    tr, s = ctx.traffic, ctx.config["solve"]
    g, h = state["g"], state["handle"]
    nrhs = int(tr["nrhs"])
    first, stop = TRACE_CALLS if ctx.trace else (-1, -1)
    X, iters, conv = [], [], []
    excluded = pause = 0.0   # the trace's reduction, outside the window
    tracer = None
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    t_end = t0
    i = 0
    while time.perf_counter() < deadline:
        if i == first:
            tracer = Tracer()
            before = LAUNCHES.get("ell_sweep_fleet", 0)
            tracer.start()
        B = _rhs(ctx, g.n, nrhs, i)
        a = time.perf_counter()
        res = h.solve(B, tol=s["tol"], maxiter=s["maxiter"])
        it = res.iters.cpu().numpy()
        X.append(res.x.cpu())
        t_end = time.perf_counter()
        excluded, pause = excluded + pause, 0.0
        iters.append(it)
        conv.append(res.converged.cpu().numpy())
        ctx.spans.add("solve.call", a, t_end, iters=int(it.max()),
                      traced=first <= i < stop)
        i += 1
        if i == stop or (tracer is not None and tracer.running
                         and time.perf_counter() >= deadline):
            ctx.summary = tracer.stop()
            ctx.counters["traced_sweep_launches"] = \
                LAUNCHES.get("ell_sweep_fleet", 0) - before
            ctx.counters["traced_applies"] = sum(
                int(x.max()) + 1 for x in iters[first:i])
            pause = time.perf_counter() - t_end
            deadline += pause
    window_s = t_end - t0 - excluded
    ctx.spans.add("window", t0, t_end, paused=excluded)
    ctx.e2e["solve_s"] = window_s / i
    ctx.attempted = i * nrhs
    ctx.failed = int(sum(int((~c).sum()) for c in conv))
    ctx.counters.update(
        calls=i, window_s=window_s, columns=i * nrhs,
        column_iters=int(sum(int(x.sum()) for x in iters)),
        loop_iters=int(sum(int(x.max()) for x in iters)),
        lanes=nrhs, n=g.n, nnz=int(h.factor.nnz))
    if ctx.trace:
        f = h.factor
        ctx.counters["apply_bytes"] = yardstick.sweep_bytes(
            g.n, np.asarray(f.col_ptr, np.int64), np.asarray(f.rows), nrhs)
    pick = state["rng"].choice(i, size=min(CHECK_CALLS, i), replace=False)
    return dict(g=g, key=state["key"], X=X, iters=iters, conv=conv,
                pick=sorted(int(p) for p in pick), nrhs=nrhs)


def check(ctx, out):
    g, s = out["g"], ctx.config["solve"]
    dev = ctx.device
    lap = ref.Laplacian(g.n, g.src, g.dst, g.w, device=dev)
    ratios = []
    for i, x in enumerate(out["X"]):
        B = _rhs(ctx, g.n, out["nrhs"], i)
        ratios += (ref.true_relres(lap, x.to(dev).T, B.T) / s["tol"]).tolist()
    ctx.check("resid_ratio", ref.worst(ratios))
    ctx.check("unconverged", sum(int((~c).sum()) for c in out["conv"]))
    want = ref.factor(g.n, g.src, g.dst, g.w, out["key"], device=dev)
    apply = ref.Apply(want, device=dev)
    gap = 0
    for i in out["pick"]:
        B = _rhs(ctx, g.n, out["nrhs"], i)
        o = ref.pcg(lap, apply, B.T.double(), s["tol"], s["maxiter"])
        gap = max(gap, int(np.abs(out["iters"][i].astype(np.int64)
                                  - o.iters).max()))
    ctx.check("iters_gap", gap)


def control(ctx, dtype):
    """The reference in ``dtype`` in the program's place: its factor of
    the set-up's key and its PCG on the first ``CHECK_CALLS`` calls'
    right-hand sides."""
    s, nrhs = ctx.config["solve"], int(ctx.traffic["nrhs"])
    g = graphs.build(ctx.config["graph"], ctx.base)
    key = np.asarray(ctx.traffic["key"], np.uint32)
    dev = ctx.device
    f = ref.factor(g.n, g.src, g.dst, g.w, key, dtype=dtype, device=dev)
    apply = ref.Apply(f, dtype=dtype, device=dev)
    lap = ref.Laplacian(g.n, g.src, g.dst, g.w, dtype=dtype, device=dev)
    X, iters, conv = [], [], []
    calls = CHECK_CALLS
    for i in range(calls):
        B = _rhs(ctx, g.n, nrhs, i)
        o = ref.pcg(lap, apply, B.T, s["tol"], s["maxiter"], dtype=dtype)
        X.append(o.x.T.float().cpu())
        iters.append(o.iters)
        conv.append(o.relres <= s["tol"])
    return dict(g=g, key=key, X=X, iters=iters, conv=conv,
                pick=list(range(calls)), nrhs=nrhs)
