"""Closed loop of factorizations: one client makes back-to-back calls, each
one the cell's whole construction of ``batch`` preconditioners of the
configuration's graph (engine, finalize, schedules and admission, to
usable handles), ending in a device synchronize.  ``batch`` 1 is
``Solver.factor``; more is one batched engine through
``FactorCache.factor_batched``.

The calls take their keys from ``keys``, a fixed list of batches, in an
order drawn from the seed, in whole passes over the list: the window
ends with the pass in which the deadline falls.  How many strict
attempts a key needs varies from key to key (its factor's fill), so a
window of keys drawn afresh, or a window cut inside a pass, would hold
different work under every seed or host speed; this way every run
factors the same keys, the same number of times, in another order.  A
cache keeps a key's handle until the next call admits other keys, so a
key is factored anew each time it comes round (the list holds at least
two batches).

Traffic parameters: ``batch``; ``keys``.

Checked against the reference: every member of one call drawn from the
seed: its factor (col_ptr, rows, vals, D) bit for bit, and its admitted
handle's preconditioner apply on seeded columns.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import graphs
from portbench import reference as ref
from portbench import yardstick
from portbench.tracing import Tracer

# the small graph the set-up factors once, to load the kernels
WARMUP_GRAPH = {"generator": "grid3d", "side": 8, "kind": "uniform",
                "seed": 0, "ordering": "nnz-sort", "ordering_seed": 0}
TRACE_CALL = 1      # the call --trace 1 traces
CHECK_LANES = 8     # columns of the preconditioner apply compared


def _program_graph(g):
    from repro_torch.core.laplacian import Graph
    return Graph(g.n, g.src, g.dst, g.w)


def _cache(ctx, batch: int):
    from repro_torch.core.solver import FactorCache, Solver
    f = ctx.config["factor"]
    kw = dict(chunk=f["chunk"], fill_slack=f["fill_slack"],
              strict=f["strict"], max_retries=f["max_retries"],
              device=ctx.device)
    return Solver(**kw) if batch == 1 else FactorCache(max_handles=batch,
                                                       **kw)


def _factor(cache, G, keys):
    if len(keys) == 1:
        return [cache.factor(G, keys[0])]
    return cache.factor_batched([G] * len(keys), list(keys))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _key_order(ctx, rng):
    """The calls' key batches, in the order this seed gives them."""
    keys = [np.asarray(b, np.uint32).reshape(-1, 2)
            for b in ctx.traffic["keys"]]
    return [keys[i] for i in rng.permutation(len(keys))]


def setup(ctx):
    tr = ctx.traffic
    batch = int(tr["batch"])
    g = graphs.build(ctx.config["graph"], ctx.base)
    small = graphs.build(WARMUP_GRAPH, ctx.base)
    cache = _cache(ctx, batch)
    rng = np.random.default_rng(ctx.seed)
    warm_keys = rng.integers(0, 2 ** 32, size=(batch, 2), dtype=np.uint32)
    _factor(cache, _program_graph(small), warm_keys)
    _sync(ctx.device)
    return dict(g=g, G=_program_graph(g), cache=cache, rng=rng, batch=batch,
                order=_key_order(ctx, rng))


def window(ctx, state):
    from repro_torch.kernels.runtime import LAUNCHES
    g, G, cache, rng, batch, order = (
        state[k] for k in ("g", "G", "cache", "rng", "batch", "order"))
    pick_call = int(rng.integers(0, len(order)))   # of the first pass
    trace_call = TRACE_CALL if ctx.trace else -1
    held = None
    calls, rounds, attempts, untraced = 0, 0, 0, []
    excluded = pause = 0.0   # the trace's reduction, outside the window
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    t_end = t0
    while time.perf_counter() < deadline or calls % len(order):
        keys = order[calls % len(order)]
        before = LAUNCHES.get("sample_clique_round", 0)
        tracer = Tracer() if calls == trace_call else None
        if tracer is not None:
            tracer.start()
        a = time.perf_counter()
        hs = _factor(cache, G, keys)
        _sync(ctx.device)
        t_end = time.perf_counter()
        excluded, pause = excluded + pause, 0.0
        n_rounds = LAUNCHES.get("sample_clique_round", 0) - before
        if tracer is not None:
            ctx.summary = tracer.stop()
            pause = time.perf_counter() - t_end
            deadline += pause
            ctx.counters["traced_round_launches"] = n_rounds
            ctx.counters["traced_bytes"] = sum(
                yardstick.round_bytes(g.n, g.m, h.factor.nnz) for h in hs)
        else:
            untraced.append((t_end - a, n_rounds))
        att = [int(np.log2(h.factor.stats["fill_slack"]
                           / ctx.config["factor"]["fill_slack"])) + 1
               for h in hs]
        ctx.spans.add("factor.call", a, t_end, rounds=n_rounds,
                      attempts=att)
        if calls == pick_call:
            held = list(zip(hs, keys))
        calls += 1
        rounds += n_rounds
        attempts += sum(att)
    window_s = t_end - t0 - excluded
    ctx.spans.add("window", t0, t_end, paused=excluded)
    ctx.e2e["factor_s"] = window_s / calls
    ctx.attempted = calls * batch
    ctx.counters.update(calls=calls, window_s=window_s, round_launches=rounds,
                        attempts=attempts, graphs=calls * batch,
                        untraced_s=sum(w for w, _ in untraced),
                        untraced_rounds=sum(r for _, r in untraced),
                        n=g.n, m=g.m)
    # what the check reads from the program, once the window has closed
    R = _check_columns(ctx, g.n)
    got = []
    for h, key in held:
        f = h.factor
        got.append((np.asarray(key, np.uint32),
                    ref.Factor(col_ptr=np.asarray(f.col_ptr, np.int64),
                               rows=np.asarray(f.rows),
                               vals=np.asarray(f.vals), D=np.asarray(f.D)),
                    h.precondition(R).cpu()))
    return dict(g=g, R=R.cpu(), got=got)


def _check_columns(ctx, n: int) -> torch.Tensor:
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
    return torch.randn((n, CHECK_LANES), generator=gen, device=ctx.device)


def check(ctx, out):
    """For each compared member, the reference's factor of the same graph
    and key, and its apply in float64 on the same columns."""
    g, dev = out["g"], ctx.device
    R = out["R"].to(dev)
    bad, errs = 0, []
    for key, f, Z in out["got"]:
        want = ref.factor(g.n, g.src, g.dst, g.w, key, device=dev)
        bad += ref.factor_mismatch(f, want)
        errs.append(ref.apply_error(Z.to(dev),
                                    ref.Apply(want, device=dev)(R)))
    ctx.check("factor_mismatch", bad)
    ctx.check("apply_err", ref.worst(errs))


def control(ctx, dtype):
    """The reference in ``dtype`` in the program's place: the drawn call's
    members factored, and applied, by the reference itself."""
    g = graphs.build(ctx.config["graph"], ctx.base)
    rng = np.random.default_rng(ctx.seed)
    rng.integers(0, 2 ** 32, size=(int(ctx.traffic["batch"]), 2),
                 dtype=np.uint32)                       # the warm-up's keys
    order = _key_order(ctx, rng)
    keys = order[int(rng.integers(0, len(order)))]
    R = _check_columns(ctx, g.n)
    got = []
    for key in keys:
        f = ref.factor(g.n, g.src, g.dst, g.w, key, dtype=dtype,
                       device=ctx.device)
        Z = ref.Apply(f, dtype=dtype, device=ctx.device)(R)
        got.append((key, f, Z.float().cpu()))
    return dict(g=g, R=R.cpu(), got=got)
