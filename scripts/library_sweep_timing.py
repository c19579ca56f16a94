#!/usr/bin/env python3
"""The library path's level sweeps ell_sweep and ell_sweep_multi on one GPU,
for any tree of the port.

    python3 scripts/library_sweep_timing.py             # this checkout
    python3 scripts/library_sweep_timing.py --src OTHER/src --cache DIR

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``)
and times its ``kernels.spmv.ell_sweep`` (1 column) and
``ell_sweep_multi`` (8 columns) on the level-sorted schedules
(``build_schedules_device``) of the main path's 64^3 factor
(grid3d(64,64,64,'uniform',seed=2), nnz-sort, chunk 256, fill_slack 32,
strict, key 0).  ``--cache DIR`` saves the factor's host arrays there on
the first run and loads them on later ones, so trees compared in one call
sweep the same bytes and factor once.

Printed, one JSON line each, the card's name and power limit first:

* ``level``: the largest and an average forward level alone (one plan
  entry a call), 1 and 8 columns: the call's device time (busy time of 20
  back-to-back calls in one torch.profiler trace, over 20), the sweep
  kernel's own, the CUDA-event mean, the wrapper's host time,
  torch.sparse.mm on the level's live slots in CSR, and the bytes bound;
* ``chain``: a solve over a 4,096-level path (one row of one slot a
  level), and over 1,024-level paths whose rows also read 32, 160, 288
  and 592 rows of level 0, per level: the kernel's device time, the
  call's busy time, the event time; in a tree with the level walk, with
  its runs (``pieces`` false: a block sweeps up to 64 levels in turn) and
  with walk tables of pieces only (every level hands off through the
  done counter);
* ``prefix``: the forward solve at 1 column cut after its first k levels,
  for 16 values of k: the sweep kernels' device time, and per segment
  between two cuts its time per level, rows, levels whose rows fit one
  block and levels with rows over 32 slots;
* ``solve``: one whole forward solve (``ops.trisolve_panels``) at 1 and 8
  columns: device busy time, kernel time, events, event time, launches,
  torch.triangular_solve on the factor's lower part in CSR (cuSPARSE's
  triangular solve) and its distance from the kernel's result, the bytes
  bound, the design's chain time (the plan's levels times this tree's
  one-slot path level through the done counter, or its per-level launch
  in a tree without the walk; not a limit of the card), bit equality with
  the full-row composition and the relative distance from the plain
  version run on the card;
* ``apply``: one preconditioner apply (forward, D^-1, backward) at 1 and 8
  columns: wall (CUDA events), device busy time, idle share, device
  events, launches and the sweeps' C calls.

To compare two trees, run them in one call on one card, in turns
(A, B, B, A).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("n", "col_ptr", "rows", "vals", "D")
SIDE = 64


def load_factor(dev, cache):
    """The 64^3 factor of key 0 as an ACFactor: built on the card by this
    tree on the first run, else read from ``cache``."""
    import numpy as np
    from repro_torch.core.ref_ac import ACFactor
    path = Path(cache) / "factor.npz" if cache else None
    if path is not None and path.exists():
        z = np.load(path)
        return ACFactor(n=int(z["n"]), col_ptr=z["col_ptr"], rows=z["rows"],
                        vals=z["vals"], D=z["D"])
    import chip_smoke as cs
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.parac import factorize_wavefront
    from repro_torch.data import graphs
    g = cs.permuted(graphs.grid3d(SIDE, SIDE, SIDE, "uniform", seed=2))
    f = factorize_wavefront(g, key_from_seed(0), chunk=256, fill_slack=32,
                            strict=True, device=dev)
    arrays = {"n": np.array(f.n), **{k: np.array(getattr(f, k))
                                     for k in FIELDS[1:]}}
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **arrays)
    return ACFactor(n=f.n, col_ptr=arrays["col_ptr"], rows=arrays["rows"],
                    vals=arrays["vals"], D=arrays["D"])


def level_csr(sched, lv, dev):
    """(rows, live slots, csr, cols, vals) of level ``lv``'s slab: its live
    slots in CSR, for torch.sparse.mm."""
    import torch
    lo, hi = int(sched.row_ptr[lv]), int(sched.row_ptr[lv + 1])
    k = int(sched.level_k[lv])
    c, v = sched.cols[lo:hi, :k], sched.vals[lo:hi, :k]
    lens = sched.row_len[lo:hi]
    mask = torch.arange(k, device=dev)[None, :] < lens[:, None]
    crow = torch.zeros(hi - lo + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(lens.long(), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        csr = torch.sparse_csr_tensor(crow, c[mask].long(), v[mask],
                                      size=(hi - lo, sched.n),
                                      check_invariants=False)
    return hi - lo, int(lens.sum()), csr, c, v


def kernel_names(walk: bool, B: int):
    return ("walk_kernel",) if walk else (
        "ell_sweep_kernel" if B == 1 else "ell_sweep_multi_kernel",)


def sweep_arg(spmv, sched, plan, dev):
    """What this tree's sweeps take after y for ``plan``: its walk tables
    (the schedule's own for its whole plan), or, in a tree that launches
    once per level, the plan itself."""
    if not hasattr(spmv, "sweep_walk"):
        return plan
    return sched.walk if plan is sched.plan else spmv.sweep_walk(plan, dev)


def chain_us(cs, spmv, dev, chain, B, pieces=False):
    """``chip_smoke.chain_per_level_us`` in a tree with the walk; in one
    without it, the same per level of its per-level launches."""
    import torch
    if hasattr(spmv, "sweep_walk"):
        return cs.chain_per_level_us(dev, chain, B, pieces)
    kernel = spmv.ell_sweep if B == 1 else spmv.ell_sweep_multi
    y = torch.ones((chain.n,) if B == 1 else (chain.n, B), device=dev)

    def fn():
        y.fill_(1.0)
        kernel(chain.cols, chain.vals, chain.row_len, chain.row_ids, y,
               chain.plan)
    levels = chain.plan.shape[0]
    k_ms = kernel_ms(cs, fn, kernel_names(False, B), n=5, launches=levels)
    busy, _ = cs.device_busy_ms(fn)
    return dict(kernel=None if k_ms is None else k_ms * 1e3 / levels,
                busy=None if busy is None else busy * 1e3 / levels,
                event=cs.time_ms(fn, reps=5) * 1e3 / levels)


def kernel_ms(cs, fn, names, n=20, launches=1):
    """Device time of one call of ``fn`` in the sweep kernel (``names``):
    the mean launch in a trace of ``n`` calls times the call's
    ``launches``; None when the trace holds no such launch (a trace can
    lose records)."""
    for k in names:
        t = cs.kernel_device_ms(fn, lambda: None, k, n=n)
        if t is not None:
            return t * launches
    return None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--cache", default=None,
                    help="directory to save the factor to or load it from")
    ap.add_argument("--tag", default="", help="label printed on each line")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures on a GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import chip_smoke as cs
    from repro_torch.core.trisolve import (build_schedules_device,
                                           make_preconditioner_from_schedules)
    from repro_torch.kernels import ops, runtime, spmv
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runtime.build(["ell_spmv", "ell_spmv_multi"])
    t0 = time.time()
    f = load_factor(dev, args.cache)
    fwd, bwd = build_schedules_device(f, device=dev)
    torch.cuda.synchronize()
    walk = hasattr(spmv, "sweep_walk")
    common = dict(tag=args.tag, src=args.src, card=card, walk=walk)
    rows = fwd.plan[:, 1]
    per_block = np.array([256 // spmv.group_width(int(k))
                          for k in fwd.plan[:, 2]])
    print(json.dumps(dict(
        kind="schedules", seconds=time.time() - t0,
        fwd_levels=int(fwd.plan.shape[0]), bwd_levels=int(bwd.plan.shape[0]),
        K=fwd.K, fwd_blocks=int((-(-rows // per_block)).sum()),
        fwd_levels_in_one_block=int((rows <= per_block).sum()),
        fwd_levels_over_32_slots=int((fwd.plan[:, 2] > 32).sum()),
        fwd_rows_quantiles=np.quantile(rows, [0, .1, .25, .5, .75, .9, 1])
        .tolist(), **common)), flush=True)
    n = fwd.n
    sweep_args = (fwd.cols, fwd.vals, fwd.row_len, fwd.row_ids)
    gen = torch.Generator(device=dev).manual_seed(0)
    Y = {1: torch.randn(n, generator=gen, device=dev),
         8: torch.randn((n, 8), generator=gen, device=dev)}

    # one level alone
    for which in ("largest", "average"):
        lv = cs.pick_level(fwd, which)
        plan = cs.level_plan(fwd, lv)
        arg = sweep_arg(spmv, fwd, plan, dev)
        R, live, csr, c, v = level_csr(fwd, lv, dev)
        for B, y0 in Y.items():
            kernel = spmv.ell_sweep if B == 1 else spmv.ell_sweep_multi
            y = y0.clone()

            def fn(y=y, kernel=kernel, arg=arg):
                kernel(*sweep_args, y, arg)
            x = y0.reshape(n, B)
            nbytes = (live * 8 + R * 8 + cs.gathered_bytes(c, v, B)
                      + 2 * R * B * 4)
            print(json.dumps(dict(
                kind="level", level=which, lv=lv, B=B, rows=R,
                level_k=int(fwd.level_k[lv]), live_slots=live,
                device_ms=cs.device_ms_per_launch(fn),
                kernel_ms=kernel_ms(cs, fn, kernel_names(walk, B)),
                event_ms=cs.time_ms(fn), host_ms=cs.host_ms_per_call(fn),
                library_ms=cs.time_ms(lambda: torch.sparse.mm(csr, x)),
                **cs.bound(nbytes, 2 * B * live), **common)), flush=True)

    # the chain of hand-offs, and the same with longer rows
    per_level = {}
    for width, levels in ((1, cs.CHAIN_LEVELS), (33, 1024), (161, 1024),
                          (289, 1024), (593, 1024)):
        chain = cs.chain_schedule(dev, levels, width)
        for B in Y:
            for pieces in ((False, True) if walk else (False,)):
                t = chain_us(cs, spmv, dev, chain, B, pieces)
                if width == 1 and (pieces or not walk):
                    per_level[B] = t
                print(json.dumps(dict(kind="chain", B=B, levels=levels,
                                      width=width, pieces=pieces,
                                      **{f"{k}_us": v for k, v in t.items()},
                                      **common)), flush=True)

    # where a solve's time goes: the forward solve cut after its first k
    # levels, for 16 values of k
    levels = int(fwd.plan.shape[0])
    cuts = np.unique(np.linspace(0, levels, 17).astype(int))[1:]
    prev, prev_k = 0.0, 0
    for k in cuts:
        plan = np.ascontiguousarray(fwd.plan[:k])
        arg = sweep_arg(spmv, fwd, plan, dev)
        y = Y[1].clone()

        def cut(y=y, arg=arg):
            spmv.ell_sweep(*sweep_args, y, arg)
        t = kernel_ms(cs, cut, kernel_names(walk, 1), n=5,
                      launches=1 if walk else int(k))
        if t is None:
            continue
        seg = fwd.plan[prev_k:k]
        per_block = np.array([256 // spmv.group_width(int(j))
                              for j in seg[:, 2]])
        print(json.dumps(dict(
            kind="prefix", levels=int(k), kernel_ms=t,
            segment_us_per_level=(t - prev) * 1e3 / (k - prev_k),
            segment_rows=int(seg[:, 1].sum()),
            segment_levels_in_one_block=int((seg[:, 1] <= per_block).sum()),
            segment_levels_over_32_slots=int((seg[:, 2] > 32).sum()),
            **common)), flush=True)
        prev, prev_k = t, int(k)

    # one whole forward solve
    live = int(fwd.row_len.sum())
    csr = cs.lower_csr(fwd)
    for B, y0 in Y.items():
        def solve(y0=y0):
            return ops.trisolve_panels(fwd, y0)
        got = solve()
        same = cs.bitwise_equal(got, ops.trisolve_panels_full(fwd, y0))
        plain = y0.clone()
        spmv.ell_sweep_plain(*sweep_args, plain, fwd.plan)
        rel = float((got - plain).abs().max()) / float(plain.abs().max())

        def library(y_in=y0.reshape(n, B)):
            return torch.triangular_solve(y_in, csr, upper=False,
                                          unitriangular=True).solution
        lib_rel = (float((library().reshape(got.shape) - got).abs().max())
                   / float(plain.abs().max()))
        runtime.reset_launches()
        solve()
        torch.cuda.synchronize()
        launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
        busy, events = cs.device_busy_ms(solve)
        per_level_us = per_level[B]["kernel"] or per_level[B]["busy"]
        print(json.dumps(dict(
            kind="solve", B=B, levels=levels, busy_ms=busy, events=events,
            kernel_ms=kernel_ms(cs, solve, kernel_names(walk, B), n=5,
                                launches=1 if walk else levels),
            event_ms=cs.time_ms(solve, reps=10), launches=launches,
            library_ms=cs.time_ms(library, reps=10),
            **cs.bound(cs.solve_bytes(fwd, B), 2 * B * live),
            chain_ms=levels * per_level_us / 1e3,
            same_bits_as_full_row=same, rel_err_vs_plain=rel,
            library_rel_err=lib_rel, **common)),
            flush=True)

    # one whole apply
    apply = make_preconditioner_from_schedules(fwd, bwd, f.to_device(dev).D)
    for B, y0 in Y.items():
        def fn(y0=y0):
            return apply(y0)
        wall = cs.time_ms(fn, reps=10)
        runtime.reset_launches()
        with cs.SweepCalls() as calls:
            fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
        busy, events = cs.device_busy_ms(fn)
        print(json.dumps(dict(
            kind="apply", B=B, wall_ms=wall, busy_ms=busy, events=events,
            idle_share=None if busy is None else 1 - busy / wall,
            launches=launches, c_calls=calls.n, **common)), flush=True)


if __name__ == "__main__":
    main()
