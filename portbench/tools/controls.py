"""The control of a cell's comparison: the plain reference put in the
program's place, computed in a lower precision than the configuration
states (bfloat16 for its float32), at the cell's own size, judged by the
cell's own check on each seed given.  Its readings are the upper ends the
limits in ``portbench/limits/`` are set below.  The benchmark's own runs
never run it.

    python3 portbench/tools/controls.py --workload <cell> --seeds 1 2 3 \\
        [--dtype bfloat16] [--device cuda]

With ``--program-tol T --seconds S`` it reads a fault instead: the
program itself, set up once, solving to ``T`` where the configuration
states a tighter tol, for a window of ``S`` seconds per seed, judged by
the cell's check at the stated tol (cells whose configuration's ``solve``
tol is the one they solve to).

Prints one JSON line per seed: the numbers compared and whether each
passed its limit (a sound control fails at least one).
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402
from portbench import reference as ref  # noqa: E402


def readings(bench, name: str, seed: int, dtype, device,
             config=None, traffic=None, seconds=None):
    """One seed's control readings: the cell's checks over what the
    reference computed in ``dtype`` in the program's place."""
    ctx = harness.make_context(
        bench, name, seed=seed,
        seconds=seconds if seconds is not None else bench["run_seconds"],
        trace=False, device=device, t_start=time.perf_counter(),
        config=config, traffic=traffic)
    drv = harness.driver(ctx.traffic["driver"], ctx.base)
    drv.check(ctx, drv.control(ctx, dtype))
    return ctx.checks


def loose_tol_readings(bench, name: str, seeds, tol: float, device,
                       seconds: float, config=None):
    """Each seed's readings of the program solving to ``tol``: one
    set-up, a window per seed, then the cell's check of each window at
    the configuration's own tol."""
    def context(seed, config=None):
        return harness.make_context(
            bench, name, seed=seed, seconds=seconds, trace=False,
            device=device, t_start=time.perf_counter(), config=config)
    first = context(seeds[0], config)
    stated = first.config
    loose = copy.deepcopy(stated)
    loose["solve"]["tol"] = tol
    first.config = loose
    drv = harness.driver(first.traffic["driver"], first.base)
    state = drv.setup(first)
    runs = []
    for seed in seeds:
        ctx = context(seed, loose)
        runs.append((ctx, drv.window(ctx, state)))
    if hasattr(drv, "close"):
        drv.close(state)
    del state
    for ctx, out in runs:
        ctx.config = stated
        drv.check(ctx, out)
        yield ctx.seed, ctx.checks


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program-tol", type=float)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    harness.prepare_program()
    bench = harness.benchmark()
    dev = torch.device(args.device)
    if args.program_tol is not None:
        for seed, checks in loose_tol_readings(
                bench, args.workload, args.seeds, args.program_tol, dev,
                args.seconds):
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "program_tol": args.program_tol,
                "checks": {c.name: {"value": c.value, "limit": c.limit,
                                    "ok": c.ok} for c in checks},
                "fails": not all(c.ok for c in checks)}), flush=True)
        return 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = readings(bench, args.workload, seed,
                          ref.dtype_of(args.dtype), dev)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "dtype": args.dtype,
            "seconds": time.perf_counter() - t0,
            "checks": {c.name: {"value": c.value, "limit": c.limit,
                                "ok": c.ok} for c in checks},
            "fails": not all(c.ok for c in checks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
