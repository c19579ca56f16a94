"""Sweep of the offered rate of a served cell: one set-up, then the
cell's open loop at each rate for ``--seconds``, printing per rate the
completed requests a second, the latency percentiles and whether the
queue grew over the window (the mean queue wait of its last third against
its first).  The highest rate whose queue does not grow is the knee the
cell's fixed rate is taken from; the benchmark's runs never sweep.

    python3 portbench/tools/rate_sweep.py --workload uniform64.serve \\
        --rates 8 12 16 20 24 --seconds 30 --seed 7
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness, yardstick  # noqa: E402


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="uniform64.serve")
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness.prepare_program()
    bench = harness.benchmark()
    dev = torch.device(args.device)
    ctx = harness.make_context(bench, args.workload, seed=args.seed,
                               seconds=args.seconds, trace=False, device=dev,
                               t_start=time.perf_counter())
    drv = harness.driver(ctx.traffic["driver"])
    state = drv.setup(ctx)
    print(json.dumps({"setup_s": time.perf_counter() - ctx.t_start}),
          flush=True)
    try:
        for i, rate in enumerate(args.rates):
            tr = dict(ctx.traffic, rate=rate)
            c = harness.make_context(bench, args.workload,
                                     seed=args.seed + i + 1,
                                     seconds=args.seconds, trace=False,
                                     device=dev, t_start=time.perf_counter(),
                                     traffic=tr)
            due, cols = drv.mix(tr, state["gids"], args.seconds)
            state.update(due=due, B=drv._columns(c, state["g"].n, cols, 0))
            drv.window(c, state)
            q = np.asarray(c.counters["queue_wait_s"])
            third = max(len(q) // 3, 1)
            lat = c.counters["latency_s"]
            print(json.dumps({
                "rate": rate, "requests": len(due),
                "completed_per_s": (len(due) - c.failed)
                / c.counters["window_s"],
                "failed": c.failed,
                "latency_p50_ms": 1e3 * yardstick.percentile(lat, 50),
                "latency_p95_ms": 1e3 * yardstick.percentile(lat, 95),
                "queue_wait_first_third_ms": 1e3 * float(q[:third].mean()),
                "queue_wait_last_third_ms": 1e3 * float(q[-third:].mean()),
                "lane_occupancy_pct": 100.0 * c.counters["column_iters"]
                / max(c.counters["ticks"] * c.counters["slots"]
                      * c.counters["iters_per_tick"], 1),
                "ticks": c.counters["ticks"],
                "window_s": c.counters["window_s"]}), flush=True)
    finally:
        drv.close(state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
