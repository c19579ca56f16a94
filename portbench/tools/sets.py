"""Measure a cell's spread: sets of runs of ``portbench/run.py``, each run
a process of its own as in a check, the same seeds in every set; then for
each end-to-end metric each set's median and spread (quartile distance
over the median, ``statistics.quantiles``), and the bound five times the
widest spread would give.

    python3 portbench/tools/sets.py --workload uniform64.factor \\
        --seeds 11 12 13 14 15 16 --sets 2 [--trace-seeds 17 18 19]

Prints every run's result line as it comes (prefixed ``run``), then one
``summary`` line.  ``--trace-seeds`` adds ``--trace 1`` runs after the
sets.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, yardstick  # noqa: E402


def one_run(workload: str, seed: int, seconds: int, trace: int) -> dict:
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True)
    tail = [ln for ln in out.stderr.splitlines()
            if ln.startswith(("check ", "portbench:"))]
    line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    try:
        res = json.loads(line)
    except json.JSONDecodeError:
        res = {"error": out.stderr[-2000:]}
    res.update(workload=workload, seed=seed, trace=trace, rc=out.returncode,
               process_s=time.perf_counter() - t0, stderr_tail=tail)
    print("run " + json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    seconds = int(harness.benchmark()["run_seconds"])
    sets = [[one_run(args.workload, s, seconds, 0) for s in args.seeds]
            for _ in range(args.sets)]
    for s in args.trace_seeds:
        one_run(args.workload, s, seconds, 1)
    summary = {"workload": args.workload, "metrics": {}}
    names = {m for runs in sets for r in runs for m in r.get("metrics", {})}
    for name in sorted(names):
        per = []
        for runs in sets:
            vals = [r["metrics"][name]["value"] for r in runs
                    if name in r.get("metrics", {})]
            per.append({"values": vals,
                        "median": statistics.median(vals) if vals else None,
                        "spread": yardstick.spread(vals)
                        if len(vals) >= 2 else None})
        widest = max((p["spread"] for p in per if p["spread"] is not None),
                     default=None)
        summary["metrics"][name] = {
            "sets": per, "widest_spread": widest,
            "bound_5x": None if widest is None else max(5 * widest, 0.01)}
    summary["correct"] = all(r.get("correct") for runs in sets for r in runs)
    print("summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
