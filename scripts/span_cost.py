#!/usr/bin/env python3
"""What the port's layer spans cost on the host, detached and attached.

    python3 scripts/span_cost.py [--device cuda] [--side 64] [--pairs 12]

One process, so host speed (which moves from process to process) cancels:

1. A span site alone (``with span("x") as sp: if sp: sp.set(k=1)``),
   ``--sites`` times with no tracer attached, then with one attached and
   no profiler running: nanoseconds a site, the median of five rounds.
2. Whole calls alternated detached / attached / attached / detached on
   the main path at ``--side``^3 (grid3d uniform, seed 2, nnz-sort, chunk
   256, fill_slack 32, strict, 5 retries, key [0, 0]): ``--pairs`` solves
   of 8 seeded columns to 1e-6, and ``--factor-pairs`` factor calls; for
   each, the mean wall time of either side and the layer spans an
   attached call records.

Prints one JSON line per measurement, the card's name and power limit
first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def site_ns(n: int) -> float:
    from repro_torch.obs.tracing import span
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("cost.site") as sp:
            if sp:
                sp.set(k=1)
    return (time.perf_counter_ns() - t0) / n


def alternate(run, pairs: int, sync) -> dict:
    """``run()`` in turns detached, attached, attached, detached; the
    mean wall of each side and the spans an attached call records."""
    from repro_torch.obs import tracing
    walls = {"detached": [], "attached": []}
    spans = []
    for k in range(2 * pairs):
        on = k % 4 in (1, 2)
        t = tracing.Tracer()
        if on:
            tracing.attach(t)
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        walls["attached" if on else "detached"].append(
            time.perf_counter() - t0)
        tracing.detach()
        if on:
            spans.append(len(t.layer_spans()))
    return {side: statistics.mean(w) for side, w in walls.items()} | {
        "spans_per_call": statistics.mean(spans), "pairs": pairs,
        "walls": walls}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=64)
    ap.add_argument("--sites", type=int, default=200_000)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--factor-pairs", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core.solver import Solver
    from repro_torch.data import graphs
    from repro_torch.obs import tracing
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    card = "cpu"
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = {"detached": [], "attached": []}
    for _ in range(5):
        out["detached"].append(site_ns(args.sites))
        tracing.attach(tracing.Tracer())
        out["attached"].append(site_ns(args.sites))
        tracing.detach()
    print(json.dumps({"what": "site_ns", "sites": args.sites,
                      **{k: statistics.median(v) for k, v in out.items()},
                      "rounds": out}), flush=True)

    s = args.side
    g = cs.permuted(graphs.grid3d(s, s, s, "uniform", seed=2))
    kw = dict(chunk=256, fill_slack=32, strict=True, max_retries=5,
              device=dev)
    key = np.zeros(2, np.uint32)
    h = Solver(**kw).factor(g, key)
    rng = np.random.default_rng(0)
    B = rng.normal(size=(8, g.n)).astype(np.float32)
    B = torch.from_numpy(B - B.mean(axis=1, keepdims=True)).to(dev)
    h.solve(B, tol=1e-6, maxiter=500)
    r = alternate(lambda: h.solve(B, tol=1e-6, maxiter=500), args.pairs,
                  sync)
    print(json.dumps({"what": "solve8", "n": g.n, **r}), flush=True)
    r = alternate(lambda: Solver(**kw).factor(g, key), args.factor_pairs,
                  sync)
    print(json.dumps({"what": "factor", "n": g.n, **r}), flush=True)


if __name__ == "__main__":
    main()
