#!/usr/bin/env python3
"""Where the 64^3 factor's time goes on one GPU, for any tree of the port.

    python3 scripts/factor_breakdown.py                 # this checkout
    python3 scripts/factor_breakdown.py --src OTHER/src

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``)
and factors chip_smoke.py's main cell, grid3d(64,64,64,'uniform',seed=2)
in nnz-sort order with chunk 256, fill_slack 32, strict retry and key 0,
through both paths' entry points: ``Solver().factor`` (the main path:
factor, schedules, admission) and ``factorize_wavefront`` (the library
path).  Each runs under chip_smoke.FactorProbe, which reads the
program's own layer spans (``repro_torch.obs.tracing``) and prints every
strict attempt (slack, W, rounds run, round of the first dropped edge,
wall time) and the split of factor_s into pools and uniforms, engine
rounds, finalize and compaction, schedules and admission, with the host
time per round.  Then the library path's rungs are built again, each stage
timed apart between device synchronizes: the edges' upload and ordering
(once), and for each rung the pools written on the device and the
``column_uniforms`` table.  Last, 16 consecutive engine rounds from the
middle of the final attempt are traced: wall time, device busy time,
idle share, host-issued ops and device events per round, and the
costliest device ops.

To compare two trees, run them in one call on one card, in turns (A, B,
B, A); both trees must carry the layer spans (``parac.attempt`` and the
stages inside it), which the probe reads instead of patching the engine,
and build their pools on the device (``parac._pool_edges``).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def prep_stages(parac, g, key, slacks, dev):
    """Print the factor's preparation of each rung in ``slacks`` as two
    stages timed apart between device synchronizes, the pools written on
    the device and the ``column_uniforms`` table (timed by wrapping the
    engine's reference to it), after the edges' one upload and ordering.
    Returns the last rung's pool."""
    import numpy as np
    import torch

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    real = parac.column_uniforms
    uniform_s = [0.0]

    def timed(*a, **k):
        t = clock()
        out = real(*a, **k)
        uniform_s[0] += clock() - t
        return out

    t = clock()
    edges = parac._pool_edges(g, np.float32, dev)
    print(f"[stages] edges uploaded and ordered: {g.m} edges "
          f"{clock() - t:.4f}s", flush=True)
    parac.column_uniforms = timed
    try:
        for slack in slacks:
            uniform_s[0] = 0.0
            t = clock()
            built = parac._build_pool(edges, slack)
            s, st = parac._init_engine(
                [built], [key], n_pad=g.n, P_pad=built.P,
                W=max(parac._next_pow2(built.dmax), 2), chunk=256)
            total = clock() - t
            print(f"[stages] fill_slack={slack} P={built.P} W={st.W}: "
                  f"device pool build {total - uniform_s[0]:.4f}s, "
                  f"column_uniforms {uniform_s[0]:.4f}s", flush=True)
            del s, st
    finally:
        parac.column_uniforms = real
    return built


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures on a GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import parac
    from repro_torch.core.column_math import key_from_seed
    from repro_torch.core.parac import factorize_wavefront
    from repro_torch.core.solver import Solver
    from repro_torch.data import graphs
    from repro_torch.kernels import runtime
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[breakdown] repro_torch from {parac.__file__}; {card}",
          flush=True)
    runtime.build(["sample_clique", "ell_spmv_fleet"])
    g = cs.permuted(graphs.grid3d(64, 64, 64, "uniform", seed=2))
    key = key_from_seed(0)
    kw = dict(chunk=256, fill_slack=32, strict=True)
    # warm-up: the first launches and allocations of each kernel
    warm = cs.permuted(graphs.SUITE["grid3d_uniform_16"]())
    Solver(device=dev, **kw).factor(warm, key)
    for tag in ("main", "library"):
        runtime.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        with cs.FactorProbe() as probe:
            if tag == "main":
                h = Solver(device=dev, **kw).factor(g, key)
                f = h.factor
            else:
                f = factorize_wavefront(g, key, device=dev, **kw)
            torch.cuda.synchronize()
        probe.report(tag, time.time() - t0)
        print(f"[{tag}] rounds={f.stats['rounds']} "
              f"fill_slack={f.stats['fill_slack']} nnz={f.nnz} launches "
              f"{dict(runtime.LAUNCHES)}", flush=True)
    slacks = [a["fill_slack"] for a in probe.attempts]
    built = prep_stages(parac, g, key, slacks, dev)
    s, st = parac._init_engine([built], [key], n_pad=g.n, P_pad=built.P,
                               W=max(parac._next_pow2(built.dmax), 2),
                               chunk=256)
    start = f.stats["rounds"] // 2
    parac._run_engine_batched(s, st, max_rounds=start)
    cs.log_engine_rounds("rounds", start, cs.engine_rounds_busy(s, st))


if __name__ == "__main__":
    main()
