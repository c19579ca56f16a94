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
time per round.  Then 16 consecutive engine rounds from the middle of the
final attempt are traced: wall time, device busy time, idle share,
host-issued ops and device events per round, and the costliest device
ops.

To compare two trees, run them in one call on one card, in turns (A, B,
B, A); both trees must carry the layer spans (``parac.attempt`` and the
stages inside it), which the probe reads instead of patching the engine.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
    import numpy as np
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
    built = parac._build_pool(g, f.stats["fill_slack"], np.float32)
    s, st = parac._init_engine([built], [g.n], [key], n_pad=g.n,
                               P_pad=built[6],
                               W=max(parac._next_pow2(built[7]), 2),
                               chunk=256, device=dev)
    start = f.stats["rounds"] // 2
    parac._run_engine_batched(s, st, max_rounds=start)
    cs.log_engine_rounds("rounds", start, cs.engine_rounds_busy(s, st))


if __name__ == "__main__":
    main()
