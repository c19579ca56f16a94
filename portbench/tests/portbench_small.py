"""Shared set-up of the benchmark's CPU tests: cells shrunk to a small
grid, run on the CPU through the harness (the chip look skipped)."""
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

harness.prepare_program()
torch.set_num_threads(1)

SEED = 2 ** 31 + 12_345       # larger than 32 signed bits hold
CPU = torch.device("cpu")


def small(bench, name, side=6, root=ROOT, **traffic):
    """The cell's configuration and traffic at a ``side``³ grid."""
    cell = harness.find_cell(bench, name)
    cfg = harness.config_of(bench, cell, root)
    cfg["graph"]["side"] = side
    tr = harness.traffic_of(cell, root / "portbench")
    tr.update(traffic)
    return cfg, tr


def run_cell(name, *, seconds=2.0, trace=False, seed=SEED, side=6,
             root=ROOT, **traffic):
    """One run of a shrunk cell on the CPU; returns its context and its
    result line."""
    bench = harness.benchmark(root)
    cfg, tr = small(bench, name, side, root, **traffic)
    ctx = harness.make_context(bench, name, seed=seed, seconds=seconds,
                               trace=trace, device=CPU,
                               t_start=time.perf_counter(), config=cfg,
                               traffic=tr, root=root)
    harness.execute(ctx)
    return ctx, harness.result_line(bench, ctx, {"platform": "cpu"})
