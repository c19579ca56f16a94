"""The benchmark's runner: finds a cell, its configuration, its traffic
mix, its limits and its per-layer metric readers by the names in
``BENCHMARK.json``, runs the traffic's driver (set-up, the measured
window, the comparison with the plain reference) and prints the result.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own:

* ``portbench/configs/<config>.json``: the deployment (graph, factor and
  solve settings, the guarantees it states); its graph's ``generator``
  and ``ordering`` are ``portbench/generators/<generator>.py`` and
  ``portbench/orderings/<ordering>.py`` (``portbench/graphs.py``);
* ``portbench/traffic/<mix>.json``: the mix's parameters, and the
  ``driver`` that reads them (``portbench/drivers/<driver>.py``);
* ``portbench/limits/<cell>.json``: the limit of each number compared;
* ``portbench/metrics/<metric>.py``: a ``read(ctx)`` that returns the
  metric from the run's spans, counters and trace, or None.

A driver module has ``setup(ctx) -> state``, ``window(ctx, state) ->
outputs`` (measures, fills ``ctx.e2e``, ``ctx.counters``, ``ctx.spans``,
``ctx.summary``; reads what the check needs from the program once the
window has closed), optionally ``close(state)`` (stops what the set-up
started), ``check(ctx, outputs)`` (the reference's side: appends to
``ctx.checks``) and ``control(ctx, dtype) -> outputs`` (the reference in
``dtype`` put in the program's place, at the cell's size: the control the
limits are set against; ``portbench/tools/controls.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return (not math.isnan(self.value)) and self.value <= self.limit


@dataclasses.dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    base: Path
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    setup_s: float = 0.0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: object = None
    summary: object = None          # tracing.TraceSummary of --trace 1
    notes: List[str] = dataclasses.field(default_factory=list)
    checks: List[Check] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0

    def check(self, name: str, value: float) -> None:
        """Record a number compared, against its limit in the cell's
        limits file."""
        self.checks.append(Check(name, float(value),
                                 float(self.limits[name])))


_LOADED: Dict[Path, object] = {}


def load_module(path: Path, name: str):
    """The module of the file at ``path``, loaded once a process: every
    caller of one file gets the same module."""
    path = Path(path).resolve()
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_of(bench: dict, cell: dict, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == cell["config"]:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration named {cell['config']!r}")


def traffic_of(cell: dict, base: Path = HERE) -> dict:
    return load_json(base / "traffic" / f"{cell['traffic']}.json")


def limits_of(cell: dict, base: Path = HERE) -> dict:
    return load_json(base / "limits" / f"{cell['name']}.json")


def driver(name: str, base: Path = HERE):
    return load_module(base / "drivers" / f"{name}.py",
                       f"portbench_driver_{name}")


def reader(metric: str, base: Path = HERE):
    return load_module(base / "metrics" / f"{metric}.py",
                       "portbench_metric_" + metric.replace(".", "_"))


def metrics_of(bench: dict, cell: dict, kind: str) -> List[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those without a
    ``workloads`` key, and those that list the cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def make_context(bench: dict, name: str, *, seed: int, seconds: float,
                 trace: bool, device, t_start: float,
                 config: Optional[dict] = None,
                 traffic: Optional[dict] = None,
                 root: Path = ROOT) -> Context:
    """A run's context.  ``root`` is the checkout whose ``BENCHMARK.json``
    and ``portbench/`` files name the cell; ``config`` and ``traffic``
    replace the cell's files (the tests' small sizes)."""
    from .tracing import Spans
    cell = find_cell(bench, name)
    base = root / "portbench"
    return Context(cell=cell,
                   config=config if config is not None
                   else config_of(bench, cell, root),
                   traffic=traffic if traffic is not None
                   else traffic_of(cell, base),
                   limits=limits_of(cell, base), base=base, seed=int(seed),
                   seconds=float(seconds), trace=bool(trace), device=device,
                   t_start=t_start, spans=Spans())


def execute(ctx: Context) -> Context:
    """Set-up, the window, then the comparison with the reference once the
    program's state is freed."""
    import torch
    cuda = ctx.device.type == "cuda"
    drv = driver(ctx.traffic["driver"], ctx.base)
    if ctx.trace:
        from .tracing import warm_up
        warm_up()
    state = drv.setup(ctx)
    if cuda:
        torch.cuda.synchronize()
    ctx.setup_s = time.perf_counter() - ctx.t_start
    outputs = drv.window(ctx, state)
    if cuda:
        torch.cuda.synchronize()
        ctx.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    if hasattr(drv, "close"):
        drv.close(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    drv.check(ctx, outputs)
    ctx.counters["check_s"] = time.perf_counter() - t_check
    return ctx


def correct(ctx: Context) -> bool:
    return bool(ctx.checks) and all(c.ok for c in ctx.checks)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(bench: dict, ctx: Context, device_info: dict) -> dict:
    """The result's last line: the end-to-end metrics (``--trace 0``) or
    the per-layer ones (``--trace 1``), the device, and last the numbers
    compared beside their limits."""
    metrics = {}
    if ctx.trace:
        for m in metrics_of(bench, ctx.cell, "per_layer"):
            v = reader(m["name"], ctx.base).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, ctx.cell, "end_to_end"):
            v = ctx.setup_s if m["name"] == "setup_s" else ctx.e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct(ctx), "attempted": ctx.attempted,
           "failed": ctx.failed, "metrics": metrics, "device": device_info}
    if ctx.trace and ctx.summary is not None:
        out["breakdown"] = {"device_ops": ctx.summary.device_ops,
                            "idle_gaps": ctx.summary.idle_gaps}
    out["checks"] = {c.name: {"value": c.value if math.isfinite(c.value)
                              else str(c.value), "limit": c.limit}
                     for c in ctx.checks}
    return out


def prepare_program() -> None:
    """Put the program's package on the path, and keep its kernel build
    inside this checkout at a fixed path."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import runtime
    runtime.BUILD_DIR = ROOT / "build" / "repro_torch_kernels"


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="portbench: one run of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = benchmark()
    cell = find_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    prepare_program()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    ctx = make_context(bench, args.workload, seed=args.seed,
                       seconds=args.seconds, trace=bool(args.trace),
                       device=dev, t_start=t_start)
    execute(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the port must not load: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 4
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(cell["chips"]),
            "memory_peak_bytes": ctx.memory_peak_bytes}
    if ctx.trace and ctx.summary is not None:
        info["busy_s"] = ctx.summary.busy_s
        info["window_s"] = ctx.summary.window_s
    line = result_line(bench, ctx, info)
    for note in ctx.notes:
        print(f"portbench: {note}", file=sys.stderr)
    print("portbench: counters " + json.dumps(
        {k: v for k, v in ctx.counters.items()
         if isinstance(v, (int, float))}), file=sys.stderr)
    for c in ctx.checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
