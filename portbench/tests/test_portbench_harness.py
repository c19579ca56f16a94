"""The harness finds every cell's configuration, traffic, limits, driver
and metric readers by name; a new cell, traffic mix and metric come from
files alone; the result's last line has the keys the contract names."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench_small import ROOT, harness, run_cell

BENCH = harness.benchmark()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_each_cell_finds_its_files_by_name(cell):
    cfg = harness.config_of(BENCH, cell)
    assert cfg["name"] == cell["config"]
    tr = harness.traffic_of(cell)
    drv = harness.driver(tr["driver"])
    for fn in ("setup", "window", "check", "control"):
        assert callable(getattr(drv, fn))
    assert harness.limits_of(cell)
    for kind in ("end_to_end", "per_layer"):
        assert harness.metrics_of(BENCH, cell, kind)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(harness.reader(metric["name"]).read)
    moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert "workloads" not in moves or cell in moves["workloads"]


def test_a_new_cell_traffic_and_metric_from_files_alone(tmp_path):
    """A checkout that adds a traffic mix, a cell's limits and a per-layer
    metric as files, and entries in BENCHMARK.json, runs the new cell
    with no file of the harness edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "portbench/traffic/solve4_closed.json").write_text(json.dumps(
        {"driver": "solve_loop", "key": [0, 0], "nrhs": 4}))
    (root / "portbench/limits/contrast64.solve4.json").write_text(
        json.dumps({"resid_ratio": 1e3, "unconverged": 0, "iters_gap": 10}))
    (root / "portbench/metrics/solve_calls.py").write_text(
        "def read(ctx):\n    return float(ctx.counters['calls'])\n")
    bench["workloads"].append(
        {"name": "contrast64.solve4", "config": "poisson3d_contrast_64",
         "traffic": "solve4_closed", "chips": 1, "why": "four columns"})
    bench["end_to_end"][1]["workloads"].append("contrast64.solve4")
    bench["per_layer"].append(
        {"name": "solve_calls", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "core.pcg fleet PCG",
         "moves": "solve_s", "workloads": ["contrast64.solve4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    ctx, line = run_cell("contrast64.solve4", root=root, trace=True,
                         seconds=1.0)
    assert line["correct"]
    assert line["metrics"]["solve_calls"]["value"] == ctx.counters["calls"]
    ctx, line = run_cell("contrast64.solve4", root=root, seconds=1.0)
    assert set(line["metrics"]) == {"solve_s", "setup_s"}


GRID2D = """
import numpy as np
from portbench.graphs import Edges


def build(graph):
    s = int(graph["side"])
    vid = np.arange(s * s, dtype=np.int32).reshape(s, s)
    src = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()])
    dst = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()])
    return Edges(s * s, src, dst, np.ones(src.shape[0], np.float32))
"""

NATURAL = """
import numpy as np


def order(g, seed):
    return np.arange(g.n, dtype=np.int32)
"""


def test_a_new_configuration_generator_and_ordering_from_files_alone(
        tmp_path):
    """A checkout that adds a graph generator, an elimination ordering and
    a configuration that names them, as files, and entries in
    BENCHMARK.json, builds the new graph and runs a cell on it with no
    file of the harness edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "portbench/generators/grid2d.py").write_text(GRID2D)
    (root / "portbench/orderings/natural.py").write_text(NATURAL)
    cfg = json.loads(
        (ROOT / "portbench/configs/poisson3d_uniform_64.json").read_text())
    cfg.update(name="poisson2d_uniform_32",
               graph={"generator": "grid2d", "side": 32,
                      "ordering": "natural", "ordering_seed": 0})
    (root / "portbench/configs/poisson2d_uniform_32.json").write_text(
        json.dumps(cfg))
    (root / "portbench/limits/uniform2d32.solve8.json").write_text(
        json.dumps({"resid_ratio": 1e3, "unconverged": 0, "iters_gap": 5}))
    bench["configs"].append(
        {"name": "poisson2d_uniform_32", "source": "a 2D grid",
         "file": "portbench/configs/poisson2d_uniform_32.json",
         "reduced": [], "why": "a generator added as a file"})
    bench["workloads"].append(
        {"name": "uniform2d32.solve8", "config": "poisson2d_uniform_32",
         "traffic": "solve8_closed", "chips": 1, "why": "a 2D grid"})
    bench["end_to_end"][1]["workloads"].append("uniform2d32.solve8")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    from portbench import graphs
    g = graphs.build(dict(cfg["graph"], side=5), root / "portbench")
    assert g.n == 25 and g.m == 40
    assert np.array_equal(g.src, np.sort(g.src))
    ctx, line = run_cell("uniform2d32.solve8", root=root, seconds=1.0)
    assert line["correct"] and ctx.counters["n"] == 36
    assert set(line["metrics"]) == {"solve_s", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    ctx, line = run_cell("uniform64.factor", trace=trace, seconds=1.0)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    assert line["correct"] is True and line["failed"] == 0
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    if not trace:
        assert set(line["metrics"]) == {"factor_s", "setup_s"}
        for m in line["metrics"].values():
            assert m["value"] > 0 and m["unit"] == "s"


def _run_py(cwd, env):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "uniform64.factor", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_run_refuses_without_a_card():
    out = _run_py(ROOT, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_run_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run_py(tmp_path, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
