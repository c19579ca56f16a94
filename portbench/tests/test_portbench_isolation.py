"""Nothing a run imports is JAX or the JAX package: every module of the
benchmark and of the program that a run loads, imported in a fresh
interpreter, leaves no top-level module named ``jax``, ``jaxlib``,
``flax`` or ``repro`` (compared whole: ``repro_torch`` passes).  The
reference imports nothing of the program."""
import ast
import os
import subprocess
import sys

from portbench_small import ROOT

PB = ROOT / "portbench"
SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_import_no_jax():
    for path in SOURCES:
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, f"{path}: {mod}"


def test_reference_imports_nothing_of_the_program():
    names = ["reference.py", "graphs.py", "yardstick.py"] + [
        str(p.relative_to(PB)) for d in ("generators", "orderings")
        for p in sorted((PB / d).glob("*.py"))]
    for name in names:
        for mod in _imports(PB / name):
            assert mod.split(".")[0] != "repro_torch", f"{name}: {mod}"


def test_a_run_loads_no_jax():
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
from portbench import harness
harness.prepare_program()
import torch
bench = harness.benchmark()
for cell in bench["workloads"]:
    harness.driver(harness.traffic_of(cell)["driver"])
for m in bench["per_layer"]:
    harness.reader(m["name"])
import portbench.tools.controls
import repro_torch.core.solver, repro_torch.serve, repro_torch.kernels.runtime
bad = sorted({{m.split(".")[0] for m in sys.modules}} & set({FORBIDDEN!r}))
print(",".join(bad))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
