"""The port's dry run (``repro_torch.launch.dryrun``) on fake process
groups, the counterpart of ``tests/test_substrates.py::test_dryrun_mini_mesh``
and of the reference's ``cell_applicable`` sweep:

* an 8-rank fake ``(2, 4)`` mesh runs the reference test's reduced qwen3
  config on ``ShapeCell("mini", "train", 128, 8)`` at ``grad_accum`` 2:
  ``status`` ok and ``argument_bytes`` the specs' local bytes, exactly;
* the probe extrapolation equals the full-depth count of an unrolled
  homogeneous config (flops, bytes and collective bytes, exactly), for a
  train and a decode cell;
* ``make_production_mesh`` builds the 16 x 16 and 2 x 16 x 16 meshes
  with the reference's axis names over fake groups of 256 and 512 ranks;
* every (arch, cell) the reference's ``cell_applicable`` skips is a
  ``skipped`` record with its note, and ``cell_applicable`` agrees on the
  others.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import torch.distributed as tdist                              # noqa: E402

from repro.configs import get_config as ref_get_config         # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES          # noqa: E402
from repro.configs.shapes import cell_applicable as ref_applicable  # noqa
from repro_torch.configs import get_config, get_smoke_config, list_archs  # noqa
from repro_torch.configs.shapes import SHAPES, ShapeCell, cell_applicable  # noqa
from repro_torch.distributed.pspec import mesh_shape           # noqa: E402
from repro_torch.distributed.steps import (make_abstract_inputs,  # noqa
                                           train_state_specs)
from repro_torch.launch import dryrun                          # noqa: E402
from repro_torch.launch import roofline as rl                  # noqa: E402
from repro_torch.launch.mesh import (init_fake_group,          # noqa: E402
                                     make_production_mesh)
from repro_torch.models.common import tree_leaves              # noqa: E402


@pytest.fixture
def fake_group():
    """A fake process group of the asked size, destroyed afterwards."""
    def start(world):
        if tdist.is_initialized():
            tdist.destroy_process_group()
        init_fake_group(world)

    try:
        yield start
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _mini_cfg():
    return dataclasses.replace(get_smoke_config("qwen3-14b"), d_model=64,
                               n_heads=8, n_kv_heads=4, head_dim=16,
                               d_ff=256, vocab=1024)


def _local_bytes(tree, specs, sizes):
    total = 0
    for a, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        n = a.element_size()
        for dim, part in zip(a.shape, spec):
            ext = 1
            for ax in ((part,) if isinstance(part, str) else (part or ())):
                ext *= sizes[ax]
            n *= dim // ext
        total += n
    return total


def test_dryrun_mini_mesh(fake_group):
    fake_group(8)
    mesh = _mesh((2, 4), ("data", "model"))
    cfg, cell = _mini_cfg(), ShapeCell("mini", "train", 128, 8)
    rec = dryrun.dry_run(cfg, mesh, cell, variant={"grad_accum": 2},
                         verbose=False)
    assert rec["status"] == "ok"
    sizes = mesh_shape(mesh).shape
    pspecs, ospecs = train_state_specs(cfg, mesh)
    params, opt = make_abstract_inputs(cfg, mesh, cell)
    want = _local_bytes(params, pspecs, sizes) + \
        _local_bytes(opt, ospecs, sizes) + 2 * (8 // 2) * 128 * 4
    mem = rec["mem"]
    assert mem["argument_bytes"] == want
    assert mem["output_bytes"] == want - 2 * (8 // 2) * 128 * 4
    assert 0 < mem["temp_bytes"] and \
        mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    terms = rec["roofline"]
    assert terms["dominant"] in ("compute", "memory", "collective")
    assert rec["cost"]["flops"] > 0 and rec["cost"]["coll_bytes"] > 0
    assert terms["model_flops_per_dev"] == rl.model_flops(cfg, cell, 8)


def _count(cfg, mesh, cell):
    step, args, _ = dryrun._build_step(cfg, mesh, cell, probe=True)
    counter = rl.CostCounter()
    with counter:
        step(*args)
    return counter.point()


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_probe_extrapolation_equals_full_depth(fake_group, kind):
    fake_group(4)
    mesh = _mesh((2, 2), ("data", "model"))
    base = dataclasses.replace(get_smoke_config("qwen3-14b"), remat=False)
    cell = ShapeCell("t", kind, 32, 4)
    full = _count(dataclasses.replace(base, n_layers=4, force_unroll=True),
                  mesh, cell)
    p1, p2 = (_count(dataclasses.replace(base, n_layers=k,
                                         force_unroll=True), mesh, cell)
              for k in (1, 2))
    ex = rl.extrapolate(p1, p2, 4, 1)
    assert full.flops > 0 and full.coll_bytes > 0
    assert (ex.flops, ex.bytes_accessed, ex.coll_bytes) == \
        (full.flops, full.bytes_accessed, full.coll_bytes)
    assert ex.coll_by_op == full.coll_by_op


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh(fake_group, multi_pod):
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    if multi_pod:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.mesh.shape) == (2, 16, 16)
    else:
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.mesh.shape) == (16, 16)
    assert mesh.device_type == "cpu" and mesh.size() == (512 if multi_pod
                                                         else 256)
    with pytest.raises(ValueError, match="ranks"):
        make_production_mesh(multi_pod=not multi_pod, device="cpu")


@pytest.mark.parametrize("arch", list_archs())
def test_skipped_cells_match_reference(arch):
    cfg, rcfg = get_config(arch, production=True), ref_get_config(
        arch, production=True)
    for name, cell in SHAPES.items():
        ok, why = ref_applicable(rcfg, REF_SHAPES[name])
        assert cell_applicable(cfg, cell) == (ok, why)
        if ok:
            continue
        for mp in (False, True):
            rec = dryrun.run_cell(arch, name, mp, verbose=False,
                                  device="cpu")
            assert rec == {"arch": arch, "shape": name,
                           "mesh": "2x16x16" if mp else "16x16",
                           "applicable": False, "note": why,
                           "status": "skipped"}


def test_fake_group_import_lives_in_launch_mesh_alone():
    """The port's one import of ``torch.testing._internal`` (the fake
    process group) is ``launch/mesh.py``'s ``init_fake_group``."""
    import pathlib
    import repro_torch
    root = pathlib.Path(repro_torch.__file__).parent
    users = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                   if "torch.testing._internal" in p.read_text())
    assert users == ["launch/mesh.py"]
