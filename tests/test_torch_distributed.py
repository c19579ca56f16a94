"""The port's sharding specs (``repro_torch.models.common`` rules and
``repro_torch.distributed.steps`` spec functions) against the
reference's, on mesh stand-ins with no devices: the counterpart of
``tests/test_distributed.py``, every case over the same mesh shapes, and
each spec tree equal to the reference's axis for axis (``tuple(spec)``
at every path), not only in structure.  All exact.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
from jax.sharding import PartitionSpec as RefP                 # noqa: E402

from repro.configs import get_config as ref_get_config         # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES          # noqa: E402
from repro.configs.shapes import cell_applicable as ref_applicable  # noqa: E402
from repro.distributed import steps as rsteps                  # noqa: E402
from repro.models import common as rcommon                     # noqa: E402
from repro.models import transformer as rtf                    # noqa: E402
from repro.optim import OptState as RefOptState                # noqa: E402
from repro_torch.configs import get_config, list_archs         # noqa: E402
from repro_torch.configs.shapes import SHAPES, cell_applicable  # noqa: E402
from repro_torch.distributed.pspec import P, mesh_shape        # noqa: E402
from repro_torch.distributed.steps import (                    # noqa: E402
    _data_pspec, batch_axes_for, cache_pspecs, kv_seq_axes, make_decode_step,
    make_prefill, make_train_step, train_state_specs)
from repro_torch.models import transformer as tf               # noqa: E402
from repro_torch.models.common import (                        # noqa: E402
    DEFAULT_RULES, SOFT_AXES, PDef, abstract_params, logical_to_pspec,
    param_pspecs, rules_for_mesh, tree_paths)


class FakeMesh:
    """Mesh stand-in: shape dict + axis names (no devices needed)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


class FakeDeviceMesh:
    """Stand-in of a torch ``DeviceMesh``: ``mesh_dim_names`` and
    ``size(i)``."""

    def __init__(self, shape):
        self.mesh_dim_names = tuple(shape)
        self._sizes = tuple(shape.values())

    def size(self, i):
        return self._sizes[i]


MESHES = {
    "16x16": FakeMesh({"data": 16, "model": 16}),
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
}


def _port_specs(tree):
    """{path: tuple(spec)} of a port spec tree."""
    out = {}
    for path, s in tree_paths(tree):
        assert isinstance(s, P), (path, s)
        out[path] = tuple(s)
    return out


def _ref_specs(tree):
    """{path: tuple(spec)} of a reference spec tree, paths in the port's
    form (dict keys; list, tuple and ``OptState`` field indices)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))

    def part(k):
        if isinstance(k, jax.tree_util.GetAttrKey):
            return RefOptState._fields.index(k.name)
        return getattr(k, "key", getattr(k, "idx", None))

    return {tuple(part(k) for k in kp): tuple(s) for kp, s in leaves}


def _same(port, ref):
    p, r = _port_specs(port), _ref_specs(ref)
    assert list(p) == list(r)                # same paths, same order
    for path in r:
        assert p[path] == r[path], (path, p[path], r[path])


def _structure_matches(values, specs):
    assert [p for p, _ in tree_paths(values)] == \
        [p for p, _ in tree_paths(specs)]


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_spec_tree_matches(arch, mesh_name):
    mesh = MESHES[mesh_name]
    cfg = get_config(arch, production=True)
    params = abstract_params(tf.pdefs(cfg))
    specs = param_pspecs(tf.pdefs(cfg), rules_for_mesh(mesh), mesh)
    _structure_matches(params, specs)
    rcfg = ref_get_config(arch, production=True)
    _same(specs, rcommon.param_pspecs(rtf.pdefs(rcfg),
                                      rcommon.rules_for_mesh(mesh), mesh))


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("cellname", ["decode_32k", "long_500k"])
def test_cache_spec_tree_matches(arch, cellname):
    """Every cell, applicable or not (the reference skips the latter; the
    spec arithmetic is defined for both), with ``cell_applicable`` equal
    to the reference's."""
    mesh = MESHES["16x16"]
    cfg = get_config(arch, production=True)
    cell = SHAPES[cellname]
    rcfg = ref_get_config(arch, production=True)
    assert cell_applicable(cfg, cell) == ref_applicable(rcfg,
                                                        REF_SHAPES[cellname])
    caches = tf.init_caches(cfg, cell.global_batch, cell.seq_len,
                            torch.bfloat16, "meta")
    specs = cache_pspecs(cfg, mesh, cell.global_batch, cell.seq_len)
    _structure_matches(caches, specs)
    _same(specs, rsteps.cache_pspecs(rcfg, mesh, cell.global_batch,
                                     cell.seq_len))


@pytest.mark.parametrize("arch", list_archs())
def test_probe_cfg_cache_spec_tree_matches(arch):
    """The dry-run probe configs (force_unroll) line up too."""
    mesh = MESHES["16x16"]
    cfg = get_config(arch, production=True)
    probe = dataclasses.replace(cfg, n_layers=len(cfg.pattern),
                                force_unroll=True)
    rcfg = ref_get_config(arch, production=True)
    rprobe = dataclasses.replace(rcfg, n_layers=len(rcfg.pattern),
                                 force_unroll=True)
    cell = SHAPES["decode_32k"]
    caches = tf.init_caches(probe, cell.global_batch, cell.seq_len,
                            torch.bfloat16, "meta")
    specs = cache_pspecs(probe, mesh, cell.global_batch, cell.seq_len)
    _structure_matches(caches, specs)
    _same(specs, rsteps.cache_pspecs(rprobe, mesh, cell.global_batch,
                                     cell.seq_len))


def test_batch_axes_assignment():
    m1, m2 = MESHES["16x16"], MESHES["2x16x16"]
    assert batch_axes_for(m1, 256) == ("data",)
    assert batch_axes_for(m2, 256) == ("pod", "data")
    assert batch_axes_for(m1, 1) == ()
    assert batch_axes_for(m2, 32) == ("pod", "data")
    assert batch_axes_for(m2, 2) == ("pod",)
    for mesh in MESHES.values():
        for batch in (1, 2, 3, 8, 16, 24, 32, 64, 128, 256, 512):
            assert batch_axes_for(mesh, batch) == \
                rsteps.batch_axes_for(mesh, batch)


def test_kv_seq_axes_avoid_batch_axes():
    m = MESHES["2x16x16"]
    assert kv_seq_axes(m, 128) == ["model"]          # batch takes pod+data
    assert kv_seq_axes(m, 1) == ["model", "pod", "data"]
    for mesh in MESHES.values():
        for batch in (1, 2, 16, 32, 128):
            assert kv_seq_axes(mesh, batch) == \
                rsteps.kv_seq_axes(mesh, batch)


@pytest.mark.parametrize("arch", list_archs())
def test_production_divisibility(arch):
    """Every padded production config shards cleanly on both meshes (hard
    axes raise; kv_heads is soft)."""
    cfg = get_config(arch, production=True)
    for mesh in MESHES.values():
        param_pspecs(tf.pdefs(cfg), rules_for_mesh(mesh), mesh)
    assert cfg.padded_vocab % 256 == 0
    if cfg.n_heads:
        assert cfg.padded_heads % 16 == 0


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rules_for_mesh_match_reference(mesh_name):
    mesh = MESHES[mesh_name]
    assert DEFAULT_RULES == rcommon.DEFAULT_RULES
    assert SOFT_AXES == rcommon.SOFT_AXES
    assert rules_for_mesh(mesh) == rcommon.rules_for_mesh(mesh)
    # a DeviceMesh's names and sizes give the same rules and specs
    dm = FakeDeviceMesh(mesh.shape)
    assert mesh_shape(dm).shape == mesh.shape
    assert rules_for_mesh(dm) == rules_for_mesh(mesh)
    cfg = get_config("qwen3-14b", production=True)
    assert _port_specs(param_pspecs(tf.pdefs(cfg), rules_for_mesh(dm), dm)) \
        == _port_specs(param_pspecs(tf.pdefs(cfg), rules_for_mesh(mesh),
                                    mesh))


def test_logical_to_pspec_hard_and_soft_axes():
    mesh = MESHES["16x16"]
    rules = rules_for_mesh(mesh)
    assert tuple(logical_to_pspec(("embed", "mlp"), rules, (32, 48), mesh)) \
        == ("data", "model")
    with pytest.raises(ValueError, match="pad the config"):
        logical_to_pspec(("embed", "mlp"), rules, (32, 40), mesh)
    # kv_heads falls back to replication
    assert tuple(logical_to_pspec(("embed", "kv_heads", None), rules,
                                  (32, 8, 128), mesh)) == ("data", None, None)
    assert tuple(rcommon.logical_to_pspec(("embed", "kv_heads", None), rules,
                                          (32, 8, 128), mesh)) == \
        ("data", None, None)
    # no shape: no check
    assert tuple(logical_to_pspec(("vocab", None), rules)) == ("model", None)
    tree = {"w": PDef((32, 48), ("embed", "mlp"))}
    assert _port_specs(param_pspecs(tree, rules, mesh)) == \
        {("w",): ("data", "model")}


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b",
                                  "llama4-scout-17b-a16e", "whisper-tiny"])
@pytest.mark.parametrize("fsdp", [True, False])
def test_train_state_specs_match_reference(arch, fsdp):
    for mesh in MESHES.values():
        pspecs, ospecs = train_state_specs(get_config(arch, production=True),
                                           mesh, fsdp=fsdp)
        rp, ro = rsteps.train_state_specs(
            ref_get_config(arch, production=True), mesh, fsdp=fsdp)
        _same(pspecs, rp)
        _same(ospecs, ro)
        assert type(ospecs).__name__ == "OptState" and ospecs._fields == \
            ro._fields and tuple(ospecs.count) == ()


def test_data_and_output_specs_match_reference():
    for mesh in MESHES.values():
        for batch in (1, 2, 32, 256):
            for extra in (1, 2):
                assert tuple(_data_pspec(mesh, batch, extra)) == \
                    tuple(rsteps._data_pspec(mesh, batch, extra))


def test_step_builders_take_meshes_of_several_ranks():
    """The builders take a ``DeviceMesh`` of several ranks (here over a
    fake group of four: built, not run) and refuse a stand-in of several
    devices (no silent one-device run); ``make_host_mesh`` and
    ``make_production_mesh`` refuse a group of the wrong size."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import (init_fake_group, make_host_mesh,
                                         make_production_mesh)
    cfg = get_config("qwen3-14b")
    builders = (lambda m: make_train_step(cfg, m, SHAPES["train_4k"]),
                lambda m: make_prefill(cfg, m, SHAPES["prefill_32k"]),
                lambda m: make_decode_step(cfg, m, SHAPES["decode_32k"]))
    for mesh in (MESHES["16x16"], MESHES["2x16x16"]):
        for build in builders:
            with pytest.raises(TypeError, match="DeviceMesh"):
                build(mesh)
    one = FakeMesh({"data": 1, "model": 1})
    assert callable(make_train_step(cfg, one, SHAPES["train_4k"]))
    init_fake_group(4)
    try:
        for data, model in ((2, 2), (4, 1), (1, 4)):
            mesh = make_host_mesh(data, model, device="cpu")
            for build in builders:
                assert callable(build(mesh))
        with pytest.raises(ValueError, match="needs 8 ranks"):
            make_host_mesh(4, 2, device="cpu")
        for multi_pod in (False, True):
            with pytest.raises(ValueError, match="the process group has 4"):
                make_production_mesh(multi_pod=multi_pod, device="cpu")
    finally:
        tdist.destroy_process_group()
