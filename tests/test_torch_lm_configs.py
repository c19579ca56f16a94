"""The port's LM configs, parameter declarations and shape cells against
the reference's: all ten archs, smoke and full, production padding or
not — configs field for field, the analytic parameter counts, the
``pdefs`` trees (paths, shapes, logical axes, init, scale), the
applicability of every shape cell, and the input specs (meta tensors,
dtypes mapped) — plus the counterparts of ``tests/test_models.py``'s
``test_input_specs_defined_for_applicable_cells`` and
``test_param_counts_sane``.  Pure Python on both sides: nothing is
compiled or run.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax.numpy as jnp                                        # noqa: E402

from repro import configs as rconfigs                          # noqa: E402
from repro.configs import shapes as rshapes                    # noqa: E402
from repro.models import transformer as rtf                    # noqa: E402
from repro.models.common import PDef as RPDef                  # noqa: E402
from repro_torch import configs                                # noqa: E402
from repro_torch.configs import shapes                         # noqa: E402
from repro_torch.models import transformer as tf               # noqa: E402
from repro_torch.models.common import abstract_params, tree_paths  # noqa: E402

ARCHS = configs.list_archs()
VARIANTS = [(a, v) for a in ARCHS for v in ("smoke", "full", "production")]
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


def _pair(arch, variant):
    if variant == "smoke":
        return rconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    prod = variant == "production"
    return (rconfigs.get_config(arch, production=prod),
            configs.get_config(arch, production=prod))


def _ref_pdef_paths(tree, path=()):
    """(path, PDef) of the reference's declaration tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_pdef_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _ref_pdef_paths(v, path + (i,))
    else:
        assert isinstance(tree, RPDef)
        yield path, tree


def test_registry_matches_reference():
    assert configs.list_archs() == rconfigs.list_archs()
    assert configs.ALIASES == rconfigs.ALIASES
    assert configs.ARCHS == rconfigs.ARCHS


@pytest.mark.parametrize("arch,variant", VARIANTS)
def test_config_and_counts_match_reference(arch, variant):
    ref, cfg = _pair(arch, variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    for name in ("padded_heads", "padded_vocab", "ssm_heads", "rec_width",
                 "layer_kinds"):
        assert getattr(cfg, name) == getattr(ref, name), name
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch,variant", VARIANTS)
def test_pdefs_match_reference(arch, variant):
    ref, cfg = _pair(arch, variant)
    want = dict(_ref_pdef_paths(rtf.pdefs(ref)))
    got = dict(tree_paths(tf.pdefs(cfg)))
    assert set(got) == set(want)
    for path, pd in want.items():
        g = got[path]
        assert (g.shape, g.axes, g.init, g.scale) == \
            (pd.shape, pd.axes, pd.init, pd.scale), path
    # abstract parameters hold the declared shapes and allocate nothing
    for path, a in tree_paths(abstract_params(tf.pdefs(cfg))):
        assert a.device.type == "meta" and tuple(a.shape) == want[path].shape


@pytest.mark.parametrize("arch,variant", VARIANTS)
def test_shape_cells_match_reference(arch, variant):
    ref, cfg = _pair(arch, variant)
    assert list(shapes.SHAPES) == list(rshapes.SHAPES)
    for name, cell in shapes.SHAPES.items():
        rcell = rshapes.SHAPES[name]
        assert dataclasses.asdict(cell) == dataclasses.asdict(rcell)
        ok = shapes.cell_applicable(cfg, cell)
        assert ok == rshapes.cell_applicable(ref, rcell)
        if not ok[0]:
            continue
        got = shapes.input_specs(cfg, cell)
        want = rshapes.input_specs(ref, rcell)
        assert list(got) == list(want)
        for k, spec in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == spec.shape, k
            assert got[k].dtype == DTYPES[spec.dtype.type], k


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_defined_for_applicable_cells(arch):
    cfg = configs.get_smoke_config(arch)
    for cell in shapes.SHAPES.values():
        ok, why = shapes.cell_applicable(cfg, cell)
        if ok:
            specs = shapes.input_specs(cfg, cell)
            assert "tokens" in specs


def test_param_counts_sane():
    # spot-check against public parameter counts (±25%: padding, biases)
    expect = {"qwen3-14b": 14.8e9, "phi3-medium-14b": 14e9,
              "gemma3-27b": 27e9, "chameleon-34b": 34e9,
              "llama4-scout-17b-a16e": 109e9, "mamba2-1.3b": 1.3e9}
    for name, n_pub in expect.items():
        n = configs.get_config(name).param_count()
        assert 0.7 < n / n_pub < 1.45, (name, n, n_pub)
