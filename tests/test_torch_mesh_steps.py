"""The port's step builders over meshes of several ranks (``DTensor``
state placed by the reference's specs, ``distributed.ctx`` installed)
against the same steps with ``mesh=None``, for the attention family's
smoke configs (qwen3: dense GQA, qk-norm; gemma3: local/global
attention, banded): four gloo ranks on a ``(2, 2)`` and a ``(2, 1, 2)``
mesh, a train step at ``grad_accum`` 2, a prefill and four decode
steps; every rank's local shards as the specs divide them.  Bounds in
``tests/mesh_parity.py`` (metrics 1e-5 relative, parameters 1e-3 of the
largest and 2.1 lr each, logits 1e-4 of the largest).  The one-device
step is held against the reference by the train-step and decode files.

Also the ``Trainer`` over ``(2, 2)``: its checkpoint restores bit for bit
on one device and over ``(4, 1)``, and its files are byte for byte those
a one-device save of the same state writes.
"""
import filecmp

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)

import mesh_parity as mp                                       # noqa: E402
from repro_torch.checkpoint import save_checkpoint             # noqa: E402
from repro_torch.models.common import tree_paths               # noqa: E402

ARCHS = ("qwen3-14b", "gemma3-27b")
LIMIT_S = 600                   # a hang guard: alone the ranks take 20-45 s


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_steps")
    return mp.run_ranks(ARCHS, out, LIMIT_S,
                        lambda: {a: mp.one_device(a) for a in ARCHS})


@pytest.mark.parametrize("mesh", list(mp.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_one_device(ranks, mesh, arch):
    got, want = ranks[0][(mesh, arch)], ranks[1][arch]
    mp.check_train(arch, got, want)


@pytest.mark.parametrize("mesh", list(mp.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_equal_one_device(ranks, mesh, arch):
    mp.check_serve(ranks[0][(mesh, arch)], ranks[1][arch])


@pytest.mark.parametrize("mesh", list(mp.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shards_are_the_specs_division(ranks, mesh, arch):
    assert int(ranks[0][(mesh, arch)]["bad_shards"]) == 0


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_trainer")
    saved, restored, losses = mp.run_trainer_ranks(out, LIMIT_S)
    return out, saved, restored, losses


def test_trainer_checkpoint_restores_on_another_mesh(trainer_run):
    _, saved, restored, losses = trainer_run
    assert len(losses) == mp.TRAINER_STEPS and np.isfinite(losses).all()
    assert list(saved) == list(restored)
    for k, a in saved.items():
        assert restored[k].dtype == a.dtype and \
            np.array_equal(mp.bits(restored[k]), mp.bits(a)), k


def test_trainer_checkpoint_restores_on_one_device(trainer_run, tmp_path):
    out, saved, _, _ = trainer_run
    tr = mp.trainer(None, str(out / "ckpt"))
    assert tr.init_or_restore() and tr.step == mp.TRAINER_STEPS
    one = mp.flat((tr.params, tr.opt))
    assert list(one) == list(saved)
    for k, a in saved.items():
        assert np.array_equal(mp.bits(one[k]), mp.bits(a)), k
    # the same state saved from one device: the same files, byte for byte
    save_checkpoint(str(tmp_path), mp.TRAINER_STEPS,
                    (tr.params, tr.opt, tr.step))
    a, b = out / "ckpt" / f"step_{mp.TRAINER_STEPS}", \
        tmp_path / f"step_{mp.TRAINER_STEPS}"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)
    assert len([p for p, _ in tree_paths((tr.params, tr.opt))]) + 2 == \
        len(names)                      # the leaves, the step, a manifest
