"""The port's step builders over meshes of several ranks (``DTensor``
state placed by the reference's specs, ``distributed.ctx`` installed)
against the same steps with ``mesh=None``, for the recurrent smoke
configs (mamba2: chunked SSD; recurrentgemma: RG-LRU and local attention
with one kv head, the soft axis): four gloo ranks on a ``(2, 2)`` and a
``(2, 1, 2)`` mesh, a train step at ``grad_accum`` 2, a prefill and four
decode steps; every rank's local shards as the specs divide them.
Bounds in ``tests/mesh_parity.py`` (metrics 1e-5 relative, parameters
1e-3 of the largest and 2.1 lr each, logits 1e-4 of the largest).  The
one-device step is held against the reference by the train-step and
decode files.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)

import mesh_parity as mp                                       # noqa: E402

ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")
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
