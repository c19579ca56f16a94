"""The port's token pipeline (``repro_torch.data.tokens``) and checkpoints
(``repro_torch.checkpoint``) on the CPU: the counterparts of
``tests/test_substrates.py``'s data and checkpoint tests, the batches
against the reference's array for array, and the files on disk against
the reference's byte for byte.

Both are exact: batches equal, restored leaves equal bit for bit (bf16
and int32 too), the ``.npy`` files of a float32 tree byte-identical to
the ones the reference writes for the same arrays in the same order.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.checkpoint import save_checkpoint as ref_save       # noqa: E402
from repro.data.tokens import SyntheticTokens as RefTokens     # noqa: E402
from repro_torch.checkpoint import (latest_step,               # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.data.tokens import SyntheticTokens            # noqa: E402
from repro_torch.optim import OptState, adamw_init             # noqa: E402


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_stateless_addressing():
    d = SyntheticTokens(vocab=1000, seq_len=64, global_batch=8, seed=3)
    a1, b1 = d.batch_at(step=5)
    a2, b2 = d.batch_at(step=5)
    assert np.array_equal(a1, a2) and np.array_equal(b1, b2)
    a3, _ = d.batch_at(step=6)
    assert not np.array_equal(a1, a3)
    # host slicing matches the global batch
    lo, hi = 2, 5
    s1, _ = d.batch_at(5, lo, hi)
    assert np.array_equal(s1, a1[lo:hi])
    # targets are inputs shifted by one
    assert np.array_equal(a1[:, 1:], b1[:, :-1])


def test_data_prefetch():
    d = SyntheticTokens(vocab=100, seq_len=16, global_batch=2, seed=0)
    it = d.prefetch(start_step=3, depth=2)
    s, (tok, tgt) = next(it)
    assert s == 3 and tok.shape == (2, 16)
    s, _ = next(it)
    assert s == 4


@pytest.mark.parametrize("seed,vocab,seq,batch", [
    (0, 1000, 64, 8), (3, 256, 32, 4), (11, 151936, 128, 2),
    (2**31 + 5, 32000, 33, 3)])
def test_batches_equal_reference(seed, vocab, seq, batch):
    port = SyntheticTokens(vocab, seq, batch, seed=seed)
    ref = RefTokens(vocab, seq, batch, seed=seed)
    assert np.array_equal(port.motifs, ref.motifs)
    for step, lo, hi in ((0, 0, None), (7, 0, None), (123, 1, batch)):
        got, want = port.batch_at(step, lo, hi), ref.batch_at(step, lo, hi)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(5, dtype=torch.float32),
            "b": [torch.ones((2, 2)), torch.tensor(7, dtype=torch.int32)]}
    save_checkpoint(str(tmp_path), 10, tree)
    like = {"a": torch.zeros(5), "b": [torch.zeros((2, 2)),
                                      torch.tensor(0, dtype=torch.int32)]}
    out, step = restore_checkpoint(str(tmp_path), like)
    assert step == 10
    assert np.array_equal(out["a"].numpy(), np.arange(5))
    assert int(out["b"][1]) == 7


def test_checkpoint_gc_and_latest(tmp_path):
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    assert latest_step(str(tmp_path)) == 5
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_4", "step_5"]


def test_checkpoint_structure_mismatch(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(3)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"y": {"z": torch.zeros(3)}})
    with pytest.raises(ValueError):          # same leaves, another node
        restore_checkpoint(str(tmp_path), [torch.zeros(3)])
    with pytest.raises(ValueError):          # another dtype
        restore_checkpoint(str(tmp_path), {"x": torch.zeros(3).double()})


def test_checkpoint_atomic_publish(tmp_path):
    """A leftover .tmp dir (simulated crash) must not break save/restore."""
    (tmp_path / ".tmp_step_7").mkdir()
    save_checkpoint(str(tmp_path), 7, {"x": torch.ones(2)})
    out, step = restore_checkpoint(str(tmp_path), {"x": torch.zeros(2)})
    assert step == 7 and float(out["x"].sum()) == 2.0
    assert latest_step(str(tmp_path)) == 7
    assert not (tmp_path / ".tmp_step_7").exists()


def test_bf16_and_int32_leaves_round_trip_bit_for_bit(tmp_path):
    """A bf16 leaf is stored as the reference's 2-byte void array and
    comes back as bf16, every bit pattern (NaNs, infinities, -0 and
    subnormals included); an int32 0-d leaf as int32; a Python int as
    the stored array."""
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16)
    params = {"w": bits.view(torch.bfloat16).reshape(256, 256),
              "v": [torch.randn(3, generator=torch.Generator()
                                .manual_seed(0)).bfloat16()]}
    opt = adamw_init(params)
    opt = OptState(mu=opt.mu, nu=opt.nu,
                   count=torch.tensor(2**31 - 1, dtype=torch.int32))
    save_checkpoint(str(tmp_path), 3, (params, opt, 3))
    stored = np.load(tmp_path / "step_3" / "leaf_1.npy")
    assert stored.dtype == np.dtype("V2") and stored.shape == (256, 256)
    like = ({"w": torch.empty(256, 256, dtype=torch.bfloat16),
             "v": [torch.empty(3, dtype=torch.bfloat16)]},
            adamw_init(params), 0)
    (p2, o2, step), s = restore_checkpoint(str(tmp_path), like)
    assert s == 3 and int(step) == 3
    for got, want in ((p2["w"], params["w"]), (p2["v"][0], params["v"][0])):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert o2.count.dtype == torch.int32 and int(o2.count) == 2**31 - 1
    assert o2.mu["w"].dtype == torch.float32


def test_bf16_files_byte_identical_to_reference(tmp_path):
    """The port's ``.npy`` of a bf16 leaf is the reference's byte for byte
    (the reference writes ml_dtypes' bfloat16 under ``'descr': '<V2'``)."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(7, 9)).astype(np.float32)
    ref_save(str(tmp_path / "ref"), 1, {"a": jnp.asarray(a, jnp.bfloat16)})
    save_checkpoint(str(tmp_path / "port"), 1,
                    {"a": torch.from_numpy(a).bfloat16()})
    want = (tmp_path / "ref" / "step_1" / "leaf_0.npy").read_bytes()
    got = (tmp_path / "port" / "step_1" / "leaf_0.npy").read_bytes()
    assert got == want


def test_float32_files_byte_identical_to_reference(tmp_path):
    """The same float32 (and integer) arrays in the same tree shape give
    the same files in the same leaf order; the manifests differ only in
    ``sig`` (each package hashes its own structure)."""
    rng = np.random.default_rng(1)
    arrays = {"b": [rng.normal(size=(3, 4)).astype(np.float32),
                    rng.normal(size=(5,)).astype(np.float32)],
              "a": {"z": rng.normal(size=(2, 2, 2)).astype(np.float32),
                    "c": np.float32(rng.normal())},
              "n": np.int32(9)}
    ref_save(str(tmp_path / "ref"), 4, (jax.tree.map(jnp.asarray, arrays),
                                        4))
    save_checkpoint(str(tmp_path / "port"), 4,
                    (jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                  arrays), 4))
    rdir, pdir = tmp_path / "ref" / "step_4", tmp_path / "port" / "step_4"
    rman = json.loads((rdir / "manifest.json").read_text())
    pman = json.loads((pdir / "manifest.json").read_text())
    assert rman["n_leaves"] == pman["n_leaves"] == 6
    assert rman["step"] == pman["step"] == 4
    for i in range(6):
        assert (pdir / f"leaf_{i}.npy").read_bytes() == \
            (rdir / f"leaf_{i}.npy").read_bytes(), i


def test_restore_onto_tree_like_device_and_step_choice(tmp_path):
    """Restore returns tensors on the ``tree_like`` leaves' device (the
    CPU here; the card in ``test_torch_gpu.py``) and any step asked for."""
    for s in (2, 4):
        save_checkpoint(str(tmp_path), s, {"x": torch.full((2,), float(s))})
    out, step = restore_checkpoint(str(tmp_path), {"x": torch.zeros(2)},
                                   step=2)
    assert step == 2 and out["x"].tolist() == [2.0, 2.0]
    assert out["x"].device.type == "cpu"
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"x": torch.zeros(2)})
