"""The port's ``Trainer`` (``repro_torch.train``), launcher
(``repro_torch.launch.train``) and example (``examples/torch_train_lm.py``)
on the CPU: the counterparts of ``tests/test_substrates.py``'s trainer
tests on the reference's ``_tiny_cfg``, resume bit for bit, and 5 steps
against the reference's ``Trainer`` from the same parameters and state.

Tolerances against the reference (5 steps, lr 1e-3): every logged
metric (loss, ce, aux, gnorm) within 1e-6 relative (seen: 2.4e-7); the
final parameters and moments within 1e-4 of their tree's largest
|value| (seen: 3.5e-6 and 1.8e-6), each parameter within 0.1 lr (seen:
0.011 lr).  Resume: bitwise.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.configs.shapes import ShapeCell as RefShapeCell     # noqa: E402
from repro.launch.mesh import make_host_mesh                   # noqa: E402
from repro.train import Trainer as RefTrainer                  # noqa: E402
from repro.train import TrainConfig as RefTrainConfig          # noqa: E402
from repro_torch.checkpoint import latest_step                 # noqa: E402
from repro_torch.configs import get_smoke_config               # noqa: E402
from repro_torch.configs.shapes import ShapeCell               # noqa: E402
from repro_torch.launch import train as launch_train           # noqa: E402
from repro_torch.models.common import tree_paths               # noqa: E402
from repro_torch.models.convert import (opt_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.train import Trainer, TrainConfig             # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
METRICS = ("loss", "ce", "aux", "gnorm")
CELL = ShapeCell("t", "train", 32, 4)


def _tiny_cfg(get=get_smoke_config):
    base = get("qwen3-14b")
    return dataclasses.replace(base, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, head_dim=16, d_ff=128,
                               vocab=256, remat=False)


def _trainer(steps, ckpt_dir=None, ckpt_every=100, **kw):
    return Trainer(_tiny_cfg(), None, CELL, TrainConfig(
        steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, lr=1e-3,
        log_every=1), device="cpu", **kw)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _bitwise(a, b):
    pa, pb = list(tree_paths(a)), list(tree_paths(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)), path


def test_trainer_loss_decreases():
    tr = Trainer(_tiny_cfg(), None, CELL, TrainConfig(
        steps=30, ckpt_every=100, ckpt_dir=None, lr=1e-3, log_every=5),
        device="cpu")
    assert not tr.init_or_restore()
    hist = tr.run()
    assert [h["step"] for h in hist] == [5, 10, 15, 20, 25, 30]
    assert hist[-1]["ce"] < hist[0]["ce"]
    assert np.isfinite(hist[-1]["loss"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trainer_resume_determinism(tmp_path, dtype):
    """train 10 == train 6 + crash + resume 4: parameters, moments and
    every metric bit for bit (bf16 parameters too: the checkpoint keeps
    their bits)."""
    tr = _trainer(10, str(tmp_path / "a"), param_dtype=dtype)
    tr.init_or_restore()
    h_full = tr.run()
    assert latest_step(str(tmp_path / "a")) == 10

    tr6 = _trainer(6, str(tmp_path / "b"), ckpt_every=6, param_dtype=dtype)
    tr6.init_or_restore()
    tr6.run()
    tr2 = _trainer(10, str(tmp_path / "b"), param_dtype=dtype)
    assert tr2.init_or_restore(), "should resume from checkpoint"
    assert tr2.step == 6
    _bitwise(tr2.params, tr6.params)
    _bitwise((tr2.opt.mu, tr2.opt.nu, tr2.opt.count),
             (tr6.opt.mu, tr6.opt.nu, tr6.opt.count))
    h_res = tr2.run()
    assert [h["step"] for h in h_res] == [7, 8, 9, 10]
    for got, want in zip(h_res, h_full[6:]):
        for k in METRICS:
            assert got[k] == want[k], (got["step"], k)
    _bitwise(tr2.params, tr.params)
    _bitwise((tr2.opt.mu, tr2.opt.nu, tr2.opt.count),
             (tr.opt.mu, tr.opt.nu, tr.opt.count))
    for _, a in tree_paths(tr2.params):
        assert a.dtype == dtype
    for _, a in tree_paths((tr2.opt.mu, tr2.opt.nu)):
        assert a.dtype == torch.float32


def test_trainer_matches_reference_trainer():
    """5 steps of the reference's ``Trainer`` and of the port's from the
    reference's initial parameters and ``adamw_init`` state."""
    rt = RefTrainer(_tiny_cfg(ref_smoke_config), make_host_mesh(1, 1),
                    RefShapeCell("t", "train", 32, 4),
                    RefTrainConfig(steps=5, ckpt_every=100, ckpt_dir=None,
                                   lr=1e-3, log_every=1))
    rt.init_or_restore()
    tr = _trainer(5)
    tr.params = params_from_numpy(jax.tree.map(np.asarray, rt.params),
                                  _tiny_cfg(), device="cpu")
    tr.opt = opt_state_from_numpy(jax.tree.map(np.asarray, rt.opt),
                                  _tiny_cfg(), device="cpu")
    rh, ph = rt.run(), tr.run()
    assert [h["step"] for h in ph] == [h["step"] for h in rh] == [1, 2, 3,
                                                                   4, 5]
    for got, want in zip(ph, rh):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-12, err_msg=k)
    assert int(tr.opt.count) == int(rt.opt.count) == 5
    for name, got, want in (("params", tr.params, rt.params),
                            ("mu", tr.opt.mu, rt.opt.mu),
                            ("nu", tr.opt.nu, rt.opt.nu)):
        g = dict(tree_paths(got))
        w = dict(tree_paths(jax.tree.map(np.asarray, want)))
        assert set(g) == set(w)
        scale = max(np.abs(a).max() for a in w.values())
        for path, a in w.items():
            err = np.abs(g[path].numpy().astype(np.float64) - a).max()
            assert err <= 1e-4 * scale, (name, path, err / scale)
            if name == "params":
                assert err <= 0.1 * 1e-3, (path, err / 1e-3)


def test_launcher_smoke_steps_and_resume(tmp_path, capsys):
    hist = launch_train.main(["--smoke", "--steps", "4", "--device", "cpu"])
    assert hist[-1]["step"] == 4 and np.isfinite(hist[-1]["loss"])
    out = capsys.readouterr().out
    assert "arch=qwen3-14b" in out and "resumed=False" in out
    ck = str(tmp_path / "ck")
    launch_train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq",
                       "16", "--ckpt-dir", ck, "--device", "cpu"])
    assert latest_step(ck) == 2
    hist = launch_train.main(["--smoke", "--steps", "3", "--batch", "2",
                              "--seq", "16", "--ckpt-dir", ck, "--device",
                              "cpu"])
    assert "resumed=True start_step=2" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [3] and latest_step(ck) == 3


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_crash_and_resume(tmp_path):
    """``examples/torch_train_lm.py``'s flow at a few steps: its model, a
    crash at step 1, the resume there, CE decreasing over steps 2-3 (the
    example asserts it)."""
    mod, ref = (_load_example(n) for n in ("torch_train_lm", "train_lm"))
    # the reference example's model, field for field (79.95M parameters)
    assert dataclasses.asdict(mod.build_cfg()) == \
        dataclasses.asdict(ref.build_cfg())
    out = mod.main(["--device", "cpu", "--steps", "3", "--crash-at", "1",
                    "--batch", "2", "--seq", "32", "--log-every", "1",
                    "--ckpt-dir", str(tmp_path / "ck")])
    assert out["resumed_at"] == 1 and out["steps"] == 3
    assert [h["step"] for h in out["hist"]] == [2, 3]
    assert all(np.isfinite(h["ce"]) for h in out["hist"])
    assert latest_step(str(tmp_path / "ck")) == 3
