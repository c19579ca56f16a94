"""Shared set-up of the train-step parity tests
(``test_torch_train_step*.py``): one step of the reference's
``make_train_step`` (jitted on a one-device host mesh) and of the port's,
from the same carried-across parameters and ``adamw_init`` state on the
same ``SyntheticTokens`` batch, and the tolerances the files state."""
import numpy as np
import jax
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.shapes import ShapeCell as RefShapeCell
from repro.data.tokens import SyntheticTokens
from repro.distributed.steps import make_train_step as ref_make_train_step
from repro.launch.mesh import make_host_mesh
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.distributed.steps import make_train_step
from repro_torch.models.common import tree_paths
from repro_torch.models.convert import opt_state_from_numpy

from lm_parity import assert_close, ref_params, t

B, S, LR, ACCUM = 4, 32, 1e-3, 2
# float32, normwise (of the largest |value| of the tree): the moments at
# the LM gradient tests' bounds, 1e-3 through the stack and 1e-2 for
# recurrentgemma (its RG-LRU's sqrt(1 - exp(2 log a)) cancels about 9
# bits)
MOMENT_TOL, RGLRU_TOL = 1e-3, 1e-2
# loss, ce and aux: 1e-6 relative (seen: 1.5e-7); gnorm 2e-4 (seen 5.4e-5,
# recurrentgemma; 1e-3 for it)
METRIC_TOL, GNORM_TOL = 1e-6, 2e-4
# parameters: normwise as the moments; and elementwise within 2.1 lr: at
# count 1 an AdamW step moves a weight by lr |g| / (|g| + eps) < lr, so a
# gradient that is zero up to rounding (a key bias's) may take either
# sign on either side (seen: 1.99 lr, recurrentgemma; 1.61 lr, mamba2)
PARAM_LR_MULTIPLE = 2.1


def step_both(arch: str, seed: int = 0):
    """(reference (params, opt, metrics) as numpy, port's, port's
    parameters before the step)."""
    cfg, pcfg = ref_smoke_config(arch), get_smoke_config(arch)
    rp, pp = ref_params(cfg, pcfg, seed)
    tok, tgt = SyntheticTokens(cfg.vocab, S, B, seed=seed + 1).batch_at(0)
    enc = None
    if cfg.is_encoder_decoder:
        enc = (np.random.default_rng(seed + 2).normal(
            size=(B, cfg.encoder_len, cfg.d_model)) * 0.02).astype(np.float32)
    fn, in_sh, out_sh = ref_make_train_step(
        cfg, make_host_mesh(1, 1), RefShapeCell("t", "train", S, B), lr=LR,
        grad_accum=ACCUM)
    ro = ref_adamw_init(rp)
    args = (rp, ro, tok, tgt) + (() if enc is None else (enc,))
    ref = jax.tree.map(np.asarray, jax.jit(
        fn, in_shardings=in_sh, out_shardings=out_sh)(*args))
    po = opt_state_from_numpy(jax.tree.map(np.asarray, ro), pcfg,
                              device="cpu")
    step = make_train_step(pcfg, None, ShapeCell("t", "train", S, B), lr=LR,
                           grad_accum=ACCUM)
    port = step(pp, po, t(tok), t(tgt), t(enc))
    return ref, port, pp


def check_step(arch: str, ref, port, before) -> None:
    (rp, ro, rm), (pp, po, pm) = ref, port
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                   rtol=METRIC_TOL, atol=1e-12, err_msg=k)
    rg = arch == "recurrentgemma-2b"
    np.testing.assert_allclose(float(pm["gnorm"]), float(rm["gnorm"]),
                               rtol=1e-3 if rg else GNORM_TOL)
    assert int(po.count) == int(ro.count) == 1
    tol = RGLRU_TOL if rg else MOMENT_TOL
    for name, got, want in (("params", pp, rp), ("mu", po.mu, ro.mu),
                            ("nu", po.nu, ro.nu)):
        g, w = dict(tree_paths(got)), dict(tree_paths(want))
        assert set(g) == set(w), name
        scale = max(np.abs(a).max() for a in w.values())
        for path, a in w.items():
            assert g[path].dtype == torch.float32, (name, path)
            assert_close(g[path], a, tol, f"{name}{path}", scale=scale)
            if name == "params":
                err = np.abs(g[path].numpy().astype(np.float64) - a).max()
                assert err <= PARAM_LR_MULTIPLE * LR, (path, err / LR)
    # the same leaves moved on both sides (all of them but any the loss
    # does not reach and weight decay leaves at zero)
    b = dict(tree_paths(before))
    moved = {path for path, a in tree_paths(pp)
             if not torch.equal(a, b[path])}
    assert moved == {path for path, a in tree_paths(rp)
                     if not np.array_equal(a, b[path].numpy())}
    assert len(moved) >= len(b) - 2, sorted(set(b) - moved)
