"""The port's LM gradients against ``jax.grad`` of the reference's loss,
leaf by leaf, for one arch of each mixer or MLP kind: attention
(qwen3-14b), local attention with post-norm (gemma3-27b), SSM
(mamba2-1.3b), RG-LRU (recurrentgemma-2b), MoE (moonshot-v1-16b-a3b)
and the encoder-decoder (whisper-tiny); smoke configs at B = 2, S = 32,
the reference's float32 parameters from ``jax.random.key(0)`` carried
across, inputs from ``numpy.random.default_rng(7)``, the reference's
``value_and_grad`` jitted once per arch.

Tolerance: each leaf within ``GRAD_TOL = 2e-3`` of the largest reference
gradient of the tree (a key bias's gradient is zero up to rounding, so a
leaf's own scale is no yardstick); the largest seen is 3.4e-4
(moonshot).  recurrentgemma at 1e-2: its RG-LRU's √(1 − exp(2 log a))
cancels about 9 bits at log a ≈ −3e-3 (``test_torch_models.py``), and
its gradients differ by up to 6.6e-4 of the largest.  The loss at 1e-4
relative, as in ``test_torch_models.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models import transformer as rtf                    # noqa: E402
from repro_torch.configs import get_smoke_config               # noqa: E402
from repro_torch.models import transformer as tf               # noqa: E402
from repro_torch.models.common import tree_map, tree_paths     # noqa: E402

from lm_parity import assert_close, ref_params, t, toy_inputs  # noqa: E402

GRAD_ARCHS = ("qwen3-14b", "gemma3-27b", "mamba2-1.3b", "recurrentgemma-2b",
              "moonshot-v1-16b-a3b", "whisper-tiny")
GRAD_TOL = 2e-3
RGLRU_TOL = 1e-2


@functools.lru_cache(maxsize=None)
def _grads(arch):
    """(reference loss and gradients as numpy, port loss and parameters
    after one backward)."""
    cfg, pcfg = ref_smoke_config(arch), get_smoke_config(arch)
    rp, pp = ref_params(cfg, pcfg, 0)
    tokens, enc = toy_inputs(cfg, 7)
    targets = np.roll(tokens, -1, axis=1)
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: rtf.loss_fn(p, cfg, tokens, targets, enc),
        has_aux=True))(rp)
    params = tree_map(lambda a: a.clone().requires_grad_(True), pp)
    ploss, _ = tf.loss_fn(params, pcfg, t(tokens), t(targets), t(enc))
    ploss.backward()
    return ((float(loss), jax.tree.map(np.asarray, g)),
            (float(ploss.detach()), params))


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_grads_match_reference(arch):
    (loss, grads), (ploss, params) = _grads(arch)
    np.testing.assert_allclose(ploss, loss, rtol=1e-4, atol=0)
    want = dict(tree_paths(grads))
    got = dict(tree_paths(params))
    assert set(got) == set(want)
    scale = max(np.abs(g).max() for g in want.values())
    tol = RGLRU_TOL if arch == "recurrentgemma-2b" else GRAD_TOL
    for path, g in want.items():
        assert_close(got[path].grad, g, tol, str(path), scale=scale)
