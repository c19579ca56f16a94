"""The port's LM forward and loss against the reference, for each of the
ten smoke configs at B = 2, S = 32 (with ``test_torch_models_grad.py``,
the counterpart of ``tests/test_models.py::test_smoke_forward_and_grad``),
and the MoE archs' expert choices.

The reference's float32 parameters (``jax.random.key(0)``) are carried
across with ``params_from_numpy``; tokens and whisper frames come from
``numpy.random.default_rng(7)``.  Each reference function is jitted once
per arch (one call gives logits and loss).

Tolerances (float32 on both sides), normwise: ``max |port - ref| <= tol
· max |ref|``.  Layer by layer the port agrees with the reference to
about 1e-6 of the largest value (a float32 ulp or a few: XLA's and
torch's exp, tanh, logistic and sums differ in the last bits).  Through
the stack random-weight models amplify that: sharp softmaxes of the
archs without qk-norm, mamba2's exponential decays.  The reference's own
jit-against-eager difference reaches 1.9e-5 of qwen1.5's logits; the
port's largest is 2.6e-4 (mamba2's logits), so ``LOGITS_TOL = 1e-3``.
recurrentgemma's RG-LRU computes √(1 − exp(2 log a)) with log a ≈ −3e-3,
which cancels about 9 bits: at these weights each side's float32 state is
5e-4 of its value away from a float64 evaluation, in different
directions, so that arch is held at ``RGLRU_TOL = 1e-2``.  Scalars (loss,
CE, MoE aux) at 1e-4 relative.
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
from repro.configs import list_archs                           # noqa: E402
from repro.models import transformer as rtf                    # noqa: E402
from repro_torch.configs import get_smoke_config               # noqa: E402
from repro_torch.models import transformer as tf               # noqa: E402
from repro_torch.models.common import tree_map, tree_paths     # noqa: E402

from lm_parity import assert_close, ref_params, t, toy_inputs  # noqa: E402

ARCHS = list_archs()
LOGITS_TOL = 1e-3
RGLRU_TOL = 1e-2
SCALAR_RTOL = 1e-4


def _tol(arch, default):
    return RGLRU_TOL if arch == "recurrentgemma-2b" else default


@functools.lru_cache(maxsize=None)
def _case(arch):
    """(port config, reference params, reference outputs as numpy, port
    params, tokens, targets, frames) of ``arch``; the reference is jitted
    once."""
    cfg, pcfg = ref_smoke_config(arch), get_smoke_config(arch)
    rp, pp = ref_params(cfg, pcfg, 0)
    tokens, enc = toy_inputs(cfg, 7)
    targets = np.roll(tokens, -1, axis=1)

    def ref(p):
        logits, aux = rtf.fwd_train(p, cfg, tokens, enc)
        loss, (ce, a) = rtf.loss_fn(p, cfg, tokens, targets, enc)
        return {"logits": logits, "aux": aux, "loss": loss, "ce": ce,
                "loss_aux": a}

    out = jax.tree.map(np.asarray, jax.jit(ref)(rp))
    return pcfg, rp, out, pp, tokens, targets, enc


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    cfg, _, ref, pp, tokens, targets, enc = _case(arch)
    with torch.no_grad():
        logits, aux = tf.fwd_train(pp, cfg, t(tokens), t(enc))
        loss, (ce, laux) = tf.loss_fn(pp, cfg, t(tokens), t(targets), t(enc))
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 32, cfg.padded_vocab)
    assert_close(logits, ref["logits"], _tol(arch, LOGITS_TOL), "logits")
    for got, want in ((aux, ref["aux"]), (loss, ref["loss"]),
                      (ce, ref["ce"]), (laux, ref["loss_aux"])):
        np.testing.assert_allclose(float(got), float(want),
                                   rtol=SCALAR_RTOL, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_grad(arch):
    """The port on its own: finite logits, CE near ln(vocab), finite
    gradients that reach the embedding (as the reference's own test)."""
    cfg, _, _, pp, tokens, targets, enc = _case(arch)
    params = tree_map(lambda a: a.clone().requires_grad_(True), pp)
    loss, (ce, _) = tf.loss_fn(params, cfg, t(tokens), t(targets), t(enc))
    assert np.isfinite(float(loss.detach()))
    assert float(ce.detach()) < np.log(cfg.vocab) + 2.0
    loss.backward()
    grads = [a.grad for _, a in tree_paths(params)]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert float(params["embed"].grad.abs().max()) > 0


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if ref_smoke_config(a).n_experts])
def test_moe_expert_choices_equal_reference(arch, monkeypatch):
    """Every MoE layer routes every token to the same experts, in the same
    order, as the reference.  Each side's top-k is recorded while its
    forward runs: ``jax.lax.top_k`` (through an ordered host callback in
    the jitted forward) and ``torch.topk`` are wrapped."""
    pcfg, rp, _, pp, tokens, _, _ = _case(arch)
    cfg = ref_smoke_config(arch)
    seen = {"ref": [], "port": []}
    top_k, topk = jax.lax.top_k, torch.topk

    def ref_top_k(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda e: seen["ref"].append(np.asarray(e)),
                           out[1], ordered=True)
        return out

    def port_topk(x, k, *a, **kw):
        out = topk(x, k, *a, **kw)
        seen["port"].append(out[1].numpy())
        return out

    monkeypatch.setattr(jax.lax, "top_k", ref_top_k)
    monkeypatch.setattr(torch, "topk", port_topk)
    jax.block_until_ready(
        jax.jit(lambda p: rtf.fwd_train(p, cfg, tokens))(rp))
    with torch.no_grad():
        tf.fwd_train(pp, pcfg, t(tokens))
    assert len(seen["ref"]) == len(seen["port"]) == cfg.n_layers
    assert seen["port"][0].shape == (2, 32, cfg.top_k)
    for r, p in zip(seen["ref"], seen["port"]):
        np.testing.assert_array_equal(p, r)
