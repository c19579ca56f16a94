"""The port's serving path — ``prefill`` and ``decode_step`` — against
itself and against the reference, on the ten smoke configs.

* The counterpart of ``tests/test_models.py::
  test_prefill_decode_matches_forward`` (the nine decoder-only archs):
  prefill of S = 16 plus one decode step equal ``fwd_train``'s rows at
  2e-2, as the reference holds itself.  The port's own ``init_params``
  (a seeded ``torch.Generator``) gives the parameters.
* Against the reference (all ten; float32, parameters from
  ``jax.random.key(1)`` carried across, tokens from
  ``numpy.random.default_rng(3)``): the prefill logits and every cache
  leaf, and one ``decode_step`` from the reference's own caches (carried
  across with ``caches_from_numpy``; whisper also takes the reference's
  encoder output): its logits and the caches it returns.  Tolerances as
  ``test_torch_models.py``'s logits, normwise per leaf: 1e-3, and 1e-2
  for recurrentgemma, whose RG-LRU state is float32-conditioned to about
  5e-4 on each side.
* The counterpart of ``test_whisper_decode_runs``, with its logits
  against the reference's.

Whisper is not in the first group in either package: its ``prefill``
applies cross-attention before the MLP, its ``fwd_train`` after it.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.configs import list_archs                           # noqa: E402
from repro.models import transformer as rtf                    # noqa: E402
from repro_torch.configs import get_smoke_config               # noqa: E402
from repro_torch.models import transformer as tf               # noqa: E402
from repro_torch.models.common import init_params, tree_paths  # noqa: E402
from repro_torch.models.convert import caches_from_numpy       # noqa: E402

from lm_parity import assert_close, ref_params, t, toy_inputs  # noqa: E402

ARCHS = list_archs()
DECODER_ONLY = [a for a in ARCHS if a != "whisper-tiny"]
B, S, MAX_LEN = 2, 16, 32


def _tol(arch):
    return 1e-2 if arch == "recurrentgemma-2b" else 1e-3


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_prefill_decode_matches_forward(arch):
    """logits(prefill S) + decode(t=S) must equal fwd_train at position S."""
    cfg = get_smoke_config(arch)
    params = init_params(tf.pdefs(cfg), torch.Generator().manual_seed(1),
                         torch.float32, "cpu")
    tokens = t(toy_inputs(cfg, 3, B, S + 1)[0])
    with torch.no_grad():
        full, _ = tf.fwd_train(params, cfg, tokens)
        pre_logits, caches = tf.prefill(params, cfg, tokens[:, :S], MAX_LEN,
                                        dtype=torch.float32)
        np.testing.assert_allclose(pre_logits[:, -1].numpy(),
                                   full[:, S - 1].numpy(),
                                   rtol=2e-2, atol=2e-2)
        step_logits, _ = tf.decode_step(params, cfg, caches,
                                        tokens[:, S:S + 1], S)
    np.testing.assert_allclose(step_logits.numpy(), full[:, S].numpy(),
                               rtol=2e-2, atol=2e-2)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's prefill (logits, caches) and one decode step from
    its caches, as numpy, with the port's copy of the parameters."""
    cfg, pcfg = ref_smoke_config(arch), get_smoke_config(arch)
    rp, pp = ref_params(cfg, pcfg, 1)
    tokens, enc = toy_inputs(cfg, 3, B, S + 1)

    def run(p):
        logits, caches = rtf.prefill(p, cfg, tokens[:, :S], MAX_LEN, enc,
                                     dtype=jnp.float32)
        enc_out = rtf.encode(p, cfg, enc) if enc is not None else None
        step, stepped = rtf.decode_step(p, cfg, caches, tokens[:, S:S + 1],
                                        jnp.int32(S), enc_out)
        return logits, caches, step, stepped, enc_out

    out = jax.tree.map(np.asarray, jax.jit(run)(rp))
    return pcfg, pp, tokens, enc, out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    cfg, pp, tokens, enc, (logits, caches, _, _, _) = _reference(arch)
    with torch.no_grad():
        plogits, pcaches = tf.prefill(pp, cfg, t(tokens[:, :S]), MAX_LEN,
                                      t(enc), dtype=torch.float32)
    assert_close(plogits, logits, _tol(arch), "prefill logits")
    want = dict(tree_paths(caches))
    got = dict(tree_paths(pcaches))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].numpy().dtype == leaf.dtype, path
        assert_close(got[path], leaf, _tol(arch), str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_from_reference_caches(arch):
    cfg, pp, tokens, _, (_, caches, step, stepped, enc_out) = _reference(arch)
    pcaches = caches_from_numpy(caches, cfg, B, MAX_LEN, device="cpu")
    with torch.no_grad():
        logits, new = tf.decode_step(pp, cfg, pcaches, t(tokens[:, S:S + 1]),
                                     S, t(enc_out))
    assert logits.shape == (B, cfg.padded_vocab)
    assert_close(logits, step, _tol(arch), "decode logits")
    # the new caches: position S written (rolling slot S % window on local
    # layers), recurrent states stepped
    want = dict(tree_paths(stepped))
    got = dict(tree_paths(new))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].numpy().dtype == leaf.dtype, path
        assert_close(got[path], leaf, _tol(arch), str(path))


def test_whisper_decode_runs():
    """The reference's own whisper decode test on the port, and its logits
    against the reference's."""
    arch = "whisper-tiny"
    cfg, pcfg = ref_smoke_config(arch), get_smoke_config(arch)
    rp, pp = ref_params(cfg, pcfg, 2)
    tokens, enc = toy_inputs(cfg, 2, B=2, S=8)
    with torch.no_grad():
        enc_out = tf.encode(pp, pcfg, t(enc))
        caches = tf.init_caches(pcfg, 2, 16, torch.float32, "cpu")
        logits, caches = tf.decode_step(pp, pcfg, caches, t(tokens[:, :1]),
                                        0, enc_out=enc_out)
    assert logits.shape == (2, pcfg.padded_vocab)
    assert torch.isfinite(logits).all()

    def ref(p):
        eo = rtf.encode(p, cfg, enc)
        c = rtf.init_caches(cfg, 2, 16, jnp.float32)
        return rtf.decode_step(p, cfg, c, tokens[:, :1], jnp.int32(0),
                               enc_out=eo)[0]

    assert_close(logits, np.asarray(jax.jit(ref)(rp)), 1e-3, "logits")
