"""Attention path coverage of the port (the counterparts of the six cases
of ``tests/test_attention_paths.py``): grouped (no padding) against
padded-head layouts, rolling local windows, the GQA mapping — plus the
padded-head loss, a rolled prefill cache and decoding past the end of a
global cache against the reference.

Parameters are the reference's (``jax.random.key(s)``, float32) carried
across; tokens and inputs come from ``numpy.random.default_rng(s)``.
Tolerances are the reference test's where a case has its counterpart
(2e-5 for the same math in another layout, 2e-2 for decode against the
full forward); against the reference, 1e-3 of the largest value, as
``test_torch_models.py``'s logits (1e-4 relative for the loss).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per test process: the suite's files run side by
# side in parallel processes
torch.set_num_threads(1)
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models import transformer as rtf                    # noqa: E402
from repro_torch.configs import get_smoke_config               # noqa: E402
from repro_torch.models import attention as attn               # noqa: E402
from repro_torch.models import transformer as tf               # noqa: E402
from repro_torch.models.common import tree_map, tree_paths     # noqa: E402
from repro_torch.models.convert import caches_from_numpy       # noqa: E402

from lm_parity import assert_close, ref_params, t              # noqa: E402


def _cfgs(**kw):
    """The reference's and the port's qwen3-14b smoke config, changed."""
    return (dataclasses.replace(ref_smoke_config("qwen3-14b"), **kw),
            dataclasses.replace(get_smoke_config("qwen3-14b"), **kw))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def test_q_to_kv_map_groups():
    _, cfg = _cfgs(n_heads=6, n_kv_heads=2, pad_heads_multiple=4)  # pad to 8
    m = attn._q_to_kv_map(cfg)
    assert m.shape == (8,)
    assert list(m[:6]) == [0, 0, 0, 1, 1, 1]
    assert not attn._grouped_ok(cfg)
    _, cfg2 = _cfgs(n_heads=6, n_kv_heads=2, pad_heads_multiple=1)
    assert attn._grouped_ok(cfg2)


def test_padded_path_forward_and_grad_finite():
    """The padded-head path (production layout) must run and train, and
    its loss must equal the reference's."""
    rcfg, cfg = _cfgs(n_layers=2, n_heads=6, n_kv_heads=2, head_dim=16,
                      d_model=48, d_ff=96, vocab=128, pad_heads_multiple=4,
                      remat=False)
    assert cfg.padded_heads == 8
    rp, params = ref_params(rcfg, cfg, 0)
    tokens = _tokens(1, (2, 16), cfg.vocab)
    targets = np.roll(tokens, -1, 1)
    params = tree_map(lambda a: a.requires_grad_(True), params)
    loss, _ = tf.loss_fn(params, cfg, t(tokens), t(targets))
    assert np.isfinite(float(loss.detach()))
    loss.backward()
    assert all(torch.isfinite(a.grad).all() for _, a in tree_paths(params))
    ref_loss, _ = rtf.loss_fn(rp, rcfg, tokens, targets)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-4, atol=0)


def test_grouped_vs_padded_same_when_pad_is_noop():
    """pad multiple that divides n_heads exactly: both paths must agree
    (same weights, padded==n_heads so only the einsum layout differs)."""
    rcfg, cfg_g = _cfgs(n_layers=1, n_heads=4, n_kv_heads=2, head_dim=16,
                        d_model=32, d_ff=64, vocab=64, pad_heads_multiple=1,
                        remat=False)
    cfg_p = dataclasses.replace(cfg_g, pad_heads_multiple=2)  # 4 -> 4
    assert attn._grouped_ok(cfg_g) and attn._grouped_ok(cfg_p)
    _, params = ref_params(rcfg, cfg_g, 0)
    tokens = t(_tokens(1, (1, 8), 64))
    with torch.no_grad():
        a, _ = tf.fwd_train(params, cfg_g, tokens)
        b, _ = tf.fwd_train(params, cfg_p, tokens)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_forced_expansion_path_matches_grouped(monkeypatch):
    """Force the kmap-expansion path on a config where grouped is valid:
    results must match the grouped einsum (same math, different layout)."""
    rcfg, cfg = _cfgs(n_layers=1, n_heads=4, n_kv_heads=2, head_dim=16,
                      d_model=32, d_ff=64, vocab=64, remat=False)
    _, params = ref_params(rcfg, cfg, 2)
    tokens = t(_tokens(3, (2, 12), 64))
    with torch.no_grad():
        out_grouped, _ = tf.fwd_train(params, cfg, tokens)
        monkeypatch.setattr(attn, "_grouped_ok", lambda c: False)
        out_expand, _ = tf.fwd_train(params, cfg, tokens)
    np.testing.assert_allclose(out_grouped.numpy(), out_expand.numpy(),
                               rtol=2e-5, atol=2e-5)


def test_local_rolling_buffer_long_decode():
    """Decode far past the window: rolling buffer must keep exactly the
    last `window` positions (compare against full-context forward)."""
    rcfg, cfg = _cfgs(n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                      d_model=32, d_ff=64, vocab=64, local_window=8,
                      pattern=("local",), remat=False)
    _, params = ref_params(rcfg, cfg, 4)
    S = 24
    tokens = t(_tokens(5, (1, S + 1), 64))
    with torch.no_grad():
        full, _ = tf.fwd_train(params, cfg, tokens)
        # drive the decode path across 3 window wraps
        caches = tf.init_caches(cfg, 1, 64, torch.float32, "cpu")
        for i in range(S):
            logits, caches = tf.decode_step(params, cfg, caches,
                                            tokens[:, i:i + 1], i)
    np.testing.assert_allclose(logits.numpy(), full[:, S - 1].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_banded_local_equals_full_masked():
    """Banded sliding-window path must equal the full-S² masked path."""
    rcfg, cfg = _cfgs(n_layers=1, n_heads=4, n_kv_heads=2, head_dim=16,
                      d_model=32, d_ff=64, vocab=64, local_window=8,
                      pattern=("local",), remat=False)
    _, params = ref_params(rcfg, cfg, 8)
    x = t(np.random.default_rng(9).normal(size=(2, 32, 32))
          .astype(np.float32))
    mix = tree_map(lambda a: a[0], params["scan"]["pos0"]["mixer"])
    banded = attn.attn_fwd(mix, cfg, x, local=True)
    # kv_mask disables the banded fast path -> full masked attention
    full = attn.attn_fwd(mix, cfg, x, local=True,
                         kv_mask=torch.ones((2, 32), dtype=torch.bool))
    np.testing.assert_allclose(banded.numpy(), full.numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("prefill_len,max_len,steps", [
    (20, 64, 6),     # local window 8 rolled by 20 % 8, then 3 wraps
    (10, 12, 5),     # global cache of 12: the last 3 steps run past its end
])
def test_cached_decode_matches_reference(prefill_len, max_len, steps):
    """Prefill, then decode ``steps`` positions from the caches, against
    the reference step by step: logits and every cache leaf.  The local
    layer's prefill keeps the last window rolled by ``S % window``; past
    the end of a global cache both write the last slot (the reference's
    ``dynamic_update_slice`` clamps its start)."""
    kw = dict(n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, d_model=32,
              d_ff=64, vocab=64, local_window=8, pattern=("local", "attn"),
              remat=False)
    rcfg, cfg = _cfgs(**kw)
    rp, params = ref_params(rcfg, cfg, 6)
    tokens = _tokens(7, (2, prefill_len + steps), 64)
    ref_prefill = jax.jit(lambda p, tk: rtf.prefill(
        p, rcfg, tk, max_len, dtype=jnp.float32))
    ref_step = jax.jit(lambda p, c, tk, pos: rtf.decode_step(
        p, rcfg, c, tk, pos))
    logits, caches = ref_prefill(rp, tokens[:, :prefill_len])
    with torch.no_grad():
        plogits, pcaches = tf.prefill(params, cfg, t(tokens[:, :prefill_len]),
                                      max_len, dtype=torch.float32)
        assert_close(plogits, np.asarray(logits), 1e-3, "prefill logits")
        for i in range(prefill_len, prefill_len + steps):
            logits, caches = ref_step(rp, caches, tokens[:, i:i + 1],
                                      jnp.int32(i))
            plogits, pcaches = tf.decode_step(params, cfg, pcaches,
                                              t(tokens[:, i:i + 1]), i)
            assert_close(plogits, np.asarray(logits), 1e-3, f"step {i}")
            want = dict(tree_paths(jax.tree.map(np.asarray, caches)))
            for path, leaf in tree_paths(pcaches):
                assert_close(leaf, want[path], 1e-3, f"step {i} {path}")
    # the caches carry across as they are
    again = caches_from_numpy(jax.tree.map(np.asarray, caches), cfg, 2,
                              max_len, device="cpu")
    for path, leaf in tree_paths(again):
        assert_close(leaf, dict(tree_paths(pcaches))[path], 1e-3, str(path))
