"""Shared set-up of the LM parity tests (``test_torch_lm_*.py``,
``test_torch_models*.py``, ``test_torch_attention_paths.py``): the
reference's parameters carried across through numpy, seeded inputs, and
the normwise comparison the tolerances are stated in."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.models import transformer as rtf
from repro.models.common import init_params
from repro_torch.models.convert import params_from_numpy


def ref_params(cfg, pcfg, seed: int):
    """The reference's float32 parameters of ``cfg`` from ``jax.random.key
    (seed)``, and the port's copy of them (for ``pcfg``, the port's
    config) on the CPU."""
    rp = init_params(rtf.pdefs(cfg), jax.random.key(seed), jnp.float32)
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), pcfg,
                                 device="cpu")


def toy_inputs(cfg, seed: int, B: int = 2, S: int = 32):
    """Seeded tokens [B, S] (int32) and, for whisper, frames
    [B, encoder_len, d_model] scaled by 0.02 (float32), as numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    enc = None
    if cfg.is_encoder_decoder:
        enc = (rng.normal(size=(B, cfg.encoder_len, cfg.d_model))
               * 0.02).astype(np.float32)
    return tokens, enc


def t(a):
    """numpy -> CPU tensor (None stays None)."""
    return None if a is None else torch.from_numpy(np.array(a))


def assert_close(port, ref, tol: float, what: str = "", scale=None):
    """``max |port - ref| <= tol * scale``, ``scale`` the largest |ref|
    unless given (a gradient leaf that is zero up to rounding, such as a
    key bias's, is judged against the largest gradient of the tree)."""
    p = (port.detach().cpu().numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port)).astype(np.float64)
    r = np.asarray(ref).astype(np.float64)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    err = np.abs(p - r).max(initial=0.0)
    if scale is None:
        scale = np.abs(r).max(initial=0.0)
    assert err <= tol * scale, \
        f"{what}: max err {err:.3e} > {tol} * {scale:.3e}"
