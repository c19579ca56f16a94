"""Carry-across of the reference's LM parameters and decode caches.

The reference's trees arrive as numpy arrays (``np.asarray`` of each
leaf, dicts and lists kept) and become the port's tensors on a device.
Every path and shape is checked against the port's own declaration —
``transformer.pdefs(cfg)`` for parameters, ``transformer.init_caches``
for caches — so a tree of another configuration is refused rather than
half loaded.  Nothing here imports the reference package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import transformer as tf
from .common import tree_paths
from .config import ModelConfig
from repro_torch.kernels.runtime import resolve_device


def _with_paths(spec, fn, path=()):
    """``spec``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(spec, dict):
        return {k: _with_paths(v, fn, path + (k,)) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_with_paths(v, fn, path + (i,)) for i, v in enumerate(spec)]
    return fn(path, spec)


def _carry(tree, spec, device, dtype, what: str):
    """``tree``'s arrays as tensors in ``spec``'s structure: ``tree`` must
    hold exactly ``spec``'s paths, each at its shape."""
    got = dict(tree_paths(tree))
    want = set(p for p, _ in tree_paths(spec))
    if set(got) != want:
        raise ValueError(f"{what}: paths differ; missing "
                         f"{sorted(map(str, want - set(got)))}, extra "
                         f"{sorted(map(str, set(got) - want))}")

    def leaf(path, s):
        # a copy: decode writes the attention caches in place
        a = np.array(got[path])
        if a.shape != tuple(s.shape):
            raise ValueError(f"{what}: {path} has shape {a.shape}, "
                             f"expected {tuple(s.shape)}")
        t = torch.from_numpy(a)
        return t.to(device=device, dtype=dtype or t.dtype)

    return _with_paths(spec, leaf)


def params_from_numpy(tree, cfg: ModelConfig, *, device=None,
                      dtype: Optional[torch.dtype] = None):
    """The port's parameters of ``cfg`` from the reference's tree of numpy
    arrays, copied to ``device`` (the GPU when not given), in ``dtype``
    or each array's own."""
    return _carry(tree, tf.pdefs(cfg), resolve_device(device), dtype,
                  "params")


def caches_from_numpy(tree, cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None):
    """The port's decode caches from the reference's (e.g. its
    ``prefill``'s), checked against ``init_caches(cfg, batch, max_len)``,
    copied to ``device`` (the GPU when not given).  Each array keeps its
    dtype: the reference's recurrent states are float32 and its conv
    tails take the activations' dtype."""
    spec = tf.init_caches(cfg, batch, max_len, torch.float32, "meta")
    return _carry(tree, spec, resolve_device(device), None, "caches")
