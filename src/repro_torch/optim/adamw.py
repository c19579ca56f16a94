"""AdamW with float32 moments over parameters of any dtype, global-norm
clipping included.

The moments have the parameters' tree structure.  ``adamw_update``
returns new tensors and leaves its inputs as they are.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import (tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)


class OptState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def adamw_init(params) -> OptState:
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return OptState(mu=tree_map(f32, params), nu=tree_map(f32, params),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, the leaves
    summed one after another in the tree's flatten order."""
    total = 0
    for _, g in tree_paths(tree):
        total = total + g.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_update(grads, state: OptState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step: returns (new params, new state, gradient norm)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    c1 = 1.0 - torch.pow(b1, count.to(torch.float32))
    c2 = 1.0 - torch.pow(b2, count.to(torch.float32))

    def upd(g, m, v, p):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.square()
        step = (m / c1) / (torch.sqrt(v / c2) + eps)
        step = step + weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), m, v

    paths = [p for p, _ in tree_paths(params)]
    if [p for p, _ in tree_paths(grads)] != paths:
        raise ValueError("gradient and parameter trees differ")
    out = [upd(*leaves) for leaves in zip(
        tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
        tree_leaves(params))]
    new_params, mu, nu = (tree_unflatten(params, [o[i] for o in out])
                          for i in range(3))
    return new_params, OptState(mu=mu, nu=nu, count=count), gnorm
