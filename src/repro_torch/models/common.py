"""Parameter declarations and shared numeric building blocks.

Parameters are plain trees (nested dicts and lists) of tensors.  Every
leaf is declared as a :class:`PDef` carrying its shape, *logical* axis
names and initializer.  Two interpreters walk the same declaration tree:

  * ``abstract_params``  -> ``device="meta"`` tensors (shapes, no memory)
  * ``init_params``      -> materialized tensors from a ``torch.Generator``

The logical axis names are kept for the sharding layer, which maps them
onto a device mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.runtime import resolve_device

# ---------------------------------------------------------------------------
# parameter declarations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis names per dim
    init: str = "normal"                     # normal | zeros | ones | embed
    scale: float = 1.0                       # fan-in style scale override

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts and lists are nodes, any
    other value a leaf), with the matching leaves of the ``rest`` trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_paths(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, object]]:
    """(path, leaf) pairs of ``tree``; a path holds dict keys and list
    indices.  Dict keys come in sorted order, as the reference flattens."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (i,))
    else:
        yield path, tree


def _leaf_init(pd: PDef, generator: torch.Generator, dtype, device):
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dtype, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dtype, device=device)
    fan_in = pd.shape[0]
    std = pd.scale / math.sqrt(max(fan_in, 1))
    if pd.init == "embed":
        std = pd.scale
    return torch.empty(pd.shape, dtype=dtype, device=device).normal_(
        0.0, std, generator=generator)


def abstract_params(tree, dtype=torch.bfloat16):
    return tree_map(
        lambda pd: torch.empty(pd.shape, dtype=dtype, device="meta"), tree)


def init_params(tree, generator: torch.Generator, dtype=torch.bfloat16,
                device=None):
    """Materialize ``tree``: zeros, ones, or normals of the declared scale
    drawn from ``generator`` in ``dtype`` on ``device`` (the generator's
    device type must match it).  The same seed gives the same tensors; it
    does not reproduce the reference's ``jax.random`` draws — parity
    tests carry the reference's parameters across instead."""
    device = resolve_device(device)
    return tree_map(lambda pd: _leaf_init(pd, generator, dtype, device), tree)


def pad_to(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# numeric building blocks
# ---------------------------------------------------------------------------


def rms_norm(x, gamma, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def rope(x, positions, theta: float = 1e4):
    """Rotary embedding over split halves (not interleaved).
    x: [..., seq, heads, head_dim]; positions [..., seq]."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., :, None].float() * freqs       # [..., seq, half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def affine_scan(a, v, dim: int = 1):
    """Inclusive scan of the affine recurrence ``h_t = a_t h_{t-1} + v_t``
    (``h_{-1} = 0``) along ``dim``: returns (``prod_{s<=t} a_s``, ``h``).
    ``a`` broadcasts against ``v``.  A log-depth doubling scan
    (Hillis–Steele): each step combines every element with the one
    ``2**k`` before it, ``(a1, v1), (a2, v2) -> (a1 a2, v2 + a2 v1)`` —
    the reference's ``associative_scan`` combine, in another bracketing,
    so sums may differ from it by float rounding."""
    n = a.shape[dim]
    off = 1
    while off < n:
        a_lo, a_hi = a.narrow(dim, 0, n - off), a.narrow(dim, off, n - off)
        v_lo, v_hi = v.narrow(dim, 0, n - off), v.narrow(dim, off, n - off)
        v = torch.cat([v.narrow(dim, 0, off), v_hi + a_hi * v_lo], dim)
        a = torch.cat([a.narrow(dim, 0, off), a_hi * a_lo], dim)
        off *= 2
    return a, v


def round_to(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float.  The reference
    multiplies a bf16 array by a Python scalar in bf16 (the scalar is
    weakly typed, so it is rounded to bf16 first); torch keeps the scalar
    in float32, so the port rounds it itself."""
    return torch.tensor(value, dtype=dtype).item()


def softcap(logits, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}
