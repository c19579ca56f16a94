"""Parameter declarations and shared numeric building blocks.

Parameters are plain trees (nested dicts and lists) of tensors.  Every
leaf is declared as a :class:`PDef` carrying its shape, *logical* axis
names and initializer.  Three interpreters walk the same declaration tree:

  * ``abstract_params``  -> ``device="meta"`` tensors (shapes, no memory)
  * ``init_params``      -> materialized tensors from a ``torch.Generator``
  * ``param_pspecs``     -> ``P`` leaves via logical->mesh rules

Logical axis names are mapped to mesh axes by :data:`DEFAULT_RULES`.  Axes
that do not divide the mesh axis size must be padded by the config
(``pad_to``): divisibility is checked when a spec is built.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.pspec import P, mesh_shape
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


def _is_node_tuple(x) -> bool:
    """A plain tuple or a ``NamedTuple`` is a node of a tree; any other
    tuple subclass (a ``PartitionSpec``) is a leaf."""
    return type(x) is tuple or (isinstance(x, tuple) and hasattr(x, "_fields"))


def _rebuild_tuple(like, items):
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples and
    ``NamedTuple``s are nodes, any other value a leaf), with the matching
    leaves of the ``rest`` trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if _is_node_tuple(tree):
        return _rebuild_tuple(tree, [tree_map(fn, v, *(r[i] for r in rest))
                                     for i, v in enumerate(tree)])
    return fn(tree, *rest)


def tree_paths(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, object]]:
    """(path, leaf) pairs of ``tree``; a path holds dict keys and list or
    tuple indices.  Dict keys come in sorted order, then list, tuple and
    ``NamedTuple`` fields in order: the reference's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (k,))
    elif isinstance(tree, list) or _is_node_tuple(tree):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in flatten order (see ``tree_paths``)."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in flatten order, by
    ``leaves`` (as many as ``like`` has)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, list):
            return [build(v) for v in node]
        if _is_node_tuple(node):
            return _rebuild_tuple(node, [build(v) for v in node])
        return next(it)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_structure(tree) -> str:
    """A description of ``tree``'s nodes (their kinds, dict keys and
    lengths) with each leaf as ``*``, in flatten order."""
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k!r}:{tree_structure(tree[k])}"
                              for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ",".join(tree_structure(v) for v in tree) + "]"
    if _is_node_tuple(tree):
        return (type(tree).__name__ + "("
                + ",".join(tree_structure(v) for v in tree) + ")")
    return "*"


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


# ---------------------------------------------------------------------------
# logical axis -> mesh axis rules
# ---------------------------------------------------------------------------

# mesh axes: ("pod", "data", "model").  Single-pod mesh omits "pod".
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,               # sequence kept local in the baseline layout
    "kv_seq": "model",         # decode caches: overridden per cell by
                               # make_decode_step (model + unused batch axes)
    "vocab": "model",
    # FSDP/ZeRO-3: weight matrices are also sharded over "data" along
    # their embed dim
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "layers": None,
    "state": None,             # ssm state dim
    "ssm_heads": "model",
    "rec": "model",            # rg-lru recurrence features
    "conv": None,
    # activation feature dims (residual stream); the decode-step builder
    # maps it to "data" for single-stream decode
    "act_embed": None,
}


def rules_for_mesh(mesh) -> Dict[str, Any]:
    """Drop mesh axes not present (e.g. 'pod' on the single-pod mesh)."""
    names = set(mesh_shape(mesh).axis_names)
    out = {}
    for k, v in DEFAULT_RULES.items():
        if isinstance(v, tuple):
            vv = tuple(a for a in v if a in names)
            out[k] = vv if vv else None
        else:
            out[k] = v if v in names else None
    return out


# axes that fall back to replication when the dim does not divide the
# mesh extent (kv heads are often fewer than the model axis)
SOFT_AXES = frozenset({"kv_heads"})


def logical_to_pspec(axes: Sequence[Optional[str]], rules: Dict[str, Any],
                     shape: Optional[Sequence[int]] = None,
                     mesh=None) -> P:
    sizes = mesh_shape(mesh).shape if mesh is not None else None
    parts = []
    for i, a in enumerate(axes):
        m = rules.get(a) if a is not None else None
        if m is not None and shape is not None and sizes is not None:
            size = math.prod(sizes[x] for x in
                             ((m,) if isinstance(m, str) else m))
            if shape[i] % size != 0:
                if a in SOFT_AXES:
                    m = None
                else:
                    raise ValueError(
                        f"logical axis {a!r} (dim {shape[i]}) not divisible "
                        f"by mesh extent {size}; pad the config (pad_to)")
        parts.append(m)
    return P(*parts)


def param_pspecs(tree, rules: Dict[str, Any], mesh=None):
    return tree_map(
        lambda pd: logical_to_pspec(pd.axes, rules, pd.shape, mesh), tree)


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
    in float32, so the port rounds it itself (on a real CPU tensor,
    unseen by any active dispatch mode: the dry run's counters)."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return torch.tensor(value, dtype=dtype, device="cpu").item()


def softcap(logits, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}
