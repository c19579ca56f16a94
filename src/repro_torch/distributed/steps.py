"""Train / prefill / decode step builders and the sharding specs.

The spec functions (``batch_axes_for``, ``kv_seq_axes``, ``cache_pspecs``,
``train_state_specs``) are arithmetic over a mesh's axis names and sizes
(see ``distributed.pspec``): the reference's baseline layout, with
parameters on ``model`` (heads / mlp / experts / vocab) and ``data``
(the ``embed`` axis), batches on ("pod", "data") and decode caches'
``kv_seq`` on ``model`` plus any data axes the batch leaves unused.

The step builders run on one device: ``mesh`` is ``None`` or a mesh of
one device.  Placing the specs over a mesh of several devices is ROADMAP
item 8d and raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.shapes import ShapeCell
from repro_torch.distributed.pspec import P, mesh_devices, mesh_shape
from repro_torch.models import transformer as tf
from repro_torch.models.common import (abstract_params, param_pspecs,
                                       rules_for_mesh, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptState, adamw_update


# ---------------------------------------------------------------------------
# batch / cache sharding helpers
# ---------------------------------------------------------------------------

def batch_axes_for(mesh, batch: int) -> Tuple[str, ...]:
    """Greedy assignment of (pod, data) mesh axes to the batch dim."""
    m = mesh_shape(mesh)
    axes = []
    rem = batch
    for a in ("pod", "data"):
        if a in m.axis_names and rem % m.shape[a] == 0:
            axes.append(a)
            rem //= m.shape[a]
    return tuple(axes)


def kv_seq_axes(mesh, batch: int):
    names = mesh_shape(mesh).axis_names
    baxes = batch_axes_for(mesh, batch)
    return ["model"] + [a for a in ("pod", "data")
                        if a in names and a not in baxes]


def cache_pspecs(cfg: ModelConfig, mesh, batch: int, seq_len: int):
    """Spec trees of the decode caches (``transformer.init_caches``)."""
    sizes = mesh_shape(mesh).shape
    baxes = batch_axes_for(mesh, batch)
    b = tuple(baxes) or None
    seq_axes = kv_seq_axes(mesh, batch)

    def seq_spec(length: int):
        axes = []
        size = 1
        for a in seq_axes:
            if length % (size * sizes[a]) == 0:
                axes.append(a)
                size *= sizes[a]
        return tuple(axes) or None

    def one(kind: str):
        if kind in ("attn", "local"):
            L = min(seq_len, cfg.local_window) if (
                kind == "local" and cfg.local_window) else seq_len
            return {"k": P(b, seq_spec(L), None, None),
                    "v": P(b, seq_spec(L), None, None)}
        if kind == "ssm":
            return {"h": P(b, "model", None, None),
                    "conv": {"x": P(b, None, "model"),
                             "B": P(b, None, None),
                             "C": P(b, None, None)}}
        if kind == "rglru":
            return {"h": P(b, "model"), "conv": P(b, None, "model")}
        raise ValueError(kind)

    n_periods, rem = tf._split_layers(cfg)   # honors force_unroll/enc-dec
    specs: Dict[str, Any] = {}
    if n_periods:
        specs["scan"] = {f"pos{t}": tree_map(lambda s: P(None, *s), one(kind))
                         for t, kind in enumerate(cfg.pattern)}
    specs["rem"] = [one(cfg.layer_kinds[n_periods * len(cfg.pattern) + t])
                    for t in range(rem)]
    return specs


def _data_pspec(mesh, batch: int, extra_dims: int = 1):
    b = batch_axes_for(mesh, batch)
    return P(b or None, *([None] * extra_dims))


def train_state_specs(cfg: ModelConfig, mesh, fsdp: bool = True):
    rules = rules_for_mesh(mesh)
    if not fsdp:
        rules["embed"] = None          # replicate weights over "data"
    pspecs = param_pspecs(tf.pdefs(cfg), rules, mesh)
    opt_specs = OptState(mu=pspecs, nu=pspecs, count=P())
    return pspecs, opt_specs


# ---------------------------------------------------------------------------
# step builders (one device)
# ---------------------------------------------------------------------------

def _one_device(mesh, what: str) -> None:
    if mesh_devices(mesh) != 1:
        raise NotImplementedError(
            f"{what} over a mesh of {mesh_devices(mesh)} devices: placing "
            f"the specs over a device mesh is ROADMAP item 8d; pass "
            f"mesh=None or a one-device mesh")


def _accum_factor(mesh, global_batch: int, grad_accum: int) -> int:
    """The largest accumulation factor not above ``grad_accum`` that
    divides the global batch into microbatches the batch axes divide."""
    b_axes = batch_axes_for(mesh, global_batch) if mesh is not None else ()
    sizes = mesh_shape(mesh).shape if mesh is not None else {}
    A = grad_accum
    while global_batch % A or (global_batch // A) % max(
            1, math.prod(sizes[a] for a in b_axes)):
        A -= 1
    return A


def make_train_step(cfg: ModelConfig, mesh, cell: ShapeCell, *,
                    lr: float = 3e-4, grad_accum: int = 8,
                    fsdp: bool = True, moe_weight_gather: bool = False,
                    donate: bool = True):
    """Returns ``step(params, opt, tokens, targets, enc_frames=None) ->
    (params, opt, metrics)``.

    ``grad_accum`` splits the global batch into sequential microbatches;
    their gradients are summed in float32 and divided by their number,
    then one AdamW update at ``lr`` follows.  ``loss``, ``ce`` and
    ``aux`` are the microbatches' means.  ``fsdp``,
    ``moe_weight_gather`` and ``donate`` place or alias state on a mesh
    of several devices; on one device they change nothing.
    """
    _one_device(mesh, "make_train_step")
    A = _accum_factor(mesh, cell.global_batch, grad_accum)
    mb = cell.global_batch // A

    def step(params, opt, tokens, targets, enc_frames=None):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        z = torch.zeros((), dtype=torch.float32, device=tokens.device)
        loss_acc, ce_acc, aux_acc = z, z, z
        tok = tokens.reshape(A, mb, -1)
        tgt = targets.reshape(A, mb, -1)
        enc = (None if enc_frames is None else
               enc_frames.reshape((A, mb) + tuple(enc_frames.shape[1:])))
        for i in range(A):
            with torch.enable_grad():
                loss, (ce, aux) = tf.loss_fn(
                    live, cfg, tok[i], tgt[i], None if enc is None else enc[i])
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            g_acc = [a if g is None else a + g.float()
                     for a, g in zip(g_acc, grads)]
            del grads
            loss_acc = loss_acc + loss.detach()
            ce_acc = ce_acc + ce.detach()
            aux_acc = aux_acc + aux.detach()
        del live, leaves
        grads = tree_unflatten(params, [g / A for g in g_acc])
        del g_acc
        params2, opt2, gnorm = adamw_update(grads, opt, params, lr=lr)
        metrics = {"loss": loss_acc / A, "ce": ce_acc / A,
                   "aux": aux_acc / A, "gnorm": gnorm}
        return params2, opt2, metrics

    return step


def make_prefill(cfg: ModelConfig, mesh, cell: ShapeCell):
    """Returns ``fn(params, tokens, enc_frames=None) -> (logits, caches)``:
    ``transformer.prefill`` into caches of ``cell.seq_len``."""
    _one_device(mesh, "make_prefill")

    def fn(params, tokens, enc_frames=None):
        with torch.no_grad():
            return tf.prefill(params, cfg, tokens, cell.seq_len,
                              enc_frames=enc_frames)

    return fn


def make_decode_step(cfg: ModelConfig, mesh, cell: ShapeCell, *,
                     feature_shard=None, fsdp: bool = True):
    """Returns ``fn(params, caches, tokens, cache_pos, enc_out=None) ->
    (logits, caches)``: one ``transformer.decode_step``.  ``feature_shard``
    and ``fsdp`` place state on a mesh of several devices."""
    _one_device(mesh, "make_decode_step")

    def fn(params, caches, tokens, cache_pos, enc_out=None):
        with torch.no_grad():
            return tf.decode_step(params, cfg, caches, tokens, cache_pos,
                                  enc_out=enc_out)

    return fn


def make_abstract_inputs(cfg: ModelConfig, mesh, cell: ShapeCell,
                         dtype=torch.bfloat16):
    """Abstract (params, opt) / (params, caches) / (params,) of ``cell``'s
    kind as ``device="meta"`` tensors: no allocation."""
    params = abstract_params(tf.pdefs(cfg), dtype)
    if cell.kind == "train":
        def f32(a):
            return torch.empty(a.shape, dtype=torch.float32, device="meta")

        opt = OptState(mu=tree_map(f32, params), nu=tree_map(f32, params),
                       count=torch.empty((), dtype=torch.int32,
                                         device="meta"))
        return params, opt
    if cell.kind == "decode":
        return params, tf.init_caches(cfg, cell.global_batch, cell.seq_len,
                                      dtype, "meta")
    return (params,)
