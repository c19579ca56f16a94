"""Train / prefill / decode step builders and the sharding specs.

The spec functions (``batch_axes_for``, ``kv_seq_axes``, ``cache_pspecs``,
``train_state_specs``) are arithmetic over a mesh's axis names and sizes
(see ``distributed.pspec``): the reference's baseline layout, with
parameters on ``model`` (heads / mlp / experts / vocab) and ``data``
(the ``embed`` axis), batches on ("pod", "data") and decode caches'
``kv_seq`` on ``model`` plus any data axes the batch leaves unused.

The step builders run on one device (``mesh`` ``None`` or a stand-in of
one device) or over a ``torch.distributed`` ``DeviceMesh``: state is
then ``DTensor``s placed by these specs (``shard_state``), the step runs
with the mesh installed in ``distributed.ctx`` (the reference's rules
and their per-builder overrides) and returns its results placed by the
reference's output specs.  A world-1 mesh computes the bits of
``mesh=None``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.shapes import ShapeCell
from repro_torch.distributed import ctx
from repro_torch.distributed.pspec import (P, mesh_devices, mesh_shape,
                                           placements)
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
# placing state on a mesh
# ---------------------------------------------------------------------------

def _on_mesh(mesh, what: str) -> bool:
    """Whether ``what`` runs over a ``DeviceMesh`` (else on one device:
    ``None`` or a stand-in of one device)."""
    if mesh is None:
        return False
    if ctx.is_device_mesh(mesh):
        return True
    if mesh_devices(mesh) != 1:
        raise TypeError(f"{what} over {mesh_devices(mesh)} devices needs a "
                        f"torch DeviceMesh, not a stand-in of its shape")
    return False


def shard_state(tree, specs, mesh):
    """Each tensor leaf of ``tree`` (whole, the same on every rank) as a
    DTensor placed by its ``P`` in ``specs``; each rank keeps its shard and
    nothing is sent.  Other leaves pass through."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(a, spec):
        if not isinstance(a, torch.Tensor):
            return a
        places = placements(spec, mesh)
        if isinstance(a, DTensor):
            return a.redistribute(mesh, places)
        return distribute_tensor(a, mesh, places, src_data_rank=None)

    return tree_map(one, tree, specs)


def unshard(tree):
    """Each DTensor leaf of ``tree`` as the whole tensor (on every rank)."""
    return tree_map(ctx.full, tree)


def _place(x, spec, mesh):
    """A plain input (whole, the same on every rank) or a DTensor, placed by
    ``spec``; ``None`` stays ``None``."""
    if x is None:
        return None
    return shard_state(x, spec, mesh)


def _squeezed(mesh):
    """``mesh`` without its dims of extent 1, over the same ranks: such a
    dim shards nothing, and DTensor's sharding propagation costs grow with
    the mesh's dims.  ``mesh`` itself when it has none."""
    names = tuple(n for i, n in enumerate(mesh.mesh_dim_names)
                  if mesh.size(i) > 1)
    if len(names) in (0, mesh.ndim):
        return mesh
    return mesh[names if len(names) > 1 else names[0]]


def _move(tree, mesh):
    """Each DTensor leaf of ``tree`` on ``mesh``, the same ranks' same local
    shards: a mesh dim only one of the two meshes has is of extent 1 (its
    placement is dropped, or added as ``Replicate``)."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(a):
        if not isinstance(a, DTensor) or a.device_mesh is mesh:
            return a
        names = a.device_mesh.mesh_dim_names
        places = tuple(a.placements[names.index(n)] if n in names
                       else Replicate() for n in mesh.mesh_dim_names)
        return DTensor.from_local(a.to_local(), mesh, places,
                                  run_check=False, shape=a.shape,
                                  stride=a.stride())

    return tree_map(one, tree)


def _rules(mesh, fsdp: bool = True, moe_weight_gather: bool = False):
    rules = rules_for_mesh(mesh)
    if not fsdp:
        rules["embed"] = None
    if moe_weight_gather:
        # keep MoE token buffers batch-sharded only; the expert GEMMs then
        # gather the expert weights over `model`
        rules["experts"] = None
    return rules


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

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
    ``aux`` are the microbatches' means.

    Over a ``DeviceMesh``: ``params`` and ``opt`` are DTensors placed by
    ``train_state_specs(cfg, mesh, fsdp)`` (``shard_state``), the inputs
    whole tensors (or DTensors); each microbatch is placed on the batch
    axes, and the new state comes back placed by the specs, the metrics
    as whole tensors.  ``moe_weight_gather`` keeps MoE buffers off
    ``model``.  ``donate`` is the reference's buffer donation; the port
    never aliases its inputs.
    """
    on_mesh = _on_mesh(mesh, "make_train_step")
    A = _accum_factor(mesh, cell.global_batch, grad_accum)
    mb = cell.global_batch // A
    if on_mesh:
        pspecs, opt_specs = train_state_specs(cfg, mesh, fsdp=fsdp)
        cmesh = _squeezed(mesh)
        b_axes = batch_axes_for(cmesh, cell.global_batch)
        rules = _rules(cmesh, fsdp, moe_weight_gather)
        tok_spec = P(b_axes or None, None)
        enc_spec = P(b_axes or None, None, None)
        scope = lambda: ctx.use(cmesh, rules, b_axes)
    else:
        scope = contextlib.nullcontext

    def step(params, opt, tokens, targets, enc_frames=None):
        tok = ctx.full(tokens).reshape(A, mb, -1)
        tgt = ctx.full(targets).reshape(A, mb, -1)
        enc = (None if enc_frames is None else ctx.full(enc_frames).reshape(
            (A, mb) + tuple(enc_frames.shape[1:])))
        if on_mesh:
            params, opt = _move((params, opt), cmesh)
        with scope():
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            live = tree_unflatten(params, leaves)
            g_acc = [_zeros_f32(p) for p in leaves]
            z = torch.zeros((), dtype=torch.float32, device=tokens.device)
            loss_acc, ce_acc, aux_acc = z, z, z
            for i in range(A):
                ti, gi = tok[i], tgt[i]
                ei = None if enc is None else enc[i]
                if on_mesh:
                    ti, gi = (_place(ti, tok_spec, cmesh),
                              _place(gi, tok_spec, cmesh))
                    ei = _place(ei, enc_spec, cmesh)
                with torch.enable_grad():
                    loss, (ce, aux) = tf.loss_fn(live, cfg, ti, gi, ei)
                    grads = torch.autograd.grad(loss, leaves,
                                                allow_unused=True)
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
            if on_mesh:
                params2, opt2 = _move((params2, opt2), mesh)
                params2 = shard_state(params2, pspecs, mesh)
                opt2 = shard_state(opt2, opt_specs, mesh)
                metrics = {k: ctx.full(v) for k, v in metrics.items()}
        return params2, opt2, metrics

    return step


def _zeros_f32(p):
    """float32 zeros of ``p``'s shape where ``p`` lives (as ``p`` is placed,
    for a DTensor)."""
    if ctx.mesh() is not None:
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def make_prefill(cfg: ModelConfig, mesh, cell: ShapeCell, *,
                 cache_dtype=torch.bfloat16):
    """Returns ``fn(params, tokens, enc_frames=None) -> (logits, caches)``:
    ``transformer.prefill`` into caches of ``cell.seq_len`` in
    ``cache_dtype`` (``transformer.prefill``'s default, as the reference
    builds them).  Over a ``DeviceMesh`` the logits come back placed
    ``P(b, None, None)`` and the caches by ``cache_pspecs``."""
    if not _on_mesh(mesh, "make_prefill"):
        def fn(params, tokens, enc_frames=None):
            with torch.no_grad():
                return tf.prefill(params, cfg, tokens, cell.seq_len,
                                  enc_frames=enc_frames, dtype=cache_dtype)

        return fn
    cmesh = _squeezed(mesh)
    b_axes = batch_axes_for(cmesh, cell.global_batch)
    rules = _rules(cmesh)
    tok_spec = _data_pspec(cmesh, cell.global_batch)
    cspecs = cache_pspecs(cfg, mesh, cell.global_batch, cell.seq_len)
    out_spec = _data_pspec(mesh, cell.global_batch, 2)

    def fn(params, tokens, enc_frames=None):
        with torch.no_grad(), ctx.use(cmesh, rules, b_axes):
            logits, caches = tf.prefill(
                _move(params, cmesh), cfg, _place(tokens, tok_spec, cmesh),
                cell.seq_len, enc_frames=_place(
                    enc_frames, P(b_axes or None, None, None), cmesh),
                dtype=cache_dtype)
            logits, caches = _move((logits, caches), mesh)
            return (shard_state(logits, out_spec, mesh),
                    shard_state(caches, cspecs, mesh))

    return fn


def make_decode_step(cfg: ModelConfig, mesh, cell: ShapeCell, *,
                     feature_shard=None, fsdp: bool = True):
    """Returns ``fn(params, caches, tokens, cache_pos, enc_out=None) ->
    (logits, caches)``: one ``transformer.decode_step``.  Over a
    ``DeviceMesh`` the caches are DTensors placed by ``cache_pspecs``
    (``make_prefill``'s, or ``shard_state``'s), ``kv_seq`` follows
    ``kv_seq_axes`` and ``feature_shard`` (by default: when the batch
    leaves ``data`` unused) puts activation features on ``data``; the
    logits come back placed ``P(b, "model")``."""
    if not _on_mesh(mesh, "make_decode_step"):
        def fn(params, caches, tokens, cache_pos, enc_out=None):
            with torch.no_grad():
                return tf.decode_step(params, cfg, caches, tokens,
                                      cache_pos, enc_out=enc_out)

        return fn
    b_axes = batch_axes_for(mesh, cell.global_batch)
    cmesh = _squeezed(mesh)
    rules = _rules(cmesh, fsdp)
    rules["kv_seq"] = tuple(a for a in kv_seq_axes(mesh, cell.global_batch)
                            if a in cmesh.mesh_dim_names)
    if feature_shard is None:
        # single-stream decode leaves "data" idle for the batch: use it
        # for activation features
        feature_shard = "data" not in b_axes
    if feature_shard and "data" in cmesh.mesh_dim_names:
        rules["act_embed"] = "data"
    b_axes = tuple(a for a in b_axes if a in cmesh.mesh_dim_names)
    tok_spec = P(b_axes or None, None)
    cspecs = cache_pspecs(cfg, mesh, cell.global_batch, cell.seq_len)
    out_spec = P(batch_axes_for(mesh, cell.global_batch) or None, "model")

    def fn(params, caches, tokens, cache_pos, enc_out=None):
        with torch.no_grad(), ctx.use(cmesh, rules, b_axes):
            logits, new = tf.decode_step(
                _move(params, cmesh), cfg, _move(caches, cmesh),
                _place(tokens, tok_spec, cmesh), cache_pos,
                enc_out=_place(enc_out, P(b_axes or None, None, None),
                               cmesh))
            logits, new = _move((logits, new), mesh)
            return (shard_state(logits, out_spec, mesh),
                    shard_state(new, cspecs, mesh))

    return fn


def make_abstract_inputs(cfg: ModelConfig, mesh, cell: ShapeCell,
                         dtype=torch.bfloat16, *, local: bool = False,
                         fsdp: bool = True):
    """Abstract (params, opt) / (params, caches) / (params,) of ``cell``'s
    kind as ``device="meta"`` tensors: no allocation.  With ``local`` (a
    ``DeviceMesh``), each leaf is a DTensor placed by its spec
    (``train_state_specs(cfg, mesh, fsdp)``, ``cache_pspecs``) whose local
    shard is a ``meta`` tensor of this rank's shape."""
    params = abstract_params(tf.pdefs(cfg), dtype)
    if cell.kind == "train":
        def f32(a):
            return torch.empty(a.shape, dtype=torch.float32, device="meta")

        out = (params, OptState(
            mu=tree_map(f32, params), nu=tree_map(f32, params),
            count=torch.empty((), dtype=torch.int32, device="meta")))
        specs = train_state_specs(cfg, mesh, fsdp) if local else None
    elif cell.kind == "decode":
        out = (params, tf.init_caches(cfg, cell.global_batch, cell.seq_len,
                                      dtype, "meta"))
        specs = (train_state_specs(cfg, mesh, fsdp)[0], cache_pspecs(
            cfg, mesh, cell.global_batch, cell.seq_len)) if local else None
    else:
        out = (params,)
        specs = (train_state_specs(cfg, mesh, fsdp)[0],) if local else None
    if not local:
        return out
    return tree_map(lambda a, spec: ctx.zeros(a.shape, a.dtype, spec, mesh,
                                              "meta"), out, specs)
