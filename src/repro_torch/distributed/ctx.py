"""Activation-sharding context of the LM substrate.

Model code is mesh-agnostic; the step builders install the active mesh
here (``use``) and layers pin their big intermediates with
``constrain(x, ...)`` (logical axis names, the vocabulary of the
parameter rules).  With no mesh installed (unit tests, one device) every
function here is the identity on plain tensors.

With a mesh installed the model's tensors are ``DTensor``s:

* ``constrain`` computes the reference's parts (``'batch'`` is the
  installed batch axes, other names go through the rules; an axis
  already used is skipped; one whose extent is 1 or does not divide the
  dimension is dropped) and redistributes ``x`` to exactly those
  placements: every mesh dim not named is replicated, so a partial sum
  is reduced there.
* ``gather`` is the per-period weight gather: each stored leaf is
  redistributed to its compute placements (the batch axes replicated,
  ``model`` kept).  Autograd's backward of it reduce-scatters the
  gradient into the stored shard.
* ``local_op`` runs an op that has no DTensor sharding rule (the MoE
  dispatch's sorts and scatters, a cache write) on the local shards: it
  replicates the dims the op works along and keeps the rest, as GSPMD
  replicates an operand it cannot partition.
* plain tensors made inside the model (masks, iotas, rope tables) meet
  DTensors as replicated ones: ``use`` enters ``implicit_replication``.
"""
from __future__ import annotations

import math
from contextlib import ExitStack, contextmanager
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

_STATE: Dict[str, Any] = {"mesh": None, "rules": None, "batch_axes": None}


def install(mesh, rules: Dict[str, Any], batch_axes: Sequence[str]):
    _STATE.update(mesh=mesh, rules=dict(rules), batch_axes=tuple(batch_axes))


def clear():
    _STATE.update(mesh=None, rules=None, batch_axes=None)


def mesh():
    """The installed mesh, or ``None``."""
    return _STATE["mesh"]


def batch_axes() -> Tuple[str, ...]:
    return _STATE["batch_axes"] or ()


@contextmanager
def use(mesh, rules, batch_axes):
    """Install ``mesh`` for the ``with`` block.  On a ``DeviceMesh`` plain
    tensors meet DTensors as replicated ones inside the block."""
    old = dict(_STATE)
    install(mesh, rules, batch_axes)
    with ExitStack() as stack:
        if is_device_mesh(mesh):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack.enter_context(implicit_replication())
        try:
            yield
        finally:
            _STATE.update(old)


@contextmanager
def suspended():
    """No mesh installed, and no dispatch mode active, for the ``with``
    block: for tensors made only for their shapes (the dry run's counters
    must not see them)."""
    from torch.utils._python_dispatch import _disable_current_modes
    old = dict(_STATE)
    clear()
    try:
        with _disable_current_modes():
            yield
    finally:
        _STATE.update(old)


def zeros(shape, dtype, spec, mesh, device):
    """A zero DTensor of ``shape`` placed by ``spec`` on ``mesh``, this
    rank's shard made on ``device`` (``meta``: nothing allocated)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.pspec import placements
    places = placements(spec, mesh)
    local, _ = shard_extent(shape, mesh, places)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              mesh, places, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def is_device_mesh(m) -> bool:
    return getattr(m, "mesh_dim_names", None) is not None


def _sizes(m) -> Dict[str, int]:
    from repro_torch.distributed.pspec import mesh_shape
    return mesh_shape(m).shape


def constrain_parts(shape: Sequence[int], axes: Sequence[Optional[str]],
                    mesh=None, rules=None, batch_axes=None):
    """The parts of the spec ``constrain`` pins a tensor of ``shape`` to:
    one mesh axis name, tuple of names or ``None`` per dimension (the
    installed mesh, rules and batch axes unless given)."""
    mesh = _STATE["mesh"] if mesh is None else mesh
    rules = _STATE["rules"] if rules is None else rules
    batch_axes = _STATE["batch_axes"] if batch_axes is None else batch_axes
    sizes = _sizes(mesh)
    parts = []
    used = set()
    for i, a in enumerate(axes):
        if a is None:
            parts.append(None)
            continue
        m = batch_axes if a == "batch" else rules.get(a)
        if m is None or m == ():
            parts.append(None)
            continue
        names = tuple(n for n in ((m,) if isinstance(m, str) else tuple(m))
                      if n not in used)
        size = math.prod(sizes[n] for n in names)
        if not names or size <= 1 or shape[i] % size != 0:
            parts.append(None)
        else:
            used.update(names)
            parts.append(names[0] if len(names) == 1 else names)
    return tuple(parts)


def constrain(x, *axes: Optional[str]):
    """``axes``: one logical name (or None) per dim of ``x``; ``'batch'``
    maps to the installed batch mesh axes.  The identity with no mesh
    installed."""
    m = _STATE["mesh"]
    if m is None:
        return x
    from repro_torch.distributed.pspec import P, placements
    parts = constrain_parts(tuple(x.shape), axes)
    return _redistribute(x, placements(P(*parts), m))


def _redistribute(x, places):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(f"a mesh is installed but the tensor of shape "
                        f"{tuple(x.shape)} is not a DTensor")
    if tuple(x.placements) == tuple(places):
        return x
    y = x.redistribute(x.device_mesh, places)
    if not (y.is_contiguous() and y.to_local().is_contiguous()):
        # a shard cut along an inner dim may be laid out otherwise than
        # the DTensor's strides say, and a later view of it then fails:
        # make both contiguous
        y = DTensor.from_local(y.to_local().contiguous(), y.device_mesh,
                               y.placements, shape=y.shape,
                               stride=contiguous_strides(y.shape))
    return y


def contiguous_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(out))


def gather(tree):
    """The per-period weight gather: each DTensor leaf of ``tree`` with
    the installed batch axes replicated (``model`` kept).  The identity
    with no mesh installed."""
    m = _STATE["mesh"]
    if m is None:
        return tree
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.models.common import tree_map
    names = tuple(m.mesh_dim_names)
    drop = {names.index(a) for a in batch_axes()}

    def one(a):
        if not isinstance(a, DTensor):
            return a
        places = tuple(Replicate() if i in drop else p
                       for i, p in enumerate(a.placements))
        return _redistribute(a, places)

    return tree_map(one, tree)


def local_op(fn: Callable, *args, work_dims: Sequence[Sequence[int]]):
    """``fn(*locals)`` on the local shards of ``args``.

    ``work_dims[i]`` are the dims argument ``i`` is worked along: any
    mesh dim sharding one of them (or holding a partial sum) is
    replicated first; other shardings stay.  Every tensor ``fn`` returns
    is wrapped with the placements of the first argument after that step
    (its outputs have that argument's shape up to the worked dims).
    A gradient flows back to each argument as its shard's, and as a
    partial sum on the mesh dims where the argument is replicated but
    another is sharded (the ranks there worked on different data).  With
    no mesh installed, ``fn(*args)``."""
    m = _STATE["mesh"]
    if m is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    prepared = []
    for a, dims in zip(args, work_dims):
        if not isinstance(a, DTensor):
            prepared.append(a)
            continue
        dims = {d % a.ndim for d in dims}
        places = tuple(p if isinstance(p, Shard) and p.dim not in dims
                       else Replicate() for p in a.placements)
        prepared.append(_redistribute(a, places))
    varying = {i for a in prepared if isinstance(a, DTensor)
               for i, p in enumerate(a.placements) if isinstance(p, Shard)}
    like = prepared[0]
    out = fn(*(_to_local(a, varying) for a in prepared))

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        return DTensor.from_local(t, like.device_mesh, like.placements,
                                  run_check=False)

    if isinstance(out, tuple):
        return tuple(wrap(t) for t in out)
    return wrap(out)


def _to_local(a, varying):
    """``a``'s local tensor; its gradient comes back as a partial sum on the
    ``varying`` mesh dims where ``a`` is replicated."""
    from torch.distributed.tensor import DTensor, Partial
    if not isinstance(a, DTensor):
        return a
    grad = tuple(Partial() if i in varying and p.is_replicate() else p
                 for i, p in enumerate(a.placements))
    return a.to_local(grad_placements=grad)


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) of a local tensor over process groups whose ranks
    hold disjoint parts of it; the gradient, whole on every rank, passes
    through."""

    @staticmethod
    def forward(ctx_, x, groups):
        from torch.distributed import _functional_collectives as funcol
        for g in groups:
            x = funcol.wait_tensor(funcol.all_reduce(x, "sum", g))
        return x

    @staticmethod
    def backward(ctx_, g):
        return g, None


def einsum(eq: str, *operands):
    """``torch.einsum(eq, *operands)``; on a mesh, over DTensors with the
    placements chosen here rather than by DTensor's strategy search
    (which takes minutes for a contraction on a mesh of three dims).

    Per mesh dim: the letter the operands shard there (that of the
    largest operand where they disagree; the others are replicated) is
    sharded in every operand that holds it, at no cost.  A letter of the
    output leaves the result sharded there; a contracted one leaves each
    rank a partial sum, reduced at once (the ranks' slices of the
    contraction are disjoint).  The einsum runs on the local shards."""
    m = _STATE["mesh"]
    if m is None:
        return torch.einsum(eq, *operands)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    lhs, out_letters = eq.replace(" ", "").split("->")
    ins = lhs.split(",")
    ops = [a if isinstance(a, DTensor) else
           DTensor.from_local(a, m, [Replicate()] * m.ndim, run_check=False)
           for a in operands]
    places = [[p if isinstance(p, Shard) else Replicate()
               for p in a.placements] for a in ops]
    out_places, reduce_dims = [], []
    for i in range(m.ndim):
        held = {k: ins[k][places[k][i].dim] for k in range(len(ops))
                if isinstance(places[k][i], Shard)}
        if not held:
            out_places.append(Replicate())
            continue
        big = max(held, key=lambda k: ops[k].numel())
        letter = held[big]
        for k in range(len(ops)):
            places[k][i] = (Shard(ins[k].index(letter)) if letter in ins[k]
                            else Replicate())
        if letter in out_letters:
            out_places.append(Shard(out_letters.index(letter)))
        else:
            out_places.append(Replicate())
            reduce_dims.append(i)
    ops = [_redistribute(a, tuple(pl)) for a, pl in zip(ops, places)]
    varying = {i for pl in places for i, p in enumerate(pl)
               if isinstance(p, Shard)}
    out = torch.einsum(eq, *(_to_local(a, varying) for a in ops))
    if reduce_dims:
        out = _SumOver.apply(out, [m.get_group(i) for i in reduce_dims])
    return DTensor.from_local(out, m, out_places, run_check=False)


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of a local tensor whose last
    dim is split over ``groups``: the same steps as ATen's kernel, the max
    and the sum reduced over the groups; the backward is ATen's formula."""

    @staticmethod
    def forward(ctx_, x, groups):
        from torch.distributed import _functional_collectives as funcol
        m = torch.amax(x, -1, keepdim=True)
        for g in groups:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", g))
        m = m.masked_fill(m.abs() == float("inf"), 0)
        s = torch.sum(torch.exp(x - m), -1)
        for g in groups:
            s = funcol.wait_tensor(funcol.all_reduce(s, "sum", g))
        out = torch.log(s) + m.squeeze(-1)
        ctx_.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx_, g):
        x, out = ctx_.saved_tensors
        return g.unsqueeze(-1) * torch.exp(x - out.unsqueeze(-1)), None


def logsumexp(x):
    """``torch.logsumexp(x, -1)``.  On a mesh the last dim may stay sharded
    (vocab-sharded logits): each rank reduces its slice and the maxima and
    sums are reduced over the mesh dims that shard it; nothing of ``x`` is
    gathered."""
    m = _STATE["mesh"]
    if m is None:
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    last = x.ndim - 1
    places = tuple(p if isinstance(p, Shard) else Replicate()
                   for p in x.placements)
    x = _redistribute(x, places)
    groups = [m.get_group(i) for i, p in enumerate(places)
              if isinstance(p, Shard) and p.dim == last]
    varying = {i for i, p in enumerate(places) if isinstance(p, Shard)}
    out = _LogSumExp.apply(_to_local(x, varying), groups)
    return DTensor.from_local(
        out, m, tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                      else p for p in places), run_check=False)


def gold_logit(logits, targets):
    """``logits[..., targets]`` as the reference's iota-mask sum
    (``where(iota == target, logits, 0).sum(-1)``: one value and exact
    zeros).  On a mesh the last dim may stay sharded: each rank sums its
    slice and the slices are summed over the mesh dims that shard it."""
    m = _STATE["mesh"]
    if m is None:
        iota = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(iota == targets[..., None], logits, 0.0).sum(-1)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    last = logits.ndim - 1
    places = tuple(p if isinstance(p, Shard) else Replicate()
                   for p in logits.placements)
    x = _redistribute(logits, places)
    t = _redistribute(targets, tuple(
        p if isinstance(p, Shard) and p.dim < last else Replicate()
        for p in places))
    varying = {i for i, p in enumerate(places) if isinstance(p, Shard)}
    x_loc = _to_local(x, varying)
    (_, off) = shard_extent(x.shape, m, places)
    iota = torch.arange(x_loc.shape[-1], device=x_loc.device) + off[-1]
    part = torch.where(iota == t.to_local()[..., None], x_loc, 0.0).sum(-1)
    groups = [m.get_group(i) for i, p in enumerate(places)
              if isinstance(p, Shard) and p.dim == last]
    if groups:
        part = _SumOver.apply(part, groups)
    return DTensor.from_local(
        part, m, tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                       else p for p in places), run_check=False)


def embed(tokens, weight):
    """``F.embedding(tokens, weight)``.  On a mesh, ``weight`` may be
    sharded on its vocab dim: each rank looks up the tokens of its rows in
    its vocab slice (zeros elsewhere) and the slices are summed over the
    mesh dims that shard the vocab (one value and exact zeros, so the
    lookup's bits); a sharded feature dim stays sharded."""
    import torch.nn.functional as F
    m = _STATE["mesh"]
    if m is None:
        return F.embedding(tokens, weight)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    tp = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in tokens.placements)
    wp = tuple(Replicate() if isinstance(tp[i], Shard) or p.is_partial()
               else p for i, p in enumerate(weight.placements))
    tok = _redistribute(tokens, tp)
    w = _redistribute(weight, wp)
    varying = {i for i, p in enumerate(tp) if isinstance(p, Shard)} | \
        {i for i, p in enumerate(wp) if isinstance(p, Shard)}
    t_loc, w_loc = tok.to_local(), _to_local(w, varying)
    (n, _), (lo, _) = local_offsets(w)
    vocab_dims = [i for i, p in enumerate(wp)
                  if isinstance(p, Shard) and p.dim == 0]
    idx = t_loc.long() - lo
    inside = (idx >= 0) & (idx < n)
    out = F.embedding(idx.clamp(0, n - 1), w_loc)
    if vocab_dims:
        out = out * inside[..., None].to(out.dtype)
        out = _SumOver.apply(out, [m.get_group(i) for i in vocab_dims])
    places = tuple(
        tp[i] if isinstance(tp[i], Shard) else
        (Shard(tokens.ndim) if isinstance(p, Shard) and p.dim == 1
         else Replicate())
        for i, p in enumerate(wp))
    return DTensor.from_local(out, m, places, run_check=False)


def dim_extent(x, dim: int) -> int:
    """Over how many ranks dimension ``dim`` of ``x`` is split (1 for a
    plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return 1
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim % x.ndim:
            n *= x.device_mesh.size(i)
    return n


def local_offsets(x) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of this rank's shard of ``x``: a
    plain tensor's own shape at offset 0."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return tuple(x.shape), (0,) * x.ndim
    return shard_extent(x.shape, x.device_mesh, x.placements)


def shard_extent(shape, mesh, places):
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` placed by ``places`` on ``mesh`` (computed on real tensors
    whatever dispatch mode is active: the dry run runs on fake ones)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        local, off = compute_local_shape_and_global_offset(
            torch.Size(shape), mesh, tuple(places))
    return tuple(local), tuple(off)


def write_seq(cache, block, start: int) -> None:
    """``cache[:, start:start + n] = block`` in place (``block`` is
    ``[B, n, ...]``, dim 1 the sequence).  On a DTensor cache each rank
    writes the part of ``block`` that falls in its shard of the sequence;
    ``block`` is first placed as the cache's batch dim is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    n = block.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, start:start + n] = block.to(cache.dtype)
        return
    if not isinstance(block, DTensor):
        raise TypeError("a DTensor cache takes a DTensor block")
    places = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in cache.placements)
    blk = _redistribute(block, places).to_local()
    (_, L, *_), (_, off, *_) = local_offsets(cache)
    lo, hi = max(start, off), min(start + n, off + L)
    if lo < hi:
        cache.to_local()[:, lo - off:hi - off] = \
            blk[:, lo - start:hi - start].to(cache.dtype)


def full(x):
    """``x`` as a plain tensor holding the whole of it (a DTensor's
    ``full_tensor()``)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x
