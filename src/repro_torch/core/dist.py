"""Distributed solver paths on ``torch.distributed``.

Two modes, as in the reference:

* :func:`sharded_pcg` — ONE huge system: its edges sharded across the
  ranks of a mesh axis, the Laplacian matvec a local partial product
  plus an ``all_reduce`` (vectors replicated), the preconditioner
  replicated on every rank.
* :func:`batched_factorize` — MANY independent factorizations of one
  graph under different keys (the incremental-sparsification ensemble):
  the keys sharded across the ranks, no communication until the final
  gather; each key's state is bit-identical to the single-device
  engine's.

Every rank runs the same PCG loop on replicated vectors, so every loop
decision must come out the same on every rank: the local product sums
adjacency rows left to right (no float atomics) and the all-reduce hands
every rank the same bits.  A rank that diverged would wait in a
collective that the others never enter.

``mesh`` is a ``DeviceMesh`` (``launch.mesh.make_host_mesh``); ``axis``
names the mesh dim whose process group carries the collective.  Vectors
and states live on the mesh's device: the current CUDA device for a
``"cuda"`` mesh, which ``launch.mesh.init_group`` sets per rank.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from .laplacian import Graph
from .parac import (EngineState, _build_pool, _finalize_factor, _init_engine,
                    _next_pow2, _pool_edges, _run_engine_batched)
from .pcg import PCGResult, _laplacian_operator, pcg
from .ref_ac import ACFactor


def _pad_edges(g: Graph, multiple: int):
    m = g.m
    pad = (-m) % multiple
    src = np.concatenate([g.src, np.zeros(pad, np.int32)])
    dst = np.concatenate([g.dst, np.zeros(pad, np.int32)])
    w = np.concatenate([g.w, np.zeros(pad, np.float32)])
    return src, dst, w


def _axis(mesh, axis: str):
    """The axis's process group, its size and this rank's index in it."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), mesh.get_local_rank(axis)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_sharded_matvec(g: Graph, mesh, axis: str = "data") -> Callable:
    """Edge-sharded Laplacian matvec ``x -> L x`` for a replicated ``x``
    (``(n,)`` or ``(nrhs, n)``): the edge list is padded with zero-weight
    ``(0, 0)`` edges to a multiple of the shard count and each rank takes
    its contiguous slice.  A rank multiplies by the adjacency rows of its
    slice's own vertices only (``laplacian_pcg``'s operator on the slice,
    its vertices renumbered in order; the weights in the first ``x``'s
    dtype), writes each row once into a zero ``y`` and one ``all_reduce``
    sums the partial products.  So a rank's work and tables are its
    touched vertices times their largest degree in the slice, and with
    one shard this is ``laplacian_pcg``'s operator term for term."""
    group, n_sh, r = _axis(mesh, axis)
    src, dst, w = _pad_edges(g, n_sh)
    per = src.shape[0] // n_sh
    own = slice(r * per, (r + 1) * per)
    touched = np.zeros(g.n, bool)
    touched[src[own]] = touched[dst[own]] = True
    local = (np.cumsum(touched) - 1).astype(np.int32)
    shard = Graph(int(touched.sum()), local[src[own]], local[dst[own]],
                  w[own])
    rows = torch.as_tensor(np.flatnonzero(touched),
                           device=_mesh_device(mesh))
    op = None

    def mv(x: torch.Tensor) -> torch.Tensor:
        nonlocal op
        if op is None:
            op = _laplacian_operator(shard, x)
        y = torch.zeros_like(x)
        y.index_copy_(-1, rows, op(x.index_select(-1, rows)))
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    return mv


def sharded_pcg(g: Graph, mesh, precond: Callable, b, *, axis: str = "data",
                tol: float = 1e-6, maxiter: int = 500) -> PCGResult:
    """PCG on ``L(g) x = b`` with the edge-sharded matvec and the
    replicated ``precond`` (e.g. a ``make_preconditioner`` apply), every
    rank holding ``b`` and running the same iterations."""
    b = torch.as_tensor(b, device=_mesh_device(mesh))
    return pcg(make_sharded_matvec(g, mesh, axis), precond, b, tol=tol,
               maxiter=maxiter)


def _gather_state(s: EngineState, group, n_sh: int, r: int) -> EngineState:
    """Every rank's slice of the batch, stacked in rank order, on every
    rank.  Each rank writes its slice into a zeroed buffer of the whole
    batch and one ``all_reduce`` sums the int32 words: exact for any bits,
    since the other ranks add zeros (a float sum would turn -0 into +0).
    ``all_reduce`` is the collective NCCL and gloo both take on CUDA
    tensors."""
    per = s.n_elim.shape[0]
    words = [(t.to(torch.int32) if t.dtype == torch.bool
              else t.view(torch.int32)).reshape(per, -1) for t in s]
    widths = [w.shape[1] for w in words]
    buf = torch.zeros((n_sh, per, sum(widths)), dtype=torch.int32,
                      device=s.n_elim.device)
    torch.cat(words, dim=1, out=buf[r])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    buf = buf.view(n_sh * per, -1)
    out, off = [], 0
    for t, w in zip(s, widths):
        x = buf[:, off:off + w].contiguous()
        off += w
        x = x.to(torch.bool) if t.dtype == torch.bool else x.view(t.dtype)
        out.append(x.view(n_sh * per, *t.shape[1:]))
    return EngineState(*out)


def batched_factorize(g: Graph, keys, mesh, *, chunk: int = 256,
                      fill_slack: int = 32, axis: str = "data"
                      ) -> EngineState:
    """Factorize ``g`` under each of the ``B`` keys (``(B, 2)`` uint32,
    ``B`` a multiple of the shard count), the keys sharded over ``axis``:
    every rank builds the pool once and runs one non-strict attempt of the
    batched engine on its own slice of keys (one elimination launch per
    round for the whole slice).  Returns the stacked ``EngineState`` of
    all ``B`` keys on every rank, in the reference's shapes (pool fields
    ``(B, P)``, vertex fields ``(B, n)``, counters ``(B,)``); key ``b``'s
    factor is :func:`ensemble_factor`."""
    group, n_sh, r = _axis(mesh, axis)
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    B = keys.shape[0]
    if B % n_sh:
        raise ValueError(f"{B} keys do not split over {n_sh} shards")
    per = B // n_sh
    n = g.n
    built = _build_pool(_pool_edges(g, np.float32, _mesh_device(mesh)),
                        fill_slack)
    P = built.P
    s, st = _init_engine([built] * per, list(keys[r * per:(r + 1) * per]),
                         n_pad=n, P_pad=P, W=max(_next_pow2(built.dmax), 2),
                         chunk=min(chunk, max(n, 1)))
    _run_engine_batched(s, st)
    # the reference's shapes: the drop entries (pool slot P, column n) go
    s = s._replace(pool_row=s.pool_row[:, :P], pool_val=s.pool_val[:, :P],
                   col_fill=s.col_fill[:, :n], dep=s.dep[:, :n],
                   elim=s.elim[:, :n], D=s.D[:, :n])
    return _gather_state(s, group, n_sh, r)


def ensemble_factor(g: Graph, state: EngineState, b: int) -> ACFactor:
    """Key ``b``'s factor out of :func:`batched_factorize`'s ``state``: its
    pool compacted to CSC on the state's device, as ``factorize_wavefront``
    returns it.  The fill slack follows from the pool's width,
    ``P = m + n·fill_slack``, and with it each column's base slot."""
    n, P = g.n, state.pool_row.shape[1]
    slack, rem = divmod(P - g.m, max(n, 1))
    if rem or slack < 0:
        raise ValueError(f"{P} pool slots are not {g.m} edges plus a whole "
                         f"fill slack for each of {n} vertices")
    col_base = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(g.src, minlength=n) + slack, out=col_base[1:])
    one = EngineState(*(t[b:b + 1] for t in state))
    static = SimpleNamespace(col_base=torch.as_tensor(
        col_base, device=state.pool_row.device)[None])
    stats = dict(rounds=int(state.n_rounds[b]),
                 overflow=int(state.overflow[b]), fill_slack=slack)
    return _finalize_factor(g, one, static, 0, stats=stats)
