"""Batched vertex elimination: the ``sample_clique`` CUDA kernels, their
wrappers and their plain PyTorch versions.

Replaces the TPU kernel ``repro/kernels/sample_clique.py``
(``sample_clique_pallas``).  The kernel source is
``csrc/sample_clique.cu``, with two entry points on the same device code:

* ``sample_clique`` — rows ``[R, W]`` in, the eight outputs of
  ``core.column_math.eliminate_column`` out, which it must equal bit for
  bit (plain version ``sample_clique_plain``);
* ``eliminate_round`` — one round of the wavefront engine's elimination
  stage, fused: gather each candidate's slab and uniforms from the engine
  state, eliminate it and commit in place, and return the sampled edges
  ``[B*chunk, W]`` for the scatter stage.  Its plain version
  (``eliminate_round_plain``) is the composition ``round_gather`` →
  ``sample_clique_plain`` → ``round_commit``; the engine state after the
  round (drop entries aside) and the edges must equal it bit for bit.

Both eliminate each row at its own width ``max(next_pow2(fill), 2)``,
which gives the bits of width ``W`` (the argument is in the source).  A
CPU tensor takes the plain version, a CUDA tensor the kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.column_math import INVALID_ID, ColumnElim, eliminate_column
from . import runtime

NAME = "sample_clique"
ROUND = "sample_clique_round"     # launch counter of the fused round
MAX_WIDTH = 16384          # 12·W bytes of shared memory per row

I64 = torch.int64


class RoundEdges(NamedTuple):
    """Sampled edges of a round, rows ``[B*chunk, W]`` right-aligned as
    ``ColumnElim`` holds them (select with ``e_valid``)."""

    e_lo: torch.Tensor     # int32
    e_hi: torch.Tensor     # int32
    e_w: torch.Tensor      # f32
    e_valid: torch.Tensor  # bool


def sample_clique_plain(ids, ws, fill, u) -> ColumnElim:
    """The plain version: rows ``[R, W]`` with ``fill[r]`` valid lanes."""
    W = ids.shape[1]
    valid = (torch.arange(W, device=ids.device)[None, :]
             < fill.to(torch.int64)[:, None])
    return eliminate_column(ids, ws, valid, u)


def _lib():
    lib = runtime.load(NAME)
    f = lib.sample_clique_launch
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    g = lib.sample_clique_round_launch
    g.restype = ctypes.c_int
    g.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def _check_width(what: str, W: int) -> None:
    if W < 2 or W & (W - 1) or W > MAX_WIDTH:
        raise ValueError(f"{what}: W={W} must be a power of two in "
                         f"[2, {MAX_WIDTH}]")


def sample_clique(ids, ws, fill, u) -> ColumnElim:
    """Eliminate ``R`` rows: ids int32 ``[R, W]``, ws/u float32 ``[R, W]``,
    fill int32 ``[R]`` (lanes ``< fill`` are valid).  ``W`` must be a
    power of two on the GPU (``ops.sample_clique`` pads)."""
    if ids.device.type == "cpu":
        return sample_clique_plain(ids, ws, fill, u)
    if ids.device.type != "cuda":
        raise ValueError(f"sample_clique: unsupported device {ids.device}")
    R, W = ids.shape
    dev = ids.device
    runtime.require(ids, "ids", torch.int32, 2, dev)
    runtime.require(ws, "ws", torch.float32, 2, dev)
    runtime.require(u, "u", torch.float32, 2, dev)
    runtime.require(fill, "fill", torch.int32, 1, dev)
    if ws.shape != (R, W) or u.shape != (R, W) or fill.shape != (R,):
        raise ValueError("sample_clique: ids/ws/u must be [R, W], fill [R]")
    _check_width("sample_clique", W)
    out = ColumnElim(
        g_rows=torch.empty((R, W), dtype=torch.int32, device=dev),
        g_vals=torch.empty((R, W), dtype=torch.float32, device=dev),
        m=torch.empty((R,), dtype=torch.int32, device=dev),
        ell_kk=torch.empty((R,), dtype=torch.float32, device=dev),
        e_lo=torch.empty((R, W), dtype=torch.int32, device=dev),
        e_hi=torch.empty((R, W), dtype=torch.int32, device=dev),
        e_w=torch.empty((R, W), dtype=torch.float32, device=dev),
        e_valid=torch.empty((R, W), dtype=torch.bool, device=dev))
    if R == 0:
        return out
    err = _lib().sample_clique_launch(
        ids.data_ptr(), ws.data_ptr(), fill.data_ptr(), u.data_ptr(),
        *(t.data_ptr() for t in out), R, W, runtime.stream_ptr(ids))
    runtime.check_launch(NAME, err)
    runtime.count_launch(NAME)
    return out


# ---------------------------------------------------------------------------
# the engine's elimination round
# ---------------------------------------------------------------------------

def round_gather(s, st, cand, cand_ok):
    """Gather the candidates' slabs and uniforms from the engine state
    ``s`` / statics ``st`` (``core.parac.EngineState`` / ``EngineStatic``):
    the inputs of the elimination, rows ``[B*chunk, W]``, with the slab
    slots and their validity."""
    B, chunk = cand.shape
    W = st.W
    P = s.pool_row.shape[1] - 1
    n = s.elim.shape[1] - 1
    offs = torch.arange(W, dtype=I64, device=cand.device)
    base = torch.gather(st.col_base, 1, cand)
    fill = torch.where(cand_ok, torch.gather(s.col_fill, 1, cand), 0)
    slots = base[:, :, None] + offs
    sv = offs < fill[:, :, None]
    slots_c = torch.where(sv, slots, P).reshape(B, chunk * W)
    ids = torch.where(sv, torch.gather(s.pool_row, 1, slots_c)
                      .view(B, chunk, W), INVALID_ID)
    ws = torch.where(sv, torch.gather(s.pool_val, 1, slots_c)
                     .view(B, chunk, W), 0.0)
    u = torch.gather(st.u, 1, cand.clamp(max=n - 1)[:, :, None]
                     .expand(-1, -1, W))
    return (ids.view(B * chunk, W), ws.view(B * chunk, W),
            fill.view(B * chunk).to(torch.int32), u.view(B * chunk, W),
            slots, sv)


def round_commit(s, cand, cand_ok, res: ColumnElim, slots, sv, ids) -> None:
    """Write the normalized factor columns into their slabs, ``col_fill =
    m``, ``D = ℓ_kk``, ``elim = True`` and decrement the dependency
    counters of the consumed multi-edges (in place).  Masked writes go to
    the drop entries (pool slot ``P``, column ``n``)."""
    B, chunk = cand.shape
    W = slots.shape[2]
    P = s.pool_row.shape[1] - 1
    n = s.elim.shape[1] - 1
    offs = torch.arange(W, dtype=I64, device=cand.device)
    m = res.m.view(B, chunk)
    wmask = (offs < m[:, :, None]) & cand_ok[:, :, None]
    tgt = torch.where(wmask, slots, P).view(B, chunk * W)
    s.pool_row.scatter_(1, tgt, res.g_rows.view(B, chunk * W))
    s.pool_val.scatter_(1, tgt, res.g_vals.view(B, chunk * W))
    s.col_fill.scatter_(1, cand, torch.where(
        cand_ok, m, torch.gather(s.col_fill, 1, cand)))
    s.D.scatter_(1, cand, torch.where(
        cand_ok, res.ell_kk.view(B, chunk), torch.gather(s.D, 1, cand)))
    s.elim.scatter_(1, cand, cand_ok | torch.gather(s.elim, 1, cand))
    dec = torch.where(sv, ids.view(B, chunk, W).to(I64), n).view(B, -1)
    s.dep.scatter_add_(1, dec, torch.full_like(dec, -1, dtype=torch.int32))


def eliminate_round_plain(s, st, cand, cand_ok) -> RoundEdges:
    """The plain version of :func:`eliminate_round`: gather, eliminate at
    width ``W``, commit."""
    ids, ws, fill, u, slots, sv = round_gather(s, st, cand, cand_ok)
    res = sample_clique_plain(ids, ws, fill, u)
    round_commit(s, cand, cand_ok, res, slots, sv, ids)
    return RoundEdges(res.e_lo, res.e_hi, res.e_w, res.e_valid)


def eliminate_round(s, st, cand, cand_ok) -> RoundEdges:
    """Eliminate the round's candidates ``cand`` int64 ``[B, chunk]``
    (``cand_ok`` bool, the real ones) of the engine state ``s`` in place —
    factor columns into their slabs, ``col_fill``, ``D``, ``elim``,
    ``dep`` — and return their sampled edges ``[B*chunk, W]``: one kernel
    launch on the GPU, :func:`eliminate_round_plain` on the CPU."""
    dev = s.pool_row.device
    if dev.type == "cpu":
        return eliminate_round_plain(s, st, cand, cand_ok)
    if dev.type != "cuda":
        raise ValueError(f"eliminate_round: unsupported device {dev}")
    B, chunk = cand.shape
    W = st.W
    P1 = s.pool_row.shape[1]
    n1 = s.elim.shape[1]
    runtime.require(s.pool_row, "pool_row", torch.int32, 2, dev)
    runtime.require(s.pool_val, "pool_val", torch.float32, 2, dev)
    for t, what, dt in ((s.col_fill, "col_fill", torch.int32),
                        (s.dep, "dep", torch.int32),
                        (s.elim, "elim", torch.bool),
                        (s.D, "D", torch.float32),
                        (st.col_base, "col_base", torch.int64)):
        runtime.require(t, what, dt, 2, dev)
        if t.shape != (B, n1):
            raise ValueError(f"eliminate_round: {what} must be [{B}, {n1}]")
    runtime.require(st.u, "u", torch.float32, 3, dev)
    runtime.require(cand, "cand", torch.int64, 2, dev)
    runtime.require(cand_ok, "cand_ok", torch.bool, 2, dev)
    if (s.pool_val.shape != (B, P1) or st.u.shape != (B, n1 - 1, W)
            or cand_ok.shape != (B, chunk)):
        raise ValueError("eliminate_round: pool_val must be [B, P+1], u "
                         "[B, n, W], cand_ok [B, chunk]")
    _check_width("eliminate_round", W)
    R = B * chunk
    out = RoundEdges(
        e_lo=torch.empty((R, W), dtype=torch.int32, device=dev),
        e_hi=torch.empty((R, W), dtype=torch.int32, device=dev),
        e_w=torch.empty((R, W), dtype=torch.float32, device=dev),
        e_valid=torch.empty((R, W), dtype=torch.bool, device=dev))
    if R == 0:
        return out
    err = _lib().sample_clique_round_launch(
        s.pool_row.data_ptr(), s.pool_val.data_ptr(), s.col_fill.data_ptr(),
        s.dep.data_ptr(), s.elim.data_ptr(), s.D.data_ptr(),
        st.col_base.data_ptr(), st.u.data_ptr(), cand.data_ptr(),
        cand_ok.data_ptr(), *(t.data_ptr() for t in out), P1, n1 - 1, B,
        chunk, W, runtime.stream_ptr(cand))
    runtime.check_launch(ROUND, err)
    runtime.count_launch(ROUND)
    return out
