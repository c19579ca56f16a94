"""Preconditioned conjugate gradient: the fleet solve (factor data as
tensors, lanes batched) and a numpy host PCG for baselines.

Laplacian systems are singular with nullspace span(1); the right-hand
side, the residual and the preconditioned residual are kept mean-zero on
each lane's true vertices (the reference projects only the first and the
last, and its float32 residual stalls near 1e-6 on large grids).

Determinism: the Laplacian matvec sums each vertex's incident-edge terms
in a fixed order (ELL adjacency rows), not by a float scatter-add, whose
CUDA atomics would make results vary run to run and depend on the batch.
Host syncs: one per iteration (``any(active)``) and one per triangular
solve (its level bound).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels.ops import trisolve_fleet


class PCGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor
    relres: torch.Tensor
    converged: torch.Tensor


class FleetArrays(NamedTuple):
    """Stacked, bucket-padded factors — the factor argument of the fleet
    PCG.  Row ``f`` holds one factor's Laplacian adjacency rows, row-indexed
    forward/backward trisolve panels, inverse diagonal and true sizes; a
    lane reads its factor's rows through ``fidx``, so the stack is never
    copied per apply."""

    lnbr: torch.Tensor    # int32[F, n_pad, Kl] — incident edges' far ends
    lw: torch.Tensor      # f32[F, n_pad, Kl]   — their weights (0: padding)
    fcols: torch.Tensor   # int32[F, n_pad, Kf] — fwd panels, row-indexed
    fvals: torch.Tensor   # f32[F, n_pad, Kf]
    flevel: torch.Tensor  # int32[F, n_pad]
    bcols: torch.Tensor   # int32[F, n_pad, Kb] — bwd panels (unflipped)
    bvals: torch.Tensor   # f32[F, n_pad, Kb]
    blevel: torch.Tensor  # int32[F, n_pad]
    dinv: torch.Tensor    # f32[F, n_pad] — 1/D (0 where D <= 0 / phantom)
    nvalid: torch.Tensor  # int32[F] — true vertex count per factor
    fnlv: torch.Tensor    # int32[F] — true fwd level count per factor
    bnlv: torch.Tensor    # int32[F] — true bwd level count per factor


class FleetPCGState(NamedTuple):
    """Carry of the fleet PCG loop: per-lane iterate block plus the
    per-lane routing/termination scalars."""

    X: torch.Tensor        # (L, n_pad)
    R: torch.Tensor        # (L, n_pad)
    Z: torch.Tensor        # (L, n_pad)
    P: torch.Tensor        # (L, n_pad)
    rz: torch.Tensor       # (L,)
    it: torch.Tensor       # int32 (L,)
    active: torch.Tensor   # bool (L,)
    bnorm: torch.Tensor    # (L,)
    fidx: torch.Tensor     # int32 (L,) — lane's factor row in the fleet
    tol: torch.Tensor      # f32 (L,)
    maxiter: torch.Tensor  # int32 (L,)


def fleet_matvec(fa: FleetArrays, fidx: torch.Tensor,
                 Y: torch.Tensor) -> torch.Tensor:
    """Per-lane Laplacian matvec: lane ``l`` multiplies by the operator of
    factor ``fidx[l]``: ``(L y)_i = Σ_k w[i,k]·(y_i − y[nbr[i,k]])``,
    summed left to right over the vertex's incident edges (the
    edge-list scatter-add's terms in its order; elementwise only, so the
    result is deterministic and a lane's does not depend on the batch)."""
    f = fidx.long()
    nbr, w = fa.lnbr[f], fa.lw[f]
    out = torch.zeros_like(Y)
    for k in range(nbr.shape[2]):
        out = out + w[:, :, k] * (Y - torch.gather(Y, 1, nbr[:, :, k].long()))
    return out


def fleet_precondition(fa: FleetArrays, fidx: torch.Tensor, R: torch.Tensor,
                       *, f_levels: int, b_levels: int, kind: str = "factor",
                       active=None) -> torch.Tensor:
    """Per-lane ``(G D Gᵀ)⁺`` apply: forward masked trisolve → D⁻¹ scale →
    backward masked trisolve, each lane reading its own factor's panels
    from the stack.  ``f_levels``/``b_levels`` are the bucket-wide
    ceilings; the trip count of each solve is the live batch's maximum
    true level count (``active`` masks frozen lanes out of that bound —
    their output is discarded by the caller)."""
    if kind != "factor":
        raise ValueError(f"unknown preconditioner apply kind: {kind!r}")
    f = fidx.long()
    flv, blv = fa.fnlv[f], fa.bnlv[f]
    if active is not None:
        flv = torch.where(active, flv, 1)
        blv = torch.where(active, blv, 1)
    Y = trisolve_fleet(fa.fcols, fa.fvals, fidx, fa.flevel[f], R,
                       n_levels=f_levels, lane_levels=flv)
    Z = Y * fa.dinv[f]
    return trisolve_fleet(fa.bcols, fa.bvals, fidx, fa.blevel[f], Z,
                          n_levels=b_levels, lane_levels=blv)


def _fleet_project(Y: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """Mean-zero projection restricted to each lane's true vertices;
    padding entries forced to exactly 0."""
    nv = torch.clamp(nvalid, min=1).to(Y.dtype)
    mean = torch.sum(Y, dim=1) / nv
    vmask = torch.arange(Y.shape[1], device=Y.device)[None, :] \
        < nvalid[:, None]
    return torch.where(vmask, Y - mean[:, None], 0.0)


def _norm(Y: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(Y, dim=1)


def pcg_fleet_init(fa: FleetArrays, fidx, B, tol, maxiter, *, f_levels: int,
                   b_levels: int, kind: str = "factor",
                   project: bool = True) -> FleetPCGState:
    """Set up the fleet PCG carry for columns ``B`` ``(L, n_pad)`` (zero
    past each factor's true n); lane ``l`` solves against factor
    ``fidx[l]`` with its own ``tol``/``maxiter``."""
    dev = B.device
    fidx = torch.as_tensor(fidx, dtype=torch.int32, device=dev)
    L = B.shape[0]
    nvalid = fa.nvalid[fidx.long()]
    if project:
        B = _fleet_project(B, nvalid)
    bnorm = _norm(B)
    bnorm = torch.where(bnorm > 0, bnorm, 1.0)
    Z0 = fleet_precondition(fa, fidx, B, f_levels=f_levels,
                            b_levels=b_levels, kind=kind)
    if project:
        Z0 = _fleet_project(Z0, nvalid)
    tol = torch.as_tensor(tol, dtype=torch.float32, device=dev).expand(L)
    return FleetPCGState(
        X=torch.zeros_like(B), R=B, Z=Z0, P=Z0, rz=torch.sum(B * Z0, dim=1),
        it=torch.zeros(L, dtype=torch.int32, device=dev),
        active=(_norm(B) / bnorm) > tol, bnorm=bnorm, fidx=fidx,
        tol=tol.contiguous(),
        maxiter=torch.as_tensor(maxiter, dtype=torch.int32,
                                device=dev).expand(L).contiguous())


def pcg_fleet_body(fa: FleetArrays, s: FleetPCGState, *, f_levels: int,
                   b_levels: int, kind: str = "factor",
                   project: bool = True) -> FleetPCGState:
    """One frozen-lane fleet PCG iteration.  A lane's update reads only its
    own row and its own factor, so trajectories do not depend on batch
    composition or on how iterations are sliced into steps."""
    nvalid = fa.nvalid[s.fidx.long()]
    AP = fleet_matvec(fa, s.fidx, s.P)
    pAp = torch.sum(s.P * AP, dim=1)
    alpha = torch.where(s.active, s.rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
    Xn = s.X + alpha[:, None] * s.P
    Rn = s.R - alpha[:, None] * AP
    if project:
        # keep the recursive residual in range(L): rounding leaves a small
        # mean component in R that CG cannot reduce, and the singular
        # preconditioner amplifies it; without this, float32 PCG stalls
        # (rz turns negative) once relres nears ~1e-6 on 10^4-vertex grids
        Rn = _fleet_project(Rn, nvalid)
    Zn = fleet_precondition(fa, s.fidx, Rn, f_levels=f_levels,
                            b_levels=b_levels, kind=kind, active=s.active)
    if project:
        Zn = _fleet_project(Zn, nvalid)
    rz_new = torch.sum(Rn * Zn, dim=1)
    beta = torch.where(s.active, rz_new / torch.where(s.rz != 0, s.rz, 1.0),
                       0.0)
    Pn = Zn + beta[:, None] * s.P
    m = s.active[:, None]
    X = torch.where(m, Xn, s.X)
    R = torch.where(m, Rn, s.R)
    it = s.it + s.active.to(torch.int32)
    relres = _norm(R) / s.bnorm
    return FleetPCGState(
        X=X, R=R, Z=torch.where(m, Zn, s.Z), P=torch.where(m, Pn, s.P),
        rz=torch.where(s.active, rz_new, s.rz), it=it,
        active=s.active & (relres > s.tol) & (it < s.maxiter),
        bnorm=s.bnorm, fidx=s.fidx, tol=s.tol, maxiter=s.maxiter)


def pcg_fleet_step(fa: FleetArrays, state: FleetPCGState, *, k: int,
                   f_levels: int, b_levels: int, kind: str = "factor",
                   project: bool = True) -> FleetPCGState:
    """Advance every active lane by up to ``k`` iterations (early exit
    when all lanes freeze).  Step slicing is exact."""
    for _ in range(k):
        if not bool(state.active.any()):
            break
        state = pcg_fleet_body(fa, state, f_levels=f_levels,
                               b_levels=b_levels, kind=kind, project=project)
    return state


def pcg_fleet_solve(fa: FleetArrays, fidx, B, tol, maxiter, *,
                    f_levels: int, b_levels: int, kind: str = "factor",
                    project: bool = True) -> FleetPCGState:
    """One-shot fleet solve: init then iterate until every lane freezes
    (one host read of ``any(active)`` per iteration)."""
    state = pcg_fleet_init(fa, fidx, B, tol, maxiter, f_levels=f_levels,
                           b_levels=b_levels, kind=kind, project=project)
    while bool(state.active.any()):
        state = pcg_fleet_body(fa, state, f_levels=f_levels,
                               b_levels=b_levels, kind=kind, project=project)
    return state


def pcg_fleet_result(state: FleetPCGState, n: int) -> PCGResult:
    """Read a ``PCGResult`` off the fleet carry, sliced to true size."""
    relres = _norm(state.R) / state.bnorm
    return PCGResult(x=state.X[:, :n], iters=state.it, relres=relres,
                     converged=relres <= state.tol)


def pcg_np(matvec: Callable, precond: Callable, b: np.ndarray, *,
           tol: float = 1e-6, maxiter: int = 1000,
           project: bool = True) -> PCGResult:
    """Host PCG (float64) for baselines and tests."""
    b = np.asarray(b, np.float64)
    if project:
        b = b - b.mean()
    bnorm = np.linalg.norm(b) or 1.0
    x = np.zeros_like(b)
    r = b.copy()
    z = np.asarray(precond(r), np.float64)
    if project:
        z = z - z.mean()
    p = z.copy()
    rz = float(r @ z)
    it = 0
    relres = np.linalg.norm(r) / bnorm
    while relres > tol and it < maxiter:
        Ap = np.asarray(matvec(p), np.float64)
        alpha = rz / float(p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        z = np.asarray(precond(r), np.float64)
        if project:
            z = z - z.mean()
        rz_new = float(r @ z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        it += 1
        relres = np.linalg.norm(r) / bnorm
    return PCGResult(x=x, iters=np.int32(it), relres=np.float64(relres),
                     converged=relres <= tol)
