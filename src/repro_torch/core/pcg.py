"""Preconditioned conjugate gradient: the fleet solve (factor data as
tensors, lanes batched), the library PCGs over caller-supplied operator
and preconditioner closures, and a numpy host PCG for baselines.

Names against the reference (``repro.core.pcg``):

=============================  ==================================
reference                      port
=============================  ==================================
``pcg_jax``                    :func:`pcg`
``pcg_jax_batched``            :func:`pcg_batched`
``pcg_batched_init`` /         same names (the stepped API a
``_pcg_batched_body`` /        serving engine drives)
``pcg_batched_step`` /
``pcg_batched_result``
``laplacian_pcg_jax``          :func:`laplacian_pcg`
``laplacian_pcg_jax_batched``  :func:`laplacian_pcg_batched`
``laplacian_pcg_np``,          same names
``pcg_np``
``pcg_fleet_*``                same names
=============================  ==================================

All three device PCGs (fleet, single, batched) run one iteration body,
:func:`_pcg_batched_body`, and one projection, :func:`project_lanes`.
Laplacian systems are singular with nullspace span(1); the right-hand
side, the residual and the preconditioned residual are kept mean-zero on
each lane's true vertices.  The reference projects only the first and the
last, and its float32 residual stalls near 1e-6 on large grids: this is
the port's one deliberate departure (ROADMAP Queue 3).

Determinism: the Laplacian matvec sums each vertex's incident-edge terms
in a fixed order (ELL adjacency rows), not by a float scatter-add, whose
CUDA atomics would make results vary run to run and depend on the batch;
and every per-lane reduction (dot products, norms, means) reduces one
lane's row alone (:func:`_lane_rows`), so on the card too a lane takes
the same iterates whichever lanes share its batch.
Host syncs: one per iteration (``any(active)``), plus the preconditioner's
own (the fleet's level sweeps read their level bound once per triangular
solve; the per-level launch grids come from row counts kept on the host).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels import ops
from ..obs.tracing import span
from .laplacian import Graph, laplacian_adjacency, laplacian_matvec_np


class PCGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor
    relres: torch.Tensor
    converged: torch.Tensor


class PCGBatchState(NamedTuple):
    """Carry of the batched PCG loop, exposed so a serving engine can drive
    solves incrementally (``pcg_batched_init`` then ``pcg_batched_step``).
    Lanes are independent (frozen-lane masking): a lane's trajectory does
    not depend on which lanes share the batch or on how the iterations
    are sliced into steps."""

    X: torch.Tensor        # (nrhs, n) iterate
    R: torch.Tensor        # (nrhs, n) residual
    Z: torch.Tensor        # (nrhs, n) preconditioned residual
    P: torch.Tensor        # (nrhs, n) search direction
    rz: torch.Tensor       # (nrhs,)
    it: torch.Tensor       # int32 (nrhs,)
    active: torch.Tensor   # bool (nrhs,)
    bnorm: torch.Tensor    # (nrhs,) — rhs norms (1.0 for a zero rhs)


class FleetArrays(NamedTuple):
    """Stacked, bucket-padded factors — the factor argument of the fleet
    PCG.  Row ``f`` holds one factor's Laplacian adjacency rows, row-indexed
    forward/backward trisolve panels with their level row lists, inverse
    diagonal and true sizes; a lane reads its factor's rows through
    ``fidx``, so the stack is never copied per apply.  Level ``lv``'s rows
    of factor ``f`` are ``frows[f, fstart[f, lv]:fstart[f, lv + 1]]``
    (``fstart`` is ``n_pad`` past the factor's last level)."""

    lnbr: torch.Tensor    # int32[F, n_pad, Kl] — incident edges' far ends
    lw: torch.Tensor      # f32[F, n_pad, Kl]   — their weights (0: padding)
    fcols: torch.Tensor   # int32[F, n_pad, Kf] — fwd panels, row-indexed
    fvals: torch.Tensor   # f32[F, n_pad, Kf]
    flen: torch.Tensor    # int32[F, n_pad] — live slots per fwd row
    frows: torch.Tensor   # int32[F, n_pad] — rows sorted stably by level
    fstart: torch.Tensor  # int32[F, f_levels + 1] — level offsets in frows
    bcols: torch.Tensor   # int32[F, n_pad, Kb] — bwd panels (unflipped)
    bvals: torch.Tensor   # f32[F, n_pad, Kb]
    blen: torch.Tensor    # int32[F, n_pad]
    brows: torch.Tensor   # int32[F, n_pad]
    bstart: torch.Tensor  # int32[F, b_levels + 1]
    dinv: torch.Tensor    # f32[F, n_pad] — 1/D (0 where D <= 0 / phantom)
    nvalid: torch.Tensor  # int32[F] — true vertex count per factor
    fnlv: torch.Tensor    # int32[F] — true fwd level count per factor
    bnlv: torch.Tensor    # int32[F] — true bwd level count per factor


class FleetPCGState(NamedTuple):
    """Carry of the fleet PCG loop: :class:`PCGBatchState`'s fields, then
    the per-lane routing/termination scalars."""

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
    return adjacency_matvec(fa.lnbr[f], fa.lw[f], Y)


def adjacency_matvec(nbr: torch.Tensor, w: torch.Tensor,
                     X: torch.Tensor) -> torch.Tensor:
    """Laplacian matvec over the last axis of ``X`` from adjacency rows
    (``core.laplacian.laplacian_adjacency``):
    ``Σ_k w[..., k]·(X − X[nbr[..., k]])`` left to right — the edge-list
    scatter-add's terms in its order, elementwise only, so deterministic
    on CUDA and the same for a row alone or in a block.  ``nbr``/``w`` are
    ``(n, K)``, shared by every row of ``X`` (``(n,)`` or ``(nrhs, n)``),
    or ``(L, n, K)``, one table per row of ``X`` ``(L, n)``."""
    out = torch.zeros_like(X)
    for k in range(nbr.shape[-1]):
        far = torch.gather(X, -1, nbr[..., k].long().expand_as(X))
        out = out + w[..., k] * (X - far)
    return out


def fleet_precondition(fa: FleetArrays, fidx: torch.Tensor, R: torch.Tensor,
                       *, f_plan: np.ndarray, b_plan: np.ndarray,
                       kind: str = "factor") -> torch.Tensor:
    """Per-lane preconditioner apply, dispatched on the fleet's apply
    ``kind``:

    * ``"factor"`` — ``(G D Gᵀ)⁺``: forward level sweeps → D⁻¹ scale →
      backward level sweeps, each lane reading its own factor's panels
      and level rows from the stack.  ``f_plan``/``b_plan`` are the
      bucket's host sweep plans (``FactorFleet.plans``: per level its row
      count bound and longest live row), so an apply reads nothing from
      the device; each triangular solve is one C call.  The working
      vector is interleaved (``ops.interleaved``) from the first sweep to
      the second and swept in place: one copy in and one out.  The randomized AC and the
      incomplete-Cholesky families.
    * ``"spmv"`` — ``M r``: one full-row ``ell_spmv_fleet`` launch over
      the materialized approximate inverse in the forward-panel slots
      (``fcols``/``fvals``, each row's live slots ``flen``); the backward
      panels and ``dinv`` are inert.  The SPAI and flattened-AMG
      families."""
    with span("pcg.precondition"):
        if kind == "spmv":
            return ops.ell_spmv_fleet(fa.fcols, fa.fvals, fidx, R,
                                      lens=fa.flen)
        if kind != "factor":
            raise ValueError(f"unknown preconditioner apply kind: {kind!r}")
        Y = ops.trisolve_fleet_(fa.fcols, fa.fvals, fa.flen, fa.frows,
                                fa.fstart, fidx, ops.interleaved(R),
                                plan=f_plan)
        Y.mul_(fa.dinv[fidx.long()])
        ops.trisolve_fleet_(fa.bcols, fa.bvals, fa.blen, fa.brows, fa.bstart,
                            fidx, Y, plan=b_plan)
        return Y.contiguous()


def project_lanes(Y: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """Mean-zero projection of each lane (row of ``Y``) over its first
    ``nvalid[l]`` entries; entries past them are forced to exactly 0.

    The one projection of all three PCGs of the port (fleet, single,
    batched): each applies it to the rhs, to the residual every iteration
    and to the preconditioned residual.  The reference projects the rhs
    and Z only; rounding then leaves a mean component in R that CG cannot
    reduce and the singular preconditioner (D has a zero) amplifies, and
    float32 PCG stalls near relres 1e-6 on 10^4-vertex grids."""
    nv = torch.clamp(nvalid, min=1).to(Y.dtype)
    mean = _lane_sum(Y) / nv
    vmask = torch.arange(Y.shape[1], device=Y.device)[None, :] \
        < nvalid[:, None]
    return torch.where(vmask, Y - mean[:, None], 0.0)


def _whole_rows(B: torch.Tensor) -> torch.Tensor:
    """``nvalid`` of lanes without padding: every entry is a vertex."""
    return torch.full((B.shape[0],), B.shape[1], dtype=torch.int32,
                      device=B.device)


def _lane_rows(Y: torch.Tensor):
    """Each lane's row of ``Y`` in fresh memory.  A batched row reduction
    on CUDA picks its summation order by the number of rows and by each
    row's alignment, so a lane's sum would depend on the lanes beside it;
    a row reduced alone, from an allocation of its own, is summed in an
    order that depends on n alone."""
    return [row.clone() for row in Y]


def _lane_sum(Y: torch.Tensor) -> torch.Tensor:
    return torch.stack([row.sum() for row in _lane_rows(Y)])


def _norm(Y: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(row)
                        for row in _lane_rows(Y)])


def pcg_batched_init(matvec: Callable, precond: Callable, B: torch.Tensor, *,
                     tol=1e-6, project: bool = True,
                     nvalid=None) -> PCGBatchState:
    """Set up the batched PCG carry for ``B`` of shape ``(nrhs, n)``.
    ``tol`` may be a scalar or a per-lane ``(nrhs,)`` tensor; ``nvalid``
    (default: whole rows) bounds each lane's true vertices."""
    if nvalid is None:
        nvalid = _whole_rows(B)
    if project:
        B = project_lanes(B, nvalid)
    bnorm = _norm(B)
    bnorm = torch.where(bnorm > 0, bnorm, 1.0)
    Z0 = precond(B).contiguous()
    if project:
        Z0 = project_lanes(Z0, nvalid)
    L = B.shape[0]
    return PCGBatchState(
        X=torch.zeros_like(B), R=B, Z=Z0, P=Z0, rz=_lane_sum(B * Z0),
        it=torch.zeros(L, dtype=torch.int32, device=B.device),
        active=(_norm(B) / bnorm) > tol, bnorm=bnorm)


def _pcg_batched_body(matvec: Callable, precond: Callable, *, tol, maxiter,
                      project: bool, nvalid: torch.Tensor):
    """One frozen-lane PCG iteration as a ``state -> state`` closure, for
    :class:`PCGBatchState` and :class:`FleetPCGState` alike.  A lane's
    update reads only its own row, so trajectories do not depend on batch
    composition or on how iterations are sliced into steps.  ``tol``/
    ``maxiter`` may be scalars or per-lane tensors.  The operator's and
    the preconditioner's outputs are made row-major (a transposed block
    would change the order of every row reduction)."""
    def body(s):
        AP = matvec(s.P).contiguous()
        pAp = _lane_sum(s.P * AP)
        alpha = torch.where(s.active,
                            s.rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
        Xn = s.X + alpha[:, None] * s.P
        Rn = s.R - alpha[:, None] * AP
        if project:
            Rn = project_lanes(Rn, nvalid)
        Zn = precond(Rn).contiguous()
        if project:
            Zn = project_lanes(Zn, nvalid)
        rz_new = _lane_sum(Rn * Zn)
        beta = torch.where(s.active,
                           rz_new / torch.where(s.rz != 0, s.rz, 1.0), 0.0)
        Pn = Zn + beta[:, None] * s.P
        m = s.active[:, None]
        R = torch.where(m, Rn, s.R)
        it = s.it + s.active.to(torch.int32)
        relres = _norm(R) / s.bnorm
        return s._replace(
            X=torch.where(m, Xn, s.X), R=R, Z=torch.where(m, Zn, s.Z),
            P=torch.where(m, Pn, s.P),
            rz=torch.where(s.active, rz_new, s.rz), it=it,
            active=s.active & (relres > tol) & (it < maxiter))

    return body


def pcg_batched_step(matvec: Callable, precond: Callable,
                     state: PCGBatchState, *, k: int, tol, maxiter,
                     project: bool = True) -> PCGBatchState:
    """Advance every active lane by up to ``k`` iterations (early exit
    when all lanes freeze).  Step slicing is exact."""
    body = _pcg_batched_body(matvec, precond, tol=tol, maxiter=maxiter,
                             project=project, nvalid=_whole_rows(state.X))
    for _ in range(k):
        if not bool(state.active.any()):
            break
        state = body(state)
    return state


def pcg_batched_result(state: PCGBatchState, tol) -> PCGResult:
    """Read a ``PCGResult`` off the current carry."""
    relres = _norm(state.R) / state.bnorm
    return PCGResult(x=state.X, iters=state.it, relres=relres,
                     converged=relres <= tol)


def pcg_batched(matvec: Callable, precond: Callable, B: torch.Tensor, *,
                tol: float = 1e-6, maxiter: int = 1000,
                project: bool = True) -> PCGResult:
    """Batched multi-rhs PCG: every row of ``B`` ``(nrhs, n)`` is a lane
    against the same operator and preconditioner, which take and return
    ``(nrhs, n)`` blocks.  Converged lanes freeze, so each takes exactly
    the iterates of its own single-rhs solve.  One host read of
    ``any(active)`` per iteration."""
    state = pcg_batched_init(matvec, precond, B, tol=tol, project=project)
    body = _pcg_batched_body(matvec, precond, tol=tol, maxiter=maxiter,
                             project=project, nvalid=_whole_rows(B))
    while bool(state.active.any()):
        state = body(state)
    return pcg_batched_result(state, tol)


def pcg(matvec: Callable, precond: Callable, b: torch.Tensor, *,
        tol: float = 1e-6, maxiter: int = 1000,
        project: bool = True) -> PCGResult:
    """Standard PCG for one rhs ``(n,)``: the batched PCG with one lane,
    so a lane of :func:`pcg_batched` takes this solve's iterates."""
    res = pcg_batched(lambda P: matvec(P[0])[None],
                      lambda R: precond(R[0])[None], b[None], tol=tol,
                      maxiter=maxiter, project=project)
    return PCGResult(x=res.x[0], iters=res.iters[0], relres=res.relres[0],
                     converged=res.converged[0])


def pcg_fleet_init(fa: FleetArrays, fidx, B, tol, maxiter, *,
                   f_plan: np.ndarray, b_plan: np.ndarray,
                   kind: str = "factor",
                   project: bool = True) -> FleetPCGState:
    """Set up the fleet PCG carry for columns ``B`` ``(L, n_pad)`` (zero
    past each factor's true n); lane ``l`` solves against factor
    ``fidx[l]`` with its own ``tol``/``maxiter``."""
    with span("pcg.init"):
        dev = B.device
        fidx = torch.as_tensor(fidx, dtype=torch.int32, device=dev)
        L = B.shape[0]
        tol = torch.as_tensor(tol, dtype=torch.float32, device=dev).expand(L)
        base = pcg_batched_init(
            partial(fleet_matvec, fa, fidx),
            partial(fleet_precondition, fa, fidx, f_plan=f_plan,
                    b_plan=b_plan, kind=kind),
            B, tol=tol, project=project, nvalid=fa.nvalid[fidx.long()])
        return FleetPCGState(
            *base, fidx=fidx, tol=tol.contiguous(),
            maxiter=torch.as_tensor(maxiter, dtype=torch.int32,
                                    device=dev).expand(L).contiguous())


def pcg_fleet_body(fa: FleetArrays, s: FleetPCGState, *,
                   f_plan: np.ndarray, b_plan: np.ndarray,
                   kind: str = "factor",
                   project: bool = True) -> FleetPCGState:
    """One frozen-lane fleet PCG iteration: lane ``l`` multiplies by and
    preconditions with factor ``fidx[l]`` of the stack."""
    with span("pcg.iter"):
        return _pcg_batched_body(
            partial(fleet_matvec, fa, s.fidx),
            partial(fleet_precondition, fa, s.fidx, f_plan=f_plan,
                    b_plan=b_plan, kind=kind),
            tol=s.tol, maxiter=s.maxiter, project=project,
            nvalid=fa.nvalid[s.fidx.long()])(s)


def pcg_fleet_step(fa: FleetArrays, state: FleetPCGState, *, k: int,
                   f_plan: np.ndarray, b_plan: np.ndarray,
                   kind: str = "factor",
                   project: bool = True) -> FleetPCGState:
    """Advance every active lane by up to ``k`` iterations (early exit
    when all lanes freeze).  Step slicing is exact."""
    for _ in range(k):
        with span("pcg.check"):
            active = bool(state.active.any())
        if not active:
            break
        state = pcg_fleet_body(fa, state, f_plan=f_plan,
                               b_plan=b_plan, kind=kind, project=project)
    return state


def pcg_fleet_solve(fa: FleetArrays, fidx, B, tol, maxiter, *,
                    f_plan: np.ndarray, b_plan: np.ndarray,
                    kind: str = "factor",
                    project: bool = True) -> FleetPCGState:
    """One-shot fleet solve: init then iterate until every lane freezes
    (one host read of ``any(active)`` per iteration)."""
    state = pcg_fleet_init(fa, fidx, B, tol, maxiter, f_plan=f_plan,
                           b_plan=b_plan, kind=kind, project=project)
    while True:
        with span("pcg.check"):
            active = bool(state.active.any())
        if not active:
            return state
        state = pcg_fleet_body(fa, state, f_plan=f_plan,
                               b_plan=b_plan, kind=kind, project=project)


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


def _laplacian_operator(g: Graph, like: torch.Tensor) -> Callable:
    nbr, w = laplacian_adjacency(g, dtype=np.float64)
    return partial(adjacency_matvec,
                   torch.as_tensor(nbr, device=like.device).long(),
                   torch.as_tensor(w, device=like.device).to(like.dtype))


def laplacian_pcg(g: Graph, precond: Callable, b: torch.Tensor,
                  **kw) -> PCGResult:
    """PCG on ``L(g) x = b`` (``b`` ``(n,)``), on ``b``'s device."""
    return pcg(_laplacian_operator(g, b), precond, b, **kw)


def laplacian_pcg_batched(g: Graph, precond: Callable, B: torch.Tensor,
                          **kw) -> PCGResult:
    """Batched Laplacian PCG for ``B`` ``(nrhs, n)``; ``precond`` takes an
    ``(nrhs, n)`` block (for a ``make_preconditioner`` apply, whose
    multi-rhs layout is ``(n, nrhs)``: ``lambda R: apply(R.T).T``)."""
    return pcg_batched(_laplacian_operator(g, B), precond, B, **kw)


def laplacian_pcg_np(g: Graph, precond: Callable, b: np.ndarray,
                     **kw) -> PCGResult:
    return pcg_np(lambda x: laplacian_matvec_np(g, x), precond, b, **kw)
