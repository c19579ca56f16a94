"""Public wrappers around the kernels: width padding for the elimination
kernel and the level-masked triangular solve built on the fleet SpMV.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.column_math import INVALID_ID, ColumnElim
from . import sample_clique as _sc
from . import spmv as _spmv


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def sample_clique(ids, ws, fill, u) -> ColumnElim:
    """Batched vertex elimination.  ids/ws/u: ``[R, W]``; fill: ``[R]``.
    Pads W to a power of two (≥ 2) with ``INVALID_ID``/``0``/``u=0.5``
    and returns rows of the padded width (the math is padding-width
    independent)."""
    R, W = ids.shape
    W2 = max(_next_pow2(W), 2)
    if W2 != W:
        pad = (0, W2 - W)
        ids = torch.nn.functional.pad(ids, pad, value=INVALID_ID)
        ws = torch.nn.functional.pad(ws, pad)
        u = torch.nn.functional.pad(u, pad, value=0.5)
    return _sc.sample_clique(ids.contiguous(), ws.contiguous(),
                             fill.to(torch.int32).contiguous(),
                             u.contiguous())


def ell_spmv_fleet(cols, vals, fidx, x) -> torch.Tensor:
    """Lane-batched ELL SpMV ``[L, R]``: lane ``l`` multiplies ``x[l]`` by
    the panel ``fidx[l]`` of the fleet stack ``cols``/``vals``
    ``[F, R, K]`` (a per-lane stack passes ``fidx = arange(L)``)."""
    return _spmv.ell_spmv_fleet(cols, vals, fidx.to(torch.int32), x)


def trisolve_fleet(cols, vals, fidx, level_of, y, *, n_levels: int,
                   lane_levels: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Lane-batched level-masked unit-triangular solve.  Each level runs
    the full-row fleet SpMV and commits the rows at that level:
    ``y = where(level_of == lv, y - A y, y)`` for ``lv = 1 .. bound-1``.

    ``cols``/``vals`` are a fleet stack ``[F, n, K]`` read through
    ``fidx`` ``[L]``; ``level_of`` is ``[L, n]``.
    ``n_levels`` is the static ceiling; ``lane_levels`` ``[L]`` (each
    lane's true level count) lowers the bound to the batch's live maximum
    — one host read per solve.  A level past a lane's depth selects none
    of its rows, so the bound never changes a result."""
    bound = n_levels
    if lane_levels is not None:
        bound = min(int(lane_levels.max()), n_levels)
    for lv in range(1, bound):
        contrib = ell_spmv_fleet(cols, vals, fidx, y)
        y = torch.where(level_of == lv, y - contrib, y)
    return y
