"""Carry-across from the reference package: a factor built by the JAX
package arrives as numpy arrays and becomes the port's ``ACFactor``, which
``Solver.attach`` / ``FactorCache.attach`` then serve.  Nothing here
imports the reference package; the caller hands over plain arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .ref_ac import ACFactor


def key_from_jax(key_data) -> np.ndarray:
    """The port's key from ``jax.random.key_data(key)`` (a uint32[2])."""
    k = np.asarray(key_data)
    if k.shape != (2,):
        raise ValueError(f"expected a raw threefry key of shape (2,), got "
                         f"{k.shape}")
    return k.astype(np.uint32)


def factor_from_numpy(col_ptr, rows, vals, D, *,
                      stats: Optional[dict] = None,
                      perm: Optional[np.ndarray] = None) -> ACFactor:
    """An ``ACFactor`` from CSC arrays (``col_ptr`` int[n+1], ``rows``
    int[nnz], ``vals`` f32[nnz], ``D`` f32[n]) — e.g. the fields of a
    reference-package factor passed through ``numpy.asarray``."""
    col_ptr = np.asarray(col_ptr).astype(np.int64)
    rows = np.asarray(rows).astype(np.int32)
    vals = np.asarray(vals).astype(np.float32)
    D = np.asarray(D).astype(np.float32)
    n = D.shape[0]
    if col_ptr.shape != (n + 1,) or rows.shape != vals.shape \
            or int(col_ptr[-1]) != rows.shape[0]:
        raise ValueError("inconsistent CSC arrays: need col_ptr[n+1], "
                         "rows/vals[col_ptr[-1]], D[n]")
    return ACFactor(n=n, col_ptr=col_ptr, rows=rows, vals=vals, D=D,
                    perm=perm, stats=dict(stats or {}))
