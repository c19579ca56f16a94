"""The yardstick: the card's peaks, the bytes a kernel's work needs, the
percentile and the spread.  Per-layer metric readers and the drivers take
their arithmetic from here, never from the program.
"""
from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np

# NVIDIA H100 SXM data sheet, 700 W: HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
SECTOR = 32


def percentile(xs, q: float) -> float:
    """Exact percentile of raw samples (``q`` in [0, 100]); 0.0 on an
    empty sequence."""
    return float(np.percentile(np.asarray(xs, float), q)) if len(xs) else 0.0


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median
    (``statistics.quantiles``, its default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def gathered_bytes(cols: np.ndarray, lanes: int) -> int:
    """Bytes of a vector ``[n, lanes]`` (float32, row-major: the lanes of
    one entry side by side) that a sparse product must read: the distinct
    entries its slots gather, in whole 32-byte sectors (``lanes`` is 1, 2,
    4 or a multiple of 8, so no entry straddles two sectors)."""
    used = np.unique(np.asarray(cols, np.int64))
    row = 4 * lanes
    if row >= SECTOR:
        return int(used.size * -(-row // SECTOR) * SECTOR)
    return int(np.unique(used * row // SECTOR).size * SECTOR)


def round_bytes(n: int, m: int, nnz: int) -> int:
    """What one factorization of a graph needs to move: its edge list read
    once (src, dst, weight: 12 B an edge) and the final factor written
    once (rows and values of G, D, int32 column pointers)."""
    return 12 * m + 8 * nnz + 4 * n + 4 * (n + 1)


def sweep_bytes(n: int, col_ptr: np.ndarray, rows: np.ndarray,
                lanes: int) -> int:
    """What one preconditioner apply ``G⁻ᵀ D⁺ G⁻¹`` of ``lanes`` columns
    needs from its two level sweeps: each live slot of G once per sweep
    (int32 index and float32 value), the distinct entries of y each
    sweep gathers (the forward sweep gathers by column, the backward by
    row), one int32 row id per row and sweep, and y read and written once
    per sweep."""
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(col_ptr))
    nnz = int(rows.size)
    per_sweep = 8 * nnz + 4 * n + 2 * 4 * n * lanes
    return (2 * per_sweep + gathered_bytes(cols, lanes)
            + gathered_bytes(rows, lanes))


def roofline_pct(nbytes: float, device_s: float):
    """Share of the bytes bound, in percent: the least time the card
    could take (bytes over HBM bandwidth) over the device time; None
    where no device time was read."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / device_s
