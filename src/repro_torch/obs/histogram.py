"""Shared latency accounting: exact percentiles over raw samples and
fixed log-scale histogram buckets with quantile estimation.

This module is the one home for the percentile/summary code that used
to be re-derived privately by ``repro_torch.launch.serve.trace_metrics`` and
the bench scripts' sorted-list lambdas, and it defines the bucket
layout every :class:`repro_torch.obs.registry.Histogram` shares — so a
latency histogram scraped off the registry and a percentile printed by
a bench report agree on what they measure.

Buckets are log-scale (five per decade, ~1.58x spacing) from 10 µs to
~600 s: wide enough to cover a jit-compile-tainted cold solve and fine
enough that a windowed quantile read off bucket counts lands within one
bucket ratio of the exact value.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, Sequence

# log-scale bucket upper bounds in seconds: 5 per decade, 1e-5 .. ~6e2.
# An overflow (+Inf) bucket rides implicitly at the end of every count
# array (len(counts) == len(bounds) + 1).
DEFAULT_LATENCY_BUCKETS_S = tuple(
    round(m * 10.0 ** d, 12)
    for d in range(-5, 3)
    for m in (1.0, 1.58, 2.51, 3.98, 6.31))


def percentile(xs, q: float) -> float:
    """Exact percentile of raw samples (``q`` in [0, 100]); 0.0 on an
    empty sequence.  The one implementation behind ``trace_metrics``
    and every bench report."""
    import numpy as np
    return float(np.percentile(np.asarray(xs, float), q)) if len(xs) \
        else 0.0


def summarize(xs, *, prefix: str = "", unit: str = "s") -> Dict[str, float]:
    """p50/p95/max summary dict over raw samples, keyed
    ``{prefix}p50_{unit}`` etc. — the shape the launch reports and
    bench JSON artifacts share."""
    return {
        f"{prefix}p50_{unit}": percentile(xs, 50),
        f"{prefix}p95_{unit}": percentile(xs, 95),
        f"{prefix}max_{unit}": percentile(xs, 100),
    }


def bucket_index(bounds: Sequence[float], v: float) -> int:
    """Index of the bucket ``v`` falls in: the first bound >= v, or
    ``len(bounds)`` for the overflow bucket."""
    return bisect_left(bounds, v)


def quantile_from_counts(bounds: Sequence[float], counts: Sequence[int],
                         q: float) -> float:
    """Estimate the ``q``-quantile (``q`` in [0, 1]) from per-bucket
    counts (``len(counts) == len(bounds) + 1``; the last entry is the
    overflow bucket).  Linear interpolation inside the landing bucket;
    the overflow bucket clamps to the top bound.  0.0 when empty."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    acc = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if acc + c >= rank:
            if i >= len(bounds):          # overflow: clamp to top bound
                return float(bounds[-1])
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - acc) / c
            return float(lo + frac * (hi - lo))
        acc += c
    return float(bounds[-1])
