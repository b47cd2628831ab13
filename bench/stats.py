"""Percentiles over every sample, and the spread the bounds are set from."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all `values` (q in (0, 100]):
    the smallest value with at least q% of the samples at or below it.
    A missing sample is `math.inf`, so a percentile that reaches one is
    inf. Raises ValueError on no samples."""
    if not values:
        raise ValueError("percentile of no samples")
    ranked = sorted(values)
    return ranked[max(math.ceil(q / 100.0 * len(ranked)), 1) - 1]


def spread(values) -> float:
    """(third quartile - first quartile) / median, with Python's
    `statistics.quantiles(values, n=4)`."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
