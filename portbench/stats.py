"""Percentile arithmetic, copied from the program's
``serving/metrics.py`` so that a change there cannot move the yardstick:
``numpy.percentile`` with linear interpolation. A request that never came
back counts as infinitely late."""
from __future__ import annotations

import numpy as np


def percentile(xs, q: float) -> float:
    """float(np.percentile) with an empty-input guard (nan, not a crash);
    inf where the percentile reaches a missing request."""
    if len(xs) == 0:
        return float("nan")
    xs = np.sort(np.asarray(xs, np.float64))
    rank = q / 100.0 * (len(xs) - 1)
    hi = int(np.ceil(rank))
    if not np.isfinite(xs[hi]):
        return float("inf")
    return float(np.percentile(xs, q))
