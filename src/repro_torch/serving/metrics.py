"""Serving latency accounting (plain numpy on host timestamps)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def percentile(xs, q: float) -> float:
    """float(np.percentile) with an empty-input guard (nan, not a crash)."""
    if len(xs) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), q))


def latency_summary(lat_ms) -> Dict[str, float]:
    """p50/p95/p99 over a latency sample (ms)."""
    return {"p50_ms": percentile(lat_ms, 50),
            "p95_ms": percentile(lat_ms, 95),
            "p99_ms": percentile(lat_ms, 99)}
