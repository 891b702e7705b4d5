"""Small integer and array helpers of the JAX package's ``utils.py`` that
the port needs (its tree helpers are in ``tree.py``; ``shard_map_compat``
and ``key_iter`` are JAX's own and have no counterpart here)."""
from __future__ import annotations

import numpy as np


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(n: int, m: int) -> int:
    """Smallest multiple of m >= n (sharding-divisibility padding)."""
    return ((n + m - 1) // m) * m


def pad_to(x: np.ndarray, size: int, axis: int = 0, fill=0) -> np.ndarray:
    """Pad `x` along `axis` up to `size` with `fill`."""
    if x.shape[axis] >= size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, size - x.shape[axis])
    return np.pad(x, widths, constant_values=fill)
