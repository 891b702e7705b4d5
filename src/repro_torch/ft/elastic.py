"""Elastic re-meshing: resume the same checkpoint on a different device count.
A copy of the JAX package's ``ft/elastic.py`` (plain Python and numpy):
the same plans and byte estimates.

Where every sharding is *declarative* (logical axes → rules → a named
sharding, as in the JAX package), elasticity reduces to: pick the new mesh shape,
rebuild the rules, and restore-with-shardings. The checkpoint stores full
(unsharded) arrays per host shard, so any divisible mesh works.

``remesh_plan`` chooses the closest valid (data, model) factorization for a
new chip count, preferring to shrink/grow the data axis first (keeps the
model-parallel layout — and therefore compiled kernels per layer shape —
stable across the resize).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    note: str = ""


def remesh_plan(n_devices: int, old_shape: Tuple[int, ...],
                axis_names: Tuple[str, ...] = ("data", "model"),
                model_divisors: Tuple[int, ...] = (16, 8, 4, 2, 1),
                ) -> Optional[RemeshPlan]:
    """Pick (data, model) for ``n_devices``. Keeps the old model size when it
    divides the new device count; otherwise falls back down the divisor list.
    Returns None when no factorization exists (caller should halt)."""
    old_model = old_shape[-1]
    candidates = [old_model] + [m for m in model_divisors if m != old_model]
    for m in candidates:
        if n_devices % m == 0 and n_devices // m >= 1:
            new = (n_devices // m, m)
            note = ("model axis preserved" if m == old_model
                    else f"model axis resized {old_model}->{m} (recompile)")
            return RemeshPlan(tuple(old_shape), new, tuple(axis_names), note)
    return None


def shard_transfer_bytes(param_bytes: int, old_shape: Tuple[int, int],
                         new_shape: Tuple[int, int]) -> int:
    """Estimate of resharding traffic on restore (for ops dashboards): with
    npz-restore every device reads its slice fresh, so traffic = params /
    new_device_count per device."""
    return param_bytes // int(np.prod(new_shape))
