"""Batch-shape policy of the serve path: incoming batch sizes snap to a
small ladder, so the set of batch shapes stays bounded whatever sizes
traffic brings."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

BATCH_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def bucket_size(n: int) -> int:
    """Smallest bucket >= n; beyond the ladder, the next multiple of the
    largest bucket."""
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    top = BATCH_BUCKETS[-1]
    return -(-n // top) * top


def bucket_pad(queries: np.ndarray, entry: int, device="cuda"):
    """Pad a (n, D) query batch up to its bucket. Padding lanes rerun the
    first query (their results are sliced off). Returns (queries (b, D)
    tensor, entries (b,) int64 tensor, n), both on ``device``."""
    dev = resolve_device(device)
    n = queries.shape[0]
    b = bucket_size(n)
    if b > n:
        queries = np.concatenate(
            [queries, np.repeat(queries[:1], b - n, axis=0)])
    qt = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    entries = torch.full((b,), entry, dtype=torch.int64, device=dev)
    return qt, entries, n
