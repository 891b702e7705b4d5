"""BEGIN-style bipartite index [Tan, Zhao, Li; VLDB'21], adapted as in
the JAX package: sample training queries, find each query's top-L items
under the measure f (exhaustively, on the device), and connect items
through shared queries, materialized as an item-item adjacency so both
the engine and GUITAR's pruning run on it unchanged:

    neighbors(i) = top items of the training queries that ranked i highly,
                   capped at m by co-rank frequency.

The co-rank counting is the JAX package's host loop, unchanged.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.measures import Measure
from repro_torch.core.search import brute_force_topk
from repro_torch.graph.build import GraphIndex, medoid


def begin_adjacency(top_ids: np.ndarray, n: int, m: int = 48,
                    seed: int = 0) -> np.ndarray:
    """The co-rank adjacency of the (T, L) top-L item ids: (n, m) int32,
    each row's items by co-rank count (first seen first among equal
    counts), isolated items backfilled with random links up to
    min(m, 4). -1 padded."""
    co: list[defaultdict] = [defaultdict(int) for _ in range(n)]
    for row in np.asarray(top_ids):
        for i in row:
            for j in row:
                if i != j:
                    co[int(i)][int(j)] += 1

    neighbors = np.full((n, m), -1, np.int32)
    rng = np.random.default_rng(seed)
    for i in range(n):
        if co[i]:
            items = sorted(co[i].items(), key=lambda kv: -kv[1])[:m]
            ids = [j for j, _ in items]
        else:
            ids = []
        # backfill isolated items with random links (keeps graph connected-ish)
        while len(ids) < min(m, 4):
            r = int(rng.integers(0, n))
            if r != i and r not in ids:
                ids.append(r)
        neighbors[i, : len(ids)] = ids
    return neighbors


def build_begin_graph(measure: Measure, base: np.ndarray,
                      train_queries: np.ndarray, m: int = 48,
                      top_l: int = 16, seed: int = 0,
                      device=DEFAULT_DEVICE) -> GraphIndex:
    """base: (N, D); train_queries: (T, Dq). O(T*N) measure evaluations
    offline (the BEGIN cost the paper notes), on ``device`` (where the
    measure's params must live)."""
    dev = resolve_device(device)
    base = np.asarray(base, np.float32)
    top_ids, _ = brute_force_topk(
        measure, torch.as_tensor(base, device=dev),
        torch.as_tensor(np.asarray(train_queries, np.float32), device=dev),
        top_l)
    neighbors = begin_adjacency(top_ids.cpu().numpy(), base.shape[0], m,
                                seed)
    return GraphIndex(neighbors=neighbors, entry=medoid(base), base=base)
