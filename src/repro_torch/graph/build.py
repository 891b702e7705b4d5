"""l2 proximity-graph construction (the SL2G indexing step).

The index is query-independent (pure l2 over base vectors): exact kNN
candidates (a blocked ``torch.matmul`` plus a top-k on the device) ->
occlusion pruning to M -> symmetrize to 2M -> a padded int32 neighbor table
(N, 2M), -1 padded. NN-descent (the JAX package's kNN above
``exact_threshold``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graph.prune import occlusion_prune, symmetrize


@dataclasses.dataclass
class GraphIndex:
    neighbors: np.ndarray        # (N, M) int32, -1 padded
    entry: int                   # medoid entry point
    base: np.ndarray             # (N, D) float32 base vectors

    @property
    def n(self) -> int:
        return self.base.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def avg_degree(self) -> float:
        return float((self.neighbors >= 0).sum(1).mean())


def medoid(base: np.ndarray) -> int:
    mean = base.mean(axis=0)
    return int(np.argmin(((base - mean) ** 2).sum(axis=1)))


def brute_force_knn(base: np.ndarray, k: int, block: int = 2048,
                    queries: Optional[np.ndarray] = None,
                    device="cuda") -> np.ndarray:
    """Exact kNN by blocked distance computation on ``device``. Returns
    (Nq, k) int32 ids nearest first, self excluded when queries is None."""
    dev = resolve_device(device)
    self_mode = queries is None
    queries = base if self_mode else queries
    base_t = torch.as_tensor(np.asarray(base, np.float32), device=dev)
    base_sq = torch.sum(base_t * base_t, dim=1)
    out = np.empty((queries.shape[0], k), np.int32)
    for s in range(0, queries.shape[0], block):
        e = min(s + block, queries.shape[0])
        qb = torch.as_tensor(np.asarray(queries[s:e], np.float32),
                             device=dev)
        d = (torch.sum(qb * qb, dim=1, keepdim=True)
             - (2.0 * qb) @ base_t.T + base_sq[None, :])
        if self_mode:
            r = torch.arange(e - s, device=dev)
            d[r, r + s] = float("inf")
        idx = torch.topk(d, k, dim=1, largest=False, sorted=True).indices
        out[s:e] = idx.cpu().numpy()
    return out


def build_l2_graph(base: np.ndarray, m: int = 24, k_construction: int = 100,
                   exact_threshold: int = 60_000,
                   device="cuda") -> GraphIndex:
    """SL2G index build: l2 kNN -> occlusion prune to M -> symmetrize to
    2M. Corpora above ``exact_threshold`` need NN-descent, which is not
    ported yet; pass ``exact_threshold=N`` to build them exactly."""
    base = np.asarray(base, np.float32)
    n = base.shape[0]
    if n > exact_threshold:
        raise NotImplementedError(
            f"N={n} > exact_threshold={exact_threshold} needs nn_descent, "
            f"which is not ported yet (ROADMAP.md, queue 1); pass "
            f"exact_threshold>={n} for an exact kNN build")
    kc = min(k_construction, n - 1)
    knn = brute_force_knn(base, kc, device=device)
    # exact top-k rows are duplicate-free
    pruned = occlusion_prune(base, knn, m, assume_unique=True, device=device)
    nbrs = symmetrize(pruned, 2 * m)
    return GraphIndex(neighbors=nbrs, entry=medoid(base), base=base)
