"""Paper-faithful reference searcher (numpy, per-query, dynamic sets).

Implements Algorithm 1 exactly as written: a real priority queue, truly
*dynamic* probable-candidate sets per Eq. (3)/(4) (no static budget), and the
paper's #NN / #Grad accounting (Total = #NN + 2·#Grad). This is the oracle
the batched searcher and BEGIN are held against, and the engine behind the
Table-2 reproduction. Numpy only: the port's own copy of the JAX package's
``core/faithful.py``, the same code.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, List, Tuple

import numpy as np


@dataclasses.dataclass
class FaithfulStats:
    n_eval: int = 0      # NN measure evaluations (#NN)
    n_grad: int = 0      # gradient computations (#Grad)
    n_iters: int = 0

    @property
    def total(self) -> float:
        """Paper's 'Total': times the network is traversed (grad counts 2x)."""
        return self.n_eval + 2 * self.n_grad


def faithful_search(
    score_fn: Callable[[np.ndarray, np.ndarray], float],
    grad_fn: Callable[[np.ndarray, np.ndarray], Tuple[float, np.ndarray]],
    base: np.ndarray,
    neighbors: np.ndarray,
    q: np.ndarray,
    entry: int,
    k: int = 10,
    ef: int = 64,
    mode: str = "guitar",
    rank_by: str = "angle",
    alpha: float = 1.01,
    max_iters: int = 100_000,
) -> Tuple[np.ndarray, np.ndarray, FaithfulStats]:
    """Returns (ids (k,), scores (k,), stats)."""
    stats = FaithfulStats()
    visited = np.zeros(base.shape[0], bool)

    def ev(i: int) -> float:
        stats.n_eval += 1
        return float(score_fn(base[i], q))

    e_score = ev(entry)
    visited[entry] = True
    # max-heap of unexpanded candidates; `results` = best-ef found so far
    frontier: List[Tuple[float, int]] = [(-e_score, entry)]
    results: List[Tuple[float, int]] = [(e_score, entry)]  # min-heap

    while frontier and stats.n_iters < max_iters:
        neg_s, u = heapq.heappop(frontier)
        s_u = -neg_s
        if len(results) >= ef and s_u < results[0][0]:
            break  # frontier can no longer improve the pool
        stats.n_iters += 1

        nbr = neighbors[u]
        nbr = nbr[nbr >= 0]
        fresh = nbr[~visited[nbr]]
        if fresh.size == 0:
            continue

        if mode == "guitar":
            _, g = grad_fn(base[u], q)
            stats.n_grad += 1
            diffs = base[fresh] - base[u]
            gn = np.linalg.norm(g) + 1e-12
            dots = diffs @ g
            dn = np.linalg.norm(diffs, axis=1) + 1e-12
            if rank_by == "angle":
                ang = np.arccos(np.clip(dots / (dn * gn), -1.0, 1.0))
                theta = ang.min()
                probable = fresh[ang <= alpha * theta + 1e-12]
            else:
                proj = dots / gn
                theta = proj.max()
                bound = theta / alpha if theta >= 0 else theta * alpha
                probable = fresh[proj >= bound - 1e-12]
        else:
            probable = fresh

        for v in probable:
            visited[v] = True
            s_v = ev(int(v))
            if len(results) < ef or s_v > results[0][0]:
                heapq.heappush(results, (s_v, int(v)))
                if len(results) > ef:
                    heapq.heappop(results)
                heapq.heappush(frontier, (-s_v, int(v)))

    top = sorted(results, reverse=True)[:k]
    ids = np.array([i for _, i in top], np.int32)
    scores = np.array([s for s, _ in top], np.float32)
    return ids, scores, stats


def faithful_search_batch(score_fn, grad_fn, base, neighbors, queries,
                          entry: int, **kw):
    """Loop over queries; returns (ids (Q,k), scores, aggregated stats)."""
    all_ids, all_scores = [], []
    agg = FaithfulStats()
    for qi in range(queries.shape[0]):
        ids, scores, st = faithful_search(
            score_fn, grad_fn, base, neighbors, queries[qi], entry, **kw)
        all_ids.append(ids)
        all_scores.append(scores)
        agg.n_eval += st.n_eval
        agg.n_grad += st.n_grad
        agg.n_iters += st.n_iters
    k = max(len(a) for a in all_ids)
    ids = np.full((len(all_ids), k), -1, np.int32)
    scs = np.full((len(all_ids), k), -np.inf, np.float32)
    for i, (a, s) in enumerate(zip(all_ids, all_scores)):
        ids[i, : len(a)] = a
        scs[i, : len(s)] = s
    return ids, scs, agg
