"""Search API for fast neural ranking: the engine-backed ``search_measure``,
the exact ``brute_force_topk`` labeler and ``recall``."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.corpus import CorpusStore
from repro_torch.core.engine import (EngineOptions, SearchConfig,
                                     SearchResult, build_engine)
from repro_torch.core.measures import Measure


def search_measure(measure: Measure, base, neighbors, queries, entries,
                   cfg: SearchConfig,
                   options: Optional[EngineOptions] = None,
                   capture: bool = True) -> SearchResult:
    """Batched GUITAR/SL2G search with the measure's registered kernels;
    ``options`` selects the fused stages and the corpus residency. On the
    card the search runs as captured programs (``capture=False``: the
    eager host loop)."""
    eng = build_engine(measure, cfg, options or EngineOptions())
    return eng.search(measure.params, base, neighbors, queries, entries,
                      capture=capture)


def brute_force_topk(measure: Measure, base: torch.Tensor,
                     queries: torch.Tensor, k: int, batch: int = 8192,
                     q_block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by exhaustive evaluation of the measure's plain
    ``score_fn`` (the ground-truth labels), blocked over queries and corpus
    with a running top-k merge. Ties keep the lower id first, as
    ``lax.top_k`` does. ``base`` is always the float32 (N, D) corpus, never
    a (possibly quantized) ``CorpusStore``: labels are taken at full
    precision. Runs on ``queries.device``; returns (ids (Q, k) int64,
    scores (Q, k) f32)."""
    if isinstance(base, CorpusStore):
        raise TypeError("brute_force_topk labels against the float32 base; "
                        "pass the (N, D) array, not a CorpusStore")
    dev = queries.device
    base = torch.as_tensor(base, device=dev, dtype=torch.float32)
    outs_i, outs_s = [], []
    for q0 in range(0, queries.shape[0], q_block):
        qb = queries[q0: q0 + q_block]
        best_s = torch.full((qb.shape[0], k), float("-inf"),
                            dtype=torch.float32, device=dev)
        best_i = torch.full((qb.shape[0], k), -1, dtype=torch.int64,
                            device=dev)
        for s in range(0, base.shape[0], batch):
            xs = base[s: s + batch]
            scores = measure.score_fn(measure.params, xs[None, :, :],
                                      qb[:, None, :]).float()
            ids = torch.arange(s, s + xs.shape[0], device=dev)
            cs = torch.cat([best_s, scores], dim=1)
            ci = torch.cat([best_i, ids[None, :].expand_as(scores)], dim=1)
            order = torch.sort(cs, dim=1, descending=True,
                               stable=True).indices[:, :k]
            best_s, best_i = cs.gather(1, order), ci.gather(1, order)
        outs_i.append(best_i)
        outs_s.append(best_s)
    return torch.cat(outs_i), torch.cat(outs_s)


def recall(found_ids, true_ids) -> float:
    """Mean |A ∩ B| / |B| over queries."""
    fi, ti = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
              for a in (found_ids, true_ids))
    Q, k = ti.shape
    hits = sum(len(set(map(int, fi[i])) & set(map(int, ti[i])))
               for i in range(Q))
    return hits / (Q * k)
