"""The exact top-k of a measure over the whole corpus, in blocks of
queries and items so that it fits beside nothing else on the card: the
family's ``SCAN_BLOCKS`` (``families/<family>.py``)."""
from __future__ import annotations

import torch

from portbench import families
from portbench.products import fp32_mm


def exact_topk(measure: dict, weights: dict, rows: torch.Tensor,
               queries: torch.Tensor, k: int, mm=fp32_mm):
    """(ids (Q, k) int64, logits (Q, k)) of the k best items of ``rows``
    for each query, best first."""
    family = families.reference(measure)
    q_block, n_block = family.SCAN_BLOCKS
    items = family.item_terms(measure, weights, rows, mm)
    n = rows.shape[0]
    out_ids, out_val = [], []
    for s in range(0, queries.shape[0], q_block):
        q = queries[s:s + q_block]
        best_v = torch.full((q.shape[0], k), float("-inf"),
                            device=rows.device)
        best_i = torch.zeros((q.shape[0], k), dtype=torch.int64,
                             device=rows.device)
        for lo in range(0, n, n_block):
            hi = min(n, lo + n_block)
            v = family.block_logits(measure, weights, items, q, lo, hi, mm)
            kk = min(k, hi - lo)
            bv, bi = torch.topk(v, kk, dim=1)
            cat_v = torch.cat([best_v, bv], dim=1)
            cat_i = torch.cat([best_i, bi + lo], dim=1)
            best_v, pos = torch.topk(cat_v, k, dim=1)
            best_i = cat_i.gather(1, pos)
        out_ids.append(best_i)
        out_val.append(best_v)
    return torch.cat(out_ids), torch.cat(out_val)
