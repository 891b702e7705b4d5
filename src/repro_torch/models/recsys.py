"""Embedding ops of the recommendation models, the counterparts of the JAX
package's ``models/recsys.py`` embedding section.

The Criteo-style models keep ONE concatenated table with per-field row
offsets (one big gather instead of 26 small ones). Bagged (multi-hot)
lookups are a gather plus a segment reduction, written here as plain
torch (``index_select``, ``index_add_``, ``scatter_reduce``); as in the JAX
package, they call no kernel (``kernels.embedding_bag`` is the kernel of
the padded (B, L) form).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# Criteo Kaggle display-advertising per-field cardinalities (26 sparse fields).
CRITEO_CARDINALITIES: Tuple[int, ...] = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)


def embedding_lookup(table: torch.Tensor, indices: torch.Tensor
                     ) -> torch.Tensor:
    """Plain row gather: (rows, dim) x (...,) -> (..., dim)."""
    return table.index_select(0, indices.reshape(-1).long()).reshape(
        *indices.shape, table.shape[1])


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segment_ids: torch.Tensor, n_bags: int,
                  weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag: gather rows, then reduce them into bags.

    indices: (nnz,) rows; segment_ids: (nnz,) bag ids (sorted or not);
    returns (n_bags, dim) in the table's dtype. An empty bag is 0 for
    ``sum`` and ``mean``, and -inf for ``max`` (as ``segment_max``)."""
    rows = embedding_lookup(table, indices)
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    seg = segment_ids.long()
    shape = (n_bags, table.shape[1])
    if mode in ("sum", "mean"):
        s = torch.zeros(shape, dtype=rows.dtype, device=rows.device)
        s.index_add_(0, seg, rows)
        if mode == "sum":
            return s
        cnt = torch.zeros((n_bags,), dtype=rows.dtype, device=rows.device)
        cnt.index_add_(0, seg, torch.ones_like(seg, dtype=rows.dtype))
        return s / torch.clamp(cnt, min=1.0)[:, None]
    if mode == "max":
        out = torch.full(shape, float("-inf"), dtype=rows.dtype,
                         device=rows.device)
        return out.scatter_reduce(0, seg[:, None].expand_as(rows), rows,
                                  reduce="amax", include_self=True)
    raise ValueError(mode)


def field_offsets(cardinalities: Sequence[int]) -> np.ndarray:
    """Row offset of each field in the concatenated table."""
    return np.concatenate([[0], np.cumsum(cardinalities)[:-1]]).astype(
        np.int32)


def multi_field_lookup(table: torch.Tensor, sparse: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """sparse: (B, F) per-field ids -> (B, F, dim) via one fused gather."""
    return embedding_lookup(table, sparse + offsets[None, :])
