"""Plain PyTorch version of the EmbeddingBag kernel (counterpart of the JAX
package's ``kernels/embedding_bag/ref.py``), with the kernel's arithmetic:
each weight rounded to the table's dtype, the bag summed slot by slot in
float32 (a product, then an add, no fused multiply-add), the sum rounded
once to the table's dtype."""
from __future__ import annotations

from typing import Optional

import torch


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """table: (R, d); indices: (B, L), -1 = padding; weights: optional
    (B, L). Returns (B, d) per-bag weighted sums in the table's dtype.

    An id outside [-1, R) is out of contract; it adds 0, as -1 does (the
    kernel never reads outside the table)."""
    R, d = table.shape
    B, L = indices.shape
    valid = (indices >= 0) & (indices < R)
    safe = torch.where(valid, indices, 0).long()
    rows = table.index_select(0, safe.reshape(-1)).reshape(B, L, d).float()
    w = valid.float()
    if weights is not None:
        w = w * weights.to(table.dtype).float()
    acc = torch.zeros((B, d), dtype=torch.float32, device=table.device)
    for j in range(L):
        acc = acc + rows[:, j] * w[:, j, None]
    return acc.to(table.dtype)
