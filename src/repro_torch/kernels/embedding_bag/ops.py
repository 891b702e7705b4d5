"""Wrapper of the EmbeddingBag kernel (``csrc/embedding_bag.cu``): checks
its arguments, launches the kernel for CUDA tensors, and uses the plain
version only for CPU tensors."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  block_b: int = 8) -> torch.Tensor:
    """table: (R, d) float32 or bfloat16; indices: (B, L) int32 or int64,
    -1 = padding; weights: optional (B, L), rounded to the table's dtype.
    Returns (B, d) per-bag weighted sums in the table's dtype.

    ``block_b`` is kept from the JAX signature; on the card the kernel
    chooses its own tile (a group of lanes per bag), and B need not be a
    multiple of anything. An id outside [-1, R) adds 0, as -1 does."""
    del block_b
    if table.dim() != 2 or table.dtype not in _lib.DTYPE:
        raise TypeError(f"embedding_bag: table must be (R, d) float32 or "
                        f"bfloat16, got {tuple(table.shape)} {table.dtype}")
    if indices.dim() != 2 or indices.dtype not in (torch.int32,
                                                   torch.int64):
        raise TypeError(f"embedding_bag: indices must be (B, L) int32 or "
                        f"int64, got {tuple(indices.shape)} {indices.dtype}")
    dev = table.device
    B, L = indices.shape
    if weights is not None:
        if not weights.is_floating_point():
            raise TypeError(f"embedding_bag: weights dtype {weights.dtype}")
        _lib.require(weights, "weights", dev, (B, L), weights.dtype)
    _lib.require(indices, "indices", dev, (B, L), indices.dtype)
    if dev.type == "cpu":
        return embedding_bag_ref(table, indices, weights)
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag: no kernel for {dev}")
    _lib.require(table, "table", dev, (None, None), table.dtype)
    R, d = table.shape
    w = None if weights is None else weights.to(table.dtype).contiguous()
    out = torch.empty((B, d), dtype=table.dtype, device=dev)
    rc = _lib.load().embedding_bag(
        table.data_ptr(), _lib.DTYPE[table.dtype], R, d,
        indices.data_ptr(), int(indices.dtype == torch.int64),
        None if w is None else w.data_ptr(), out.data_ptr(), B, L,
        _lib.stream_of(dev))
    _lib.check(rc, "embedding_bag")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
