"""Gradient compression for cross-pod reduction: the JAX package's
``train/compress.py`` in PyTorch over parameter trees. Two schemes, both
with error feedback (the residual is carried to the next step so the
compression is unbiased over time):

  - int8 uniform quantization (per-tensor scale): 4x over fp32, 2x over bf16
  - top-k sparsification (keep the largest |g| fraction): 10-100x, pairs
    with an all-gather of (values, indices) instead of an all-reduce

A compressed tree holds a ``(q, scale)`` or ``(values, indices)`` pair at
each leaf of the gradient tree. Standalone on one device (no collective
here; the reduction it prepares needs several).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _is_pair(t) -> bool:
    return isinstance(t, tuple) and len(t) == 2 and all(
        isinstance(x, torch.Tensor) for x in t)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 in [-127, 127], scale float32): q = round(g / scale), half
    to even, scale = max|g| / 127 + 1e-12."""
    scale = torch.max(torch.abs(g)).to(torch.float32) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _ef(compress, decompress, grads: Any, errors: Any):
    """Error feedback over a tree: each leaf's target g + e compressed, the
    new error target - decompressed. Returns (compressed tree, errors)."""
    comp, errs = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(errors)):
        target = g.to(torch.float32) + e.to(torch.float32)
        c = compress(target)
        comp.append(c)
        errs.append((target - decompress(c, target.shape)).to(e.dtype))
    return tree_unflatten(grads, comp), tree_unflatten(grads, errs)


def compress_int8_ef(grads: Any, errors: Any) -> Tuple[Any, Any]:
    """Error-feedback int8: returns (tree of (q, scale), new_errors).
    Decompress with ``decompress_int8``."""
    return _ef(quantize_int8, lambda c, shape: dequantize_int8(*c),
               grads, errors)


def decompress_int8(comp: Any, dtype=torch.float32) -> Any:
    return tree_map(lambda qs: dequantize_int8(qs[0], qs[1], dtype), comp,
                    is_leaf=_is_pair)


def topk_sparsify(g: torch.Tensor, frac: float = 0.01
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the largest-|g| fraction. Returns (values, flat int32 indices),
    largest |g| first."""
    flat = g.reshape(-1).to(torch.float32)
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx.to(torch.int32)


def topk_densify(values: torch.Tensor, indices: torch.Tensor, shape,
                 dtype=torch.float32) -> torch.Tensor:
    out = torch.zeros(math.prod(shape), dtype=torch.float32,
                      device=values.device)
    out = out.index_add(0, indices.long(), values.to(torch.float32))
    return out.reshape(tuple(shape)).to(dtype)


def topk_compress_ef(grads: Any, errors: Any, frac: float = 0.01):
    """Error-feedback top-k. Returns (tree of (values, indices),
    new_errors)."""
    return _ef(lambda t: topk_sparsify(t, frac),
               lambda c, shape: topk_densify(*c, shape), grads, errors)


def init_error_state(grads_like: Any, dtype=torch.float32) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=dtype,
                                          device=g.device), grads_like)
