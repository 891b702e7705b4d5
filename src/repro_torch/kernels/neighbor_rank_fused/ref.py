"""Plain PyTorch version of the index-fused gradient-ranking kernel (ported
from the JAX package's ``kernels/neighbor_rank_fused/ref.py``): raw Eq. 3/4
keys of the rows ``CorpusStore.take`` gathers, then ``mask_from_key``'s
validity and alpha*theta band. At float32 residency it equals the
pre-gathered ``neighbor_rank_ref`` exactly."""
from __future__ import annotations

import torch

from repro_torch.kernels.neighbor_rank.ref import neighbor_rank_ref


def mask_from_key(key: torch.Tensor, valid: torch.Tensor, alpha: float,
                  rank_by: str):
    """Raw per-neighbor keys (angle, or the negated projection) ->
    (key (Q, B) f32 with +inf where invalid, in_range (Q, B) bool, the
    adaptive alpha*theta band)."""
    eps = 1e-12
    inf = float("inf")
    if rank_by == "angle":
        key = key.masked_fill(~valid, inf)
        theta = torch.min(key, dim=1, keepdim=True).values
        in_range = valid & (key <= alpha * theta + eps)
    else:
        pk = (-key).masked_fill(~valid, -inf)   # projection keys are negated
        theta = torch.max(pk, dim=1, keepdim=True).values
        bound = torch.where(theta >= 0, theta / alpha, theta * alpha)
        in_range = valid & (pk >= bound - eps)
        key = key.masked_fill(~valid, inf)
    return key.float(), in_range


def neighbor_rank_fused_ref(x, grad, store, idx, valid, alpha: float = 1.01,
                            rank_by: str = "angle"):
    """x, grad: (Q, D); store: resident corpus; idx: (Q, B) neighbor ids
    (-1 is clamped to 0); valid: (Q, B) bool. Returns (key (Q, B) f32,
    in_range (Q, B) bool), the contract of ``neighbor_rank_ref``."""
    nvecs = store.take(idx.clamp_min(0))
    raw, _ = neighbor_rank_ref(x, grad, nvecs, torch.ones_like(valid), alpha,
                               rank_by)
    return mask_from_key(raw, valid, alpha, rank_by)
