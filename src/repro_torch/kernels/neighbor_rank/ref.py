"""Plain PyTorch version of the gradient-ranking kernel (paper Eq. 3/4),
ported from the JAX package's ``kernels/neighbor_rank/ref.py``."""
from __future__ import annotations

import torch


def neighbor_rank_ref(x, grad, nvecs, valid, alpha: float = 1.01,
                      rank_by: str = "angle"):
    """x: (Q, D) frontier; grad: (Q, D) = df/dx; nvecs: (Q, B, D) neighbor
    rows; valid: (Q, B) bool.

    Returns (key (Q, B) f32 — smaller is better, +inf for invalid;
             in_range (Q, B) bool — the adaptive alpha*theta mask)."""
    eps = 1e-12
    diffs = nvecs - x[:, None, :]
    dot = torch.einsum("qbd,qd->qb", diffs, grad)
    dnorm = torch.linalg.vector_norm(diffs, dim=-1) + eps
    gnorm = torch.linalg.vector_norm(grad, dim=-1, keepdim=True) + eps
    inf = float("inf")
    if rank_by == "angle":
        cosv = torch.clamp(dot / (dnorm * gnorm), -1.0, 1.0)
        key = torch.arccos(cosv).masked_fill(~valid, inf)
        theta = torch.min(key, dim=1, keepdim=True).values
        in_range = valid & (key <= alpha * theta + eps)
    else:
        proj = dot / gnorm
        pk = proj.masked_fill(~valid, -inf)
        theta = torch.max(pk, dim=1, keepdim=True).values
        bound = torch.where(theta >= 0, theta / alpha, theta * alpha)
        in_range = valid & (pk >= bound - eps)
        key = (-proj).masked_fill(~valid, inf)
    return key.float(), in_range
