"""Plain PyTorch version of the DeepFM scoring kernel (ported from the JAX
package's ``kernels/deepfm_score/ref.py``)."""
from __future__ import annotations

import torch


def deepfm_score_ref(cand: torch.Tensor, query: torch.Tensor, w0, b0, w1, b1,
                     w2, b2, fm_dim: int = 8) -> torch.Tensor:
    """cand: (N, D) item rows; query: (N, D) user rows (pre-broadcast);
    D = fm_dim + deep_dim. Returns (N,) sigmoid scores.

    f = sigmoid(<x_fm, q_fm> + MLP([q_deep, x_deep]))"""
    fm = torch.sum(cand[:, :fm_dim] * query[:, :fm_dim], dim=-1)
    deep_in = torch.cat([query[:, fm_dim:], cand[:, fm_dim:]], dim=-1)
    h = torch.relu(deep_in @ w0 + b0)
    h = torch.relu(h @ w1 + b1)
    logit = (h @ w2)[:, 0] + b2[0] + fm
    return torch.sigmoid(logit.float())
