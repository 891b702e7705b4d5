"""Plain PyTorch version of the MLP-measure scoring kernel (ported from
the JAX package's ``kernels/mlp_score/ref.py``), batched over rows."""
from __future__ import annotations

import torch


def mlp_forward(cand: torch.Tensor, query: torch.Tensor, Ws, bs):
    """The network over the rows' concatenated input [x | q]. Returns
    (logits (M,), acts), ``acts[i]`` the input of layer i (so ``acts[i] >
    0`` is layer i-1's ReLU mask for i >= 1)."""
    h = torch.cat([cand, query], dim=-1)
    acts = [h]
    for i in range(len(Ws)):
        h = h @ Ws[i] + bs[i]
        if i < len(Ws) - 1:
            h = torch.relu(h)
            acts.append(h)
    return h[:, 0], acts


def mlp_score_ref(cand: torch.Tensor, query: torch.Tensor, Ws,
                  bs) -> torch.Tensor:
    """cand: (M, Dx) item rows; query: (M, Dq) user rows (pre-broadcast);
    Ws/bs: the layers, the last of width 1. Returns (M,) f32.

    f = sigmoid(MLP([x, q]))"""
    logits, _ = mlp_forward(cand, query, Ws, bs)
    return torch.sigmoid(logits).float()
