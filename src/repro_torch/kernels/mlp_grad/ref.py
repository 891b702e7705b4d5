"""Plain PyTorch version of the analytic MLP-measure value+gradient kernel
(ported from the JAX package's ``kernels/mlp_score/ref.py``,
``mlp_value_and_grad_ref``): the hand-derived backward, batched over
rows."""
from __future__ import annotations

import torch

from repro_torch.kernels.mlp_score.ref import mlp_forward


def mlp_value_and_grad_ref(cand: torch.Tensor, query: torch.Tensor, Ws, bs):
    """cand: (M, Dx) item rows; query: (M, Dq) user rows (pre-broadcast).
    Returns (vals (M,) f32, grads (M, Dx) f32) with grads = df/d cand: the
    sigmoid derivative f*(1-f), then ``g @ W.T`` down the layers with the
    ReLU backward as an ``acts > 0`` mask, sliced to the x inputs."""
    logits, acts = mlp_forward(cand, query, Ws, bs)
    val = torch.sigmoid(logits)
    g = (val * (1.0 - val))[:, None]
    for i in range(len(Ws) - 1, -1, -1):
        g = g @ Ws[i].T
        if i > 0:
            g = g * (acts[i] > 0)
    return val.float(), g[:, :cand.shape[-1]].float().contiguous()
