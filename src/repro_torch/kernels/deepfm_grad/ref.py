"""Plain PyTorch version of the analytic DeepFM value+gradient kernel
(ported from the JAX package's ``kernels/deepfm_grad/ref.py``): the
hand-derived backward, batched over rows."""
from __future__ import annotations

import torch


def deepfm_value_and_grad_ref(cand: torch.Tensor, query: torch.Tensor, w0,
                              b0, w1, b1, w2, b2, fm_dim: int = 8):
    """cand: (M, D) item rows; query: (M, D) user rows (pre-broadcast).
    Returns (vals (M,) f32, grads (M, D) f32) with grads = df/d cand.

    f = sigmoid(<x_fm, q_fm> + MLP([q_deep, x_deep]))"""
    deep_dim = cand.shape[-1] - fm_dim
    fm = torch.sum(cand[:, :fm_dim] * query[:, :fm_dim], dim=-1)
    h = torch.cat([query[:, fm_dim:], cand[:, fm_dim:]], dim=-1)
    z0 = h @ w0 + b0
    z1 = torch.relu(z0) @ w1 + b1
    logit = (torch.relu(z1) @ w2)[:, 0] + b2[0]
    val = torch.sigmoid(fm + logit)
    g_logit = val * (1.0 - val)                                # (M,)
    g = g_logit[:, None] @ w2.T                                # (M, H1)
    g = g * (z1 > 0)
    g = (g @ w1.T) * (z0 > 0)                                  # (M, H0)
    g = g @ w0.T                                               # (M, 2dd)
    # the deep input is [q_deep, x_deep]: the x cotangent is the tail half
    gx = torch.cat([g_logit[:, None] * query[:, :fm_dim], g[:, deep_dim:]],
                   dim=-1)
    return val.float(), gx.float()
