"""Plain PyTorch version of the index-fused MLP-measure value+gradient
kernel (ported from the JAX package's ``kernels/mlp_score/ref.py``,
``mlp_grad_fused_ref``): gather and dequantize the frontier rows with
``CorpusStore.take``, then the pre-gathered plain version; the rows come
back as ``x``."""
from __future__ import annotations

import torch

from repro_torch.kernels.mlp_grad.ref import mlp_value_and_grad_ref


def mlp_grad_fused_ref(store, idx: torch.Tensor, query: torch.Tensor, Ws,
                       bs):
    """store: resident corpus; idx: (Q,) frontier ids (-1 is clamped to 0);
    query: (Q, Dq) or a shared (Dq,) row. Returns (vals (Q,), grads
    (Q, Dx), x (Q, Dx)), x the dequantized rows."""
    x = store.take(idx.clamp_min(0))
    if query.dim() == 1:
        query = query.expand(x.shape[0], -1)
    vals, grads = mlp_value_and_grad_ref(x, query, Ws, bs)
    return vals, grads, x
