"""Plain PyTorch version of the index-fused DeepFM value+gradient kernel
(ported from the JAX package's ``kernels/deepfm_grad_fused/ref.py``):
gather and dequantize the frontier rows with ``CorpusStore.take``, then the
pre-gathered plain version; the rows come back as ``x``."""
from __future__ import annotations

import torch

from repro_torch.kernels.deepfm_grad.ref import deepfm_value_and_grad_ref


def deepfm_grad_fused_ref(store, idx: torch.Tensor, query: torch.Tensor,
                          w0, b0, w1, b1, w2, b2, fm_dim: int = 8):
    """store: resident corpus; idx: (Q,) frontier ids (-1 is clamped to 0);
    query: (Q, D) or a shared (D,) row. Returns (vals (Q,), grads (Q, D),
    x (Q, D)), x the dequantized rows."""
    x = store.take(idx.clamp_min(0))
    if query.dim() == 1:
        query = query.expand(x.shape)
    vals, grads = deepfm_value_and_grad_ref(x, query, w0, b0, w1, b1, w2, b2,
                                            fm_dim)
    return vals, grads, x
