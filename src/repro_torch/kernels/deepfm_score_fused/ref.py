"""Plain PyTorch version of the index-fused DeepFM scoring kernel (ported
from the JAX package's ``kernels/deepfm_score_fused/ref.py``): gather and
dequantize the rows with ``CorpusStore.take``, then the pre-gathered
plain version, so at float32 residency it equals that one exactly."""
from __future__ import annotations

import torch

from repro_torch.kernels.deepfm_score.ref import deepfm_score_ref


def deepfm_score_fused_ref(store, idx: torch.Tensor, query: torch.Tensor,
                           w0, b0, w1, b1, w2, b2, fm_dim: int = 8,
                           mask=None) -> torch.Tensor:
    """store: resident corpus; idx: (M,) row ids (-1 is clamped to 0);
    query: (M, D) or a shared (D,) row; mask: optional (M,) bool, masked
    rows score -inf. Returns (M,) f32."""
    cand = store.take(idx.clamp_min(0))
    if query.dim() == 1:
        query = query.expand(cand.shape)
    out = deepfm_score_ref(cand, query, w0, b0, w1, b1, w2, b2, fm_dim)
    return out if mask is None else out.masked_fill(~mask, float("-inf"))
