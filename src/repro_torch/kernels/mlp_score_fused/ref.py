"""Plain PyTorch version of the index-fused MLP-measure scoring kernel
(ported from the JAX package's ``kernels/mlp_score/ref.py``,
``mlp_score_fused_ref``): gather and dequantize the rows with
``CorpusStore.take``, then the pre-gathered plain version, so at float32
residency it equals that one exactly."""
from __future__ import annotations

import torch

from repro_torch.kernels.mlp_score.ref import mlp_score_ref


def mlp_score_fused_ref(store, idx: torch.Tensor, query: torch.Tensor, Ws,
                        bs, mask=None) -> torch.Tensor:
    """store: resident corpus; idx: (M,) row ids (-1 is clamped to 0);
    query: (M, Dq) or a shared (Dq,) row; mask: optional (M,) bool, masked
    rows score -inf. Returns (M,) f32."""
    cand = store.take(idx.clamp_min(0))
    if query.dim() == 1:
        query = query.expand(cand.shape[0], -1)
    out = mlp_score_ref(cand, query, Ws, bs)
    return out if mask is None else out.masked_fill(~mask, float("-inf"))
