"""Wrapper of the index-fused DeepFM scoring kernel
(``csrc/deepfm_score_fused.cu``): checks its arguments, launches the kernel
for a store on the card, and uses the plain version only for a store on the
CPU."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.deepfm_score.ops import (check_deepfm_mlp,
                                                  check_deepfm_plan,
                                                  deepfm_score_plan)
from repro_torch.kernels.deepfm_score_fused.ref import deepfm_score_fused_ref


def check_fused_rows(store, idx: torch.Tensor, query: torch.Tensor,
                     fm_dim: int, mlp_params: dict):
    """idx (M,) int64 and query (M, D) or a shared (D,) row on the store's
    device; the measure MLP as ``check_deepfm_mlp`` takes it. Returns
    (M, D, w, b)."""
    dev = store.device
    _lib.require(idx, "idx", dev, (None,), dtype=torch.int64)
    M, D = idx.shape[0], store.dim
    if not 0 < fm_dim < D:
        raise ValueError(f"fm_dim={fm_dim} must lie in (0, D={D})")
    _lib.require(query, "query", dev, (D,) if query.dim() == 1 else (M, D))
    w, b = check_deepfm_mlp(mlp_params, 2 * (D - fm_dim))
    if w[0].device != dev:
        raise ValueError(f"weights on {w[0].device}, corpus on {dev}")
    return M, D, w, b


def deepfm_score_fused(store, idx: torch.Tensor, query: torch.Tensor,
                       mlp_params: dict, fm_dim: int = 8,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """store: ``CorpusStore`` (float32, bfloat16 or int8); idx: (M,) int64
    candidate ids (-1 padding is clamped to 0 in the kernel; mask the
    scores at the call site); query: (M, D) rows or one shared (D,) row;
    mask: optional (M,) bool adaptive prefix mask, masked rows score -inf
    and skip their MLP. Returns (M,) f32."""
    M, D, w, b = check_fused_rows(store, idx, query, fm_dim, mlp_params)
    dev = store.device
    if mask is not None:
        _lib.require(mask, "mask", dev, (M,), dtype=torch.bool)
    if dev.type == "cpu":
        shared = query if query.dim() == 1 else None
        return _lib.cpu_row_blocks(
            lambda i, q, m: deepfm_score_fused_ref(
                store, i, shared if q is None else q, w[0], b[0], w[1], b[1],
                w[2], b[2], fm_dim, m),
            idx, None if query.dim() == 1 else query, mask)
    if dev.type != "cuda":
        raise ValueError(f"deepfm_score_fused: no kernel for {dev}")
    check_deepfm_plan(deepfm_score_plan, "score", D, fm_dim, w[0].shape[1],
                      w[1].shape[1])
    out = torch.empty((M,), dtype=torch.float32, device=dev)
    data, scales, residency = _lib.corpus_args(store)
    rc = _lib.load().deepfm_score_fused(
        data, scales, idx.data_ptr(), residency, query.data_ptr(),
        int(query.dim() == 1), None if mask is None else mask.data_ptr(),
        w[0].data_ptr(), b[0].data_ptr(), w[1].data_ptr(), b[1].data_ptr(),
        w[2].data_ptr(), b[2].data_ptr(), out.data_ptr(),
        M, D, fm_dim, w[0].shape[1], w[1].shape[1], _lib.stream_of(dev))
    _lib.check(rc, "deepfm_score_fused")
    deepfm_score_fused.launches += 1
    return out


deepfm_score_fused.launches = 0
