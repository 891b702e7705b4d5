"""Wrapper of the index-fused MLP-measure scoring kernel
(``csrc/mlp_score_fused.cu``): checks its arguments, launches the kernel
for a store on the card, and uses the plain version only for a store on
the CPU."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.mlp_score.ops import check_mlp, net_args
from repro_torch.kernels.mlp_score_fused.ref import mlp_score_fused_ref


def check_fused_rows(store, idx: torch.Tensor, query: torch.Tensor,
                     mlp_params: dict):
    """idx (M,) int64 and query (M, Dq) or a shared (Dq,) row on the
    store's device; the network as ``check_mlp`` takes it. Returns
    (M, Dx, Dq, w, b)."""
    dev = store.device
    _lib.require(idx, "idx", dev, (None,), dtype=torch.int64)
    M, Dx = idx.shape[0], store.dim
    _lib.require(query, "query", dev,
                 (None,) if query.dim() == 1 else (M, None))
    Dq = query.shape[-1]
    w, b = check_mlp(mlp_params, Dx, Dq, dev)
    return M, Dx, Dq, w, b


def mlp_score_fused(store, idx: torch.Tensor, query: torch.Tensor,
                    mlp_params: dict,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """store: ``CorpusStore`` (float32, bfloat16 or int8); idx: (M,) int64
    candidate ids (-1 padding is clamped to 0 in the kernel; mask the
    scores at the call site); query: (M, Dq) rows or one shared (Dq,) row;
    mask: optional (M,) bool adaptive prefix mask, masked rows score -inf
    and skip their MLP. Returns (M,) f32."""
    M, Dx, Dq, w, b = check_fused_rows(store, idx, query, mlp_params)
    dev = store.device
    if mask is not None:
        _lib.require(mask, "mask", dev, (M,), dtype=torch.bool)
    if dev.type == "cpu":
        shared = query if query.dim() == 1 else None
        return _lib.cpu_row_blocks(
            lambda i, q, m: mlp_score_fused_ref(
                store, i, shared if q is None else q, w, b, m),
            idx, None if query.dim() == 1 else query, mask)
    if dev.type != "cuda":
        raise ValueError(f"mlp_score_fused: no kernel for {dev}")
    net = net_args(w, b, Dx, dev)
    out = torch.empty((M,), dtype=torch.float32, device=dev)
    data, scales, residency = _lib.corpus_args(store)
    rc = _lib.load().mlp_score_fused(
        data, scales, idx.data_ptr(), residency, query.data_ptr(),
        int(query.dim() == 1), None if mask is None else mask.data_ptr(),
        *net, out.data_ptr(), M, Dx, Dq, _lib.stream_of(dev))
    _lib.check(rc, "mlp_score_fused")
    mlp_score_fused.launches += 1
    return out


mlp_score_fused.launches = 0
