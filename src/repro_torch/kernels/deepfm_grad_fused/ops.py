"""Wrapper of the index-fused DeepFM value+gradient kernel
(``csrc/deepfm_grad_fused.cu``): checks its arguments, launches the kernel
for a store on the card, and uses the plain version only for a store on the
CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.deepfm_grad.ops import deepfm_grad_plan
from repro_torch.kernels.deepfm_grad_fused.ref import deepfm_grad_fused_ref
from repro_torch.kernels.deepfm_score.ops import check_deepfm_plan
from repro_torch.kernels.deepfm_score_fused.ops import check_fused_rows


def deepfm_grad_fused(store, idx: torch.Tensor, query: torch.Tensor,
                      mlp_params: dict, fm_dim: int = 8):
    """store: ``CorpusStore``; idx: (Q,) int64 frontier ids (-1 is clamped
    to 0 in the kernel); query: (Q, D) rows or one shared (D,) row. Returns
    (vals (Q,) f32, grads (Q, D) f32 = df/dx, x (Q, D) f32), x the
    dequantized frontier rows (equal to ``store.take(idx.clamp_min(0))``),
    which the rank stage consumes."""
    M, D, w, b = check_fused_rows(store, idx, query, fm_dim, mlp_params)
    dev = store.device
    if dev.type == "cpu":
        shared = query if query.dim() == 1 else None
        return _lib.cpu_row_blocks(
            lambda i, q: deepfm_grad_fused_ref(
                store, i, shared if q is None else q, w[0], b[0], w[1], b[1],
                w[2], b[2], fm_dim),
            idx, None if query.dim() == 1 else query)
    if dev.type != "cuda":
        raise ValueError(f"deepfm_grad_fused: no kernel for {dev}")
    check_deepfm_plan(deepfm_grad_plan, "grad", D, fm_dim, w[0].shape[1],
                      w[1].shape[1])
    vals = torch.empty((M,), dtype=torch.float32, device=dev)
    grads = torch.empty((M, D), dtype=torch.float32, device=dev)
    x = torch.empty((M, D), dtype=torch.float32, device=dev)
    data, scales, residency = _lib.corpus_args(store)
    rc = _lib.load().deepfm_grad_fused(
        data, scales, idx.data_ptr(), residency, query.data_ptr(),
        int(query.dim() == 1),
        w[0].data_ptr(), b[0].data_ptr(), w[1].data_ptr(), b[1].data_ptr(),
        w[2].data_ptr(), b[2].data_ptr(), vals.data_ptr(), grads.data_ptr(),
        x.data_ptr(), M, D, fm_dim, w[0].shape[1], w[1].shape[1],
        _lib.stream_of(dev))
    _lib.check(rc, "deepfm_grad_fused")
    deepfm_grad_fused.launches += 1
    return vals, grads, x


deepfm_grad_fused.launches = 0
