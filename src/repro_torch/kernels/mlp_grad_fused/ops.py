"""Wrapper of the index-fused MLP-measure value+gradient kernel
(``csrc/mlp_grad_fused.cu``): checks its arguments, launches the kernel for
a store on the card, and uses the plain version only for a store on the
CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.mlp_grad_fused.ref import mlp_grad_fused_ref
from repro_torch.kernels.mlp_score.ops import net_args
from repro_torch.kernels.mlp_score_fused.ops import check_fused_rows


def mlp_grad_fused(store, idx: torch.Tensor, query: torch.Tensor,
                   mlp_params: dict):
    """store: ``CorpusStore``; idx: (Q,) int64 frontier ids (-1 is clamped
    to 0 in the kernel); query: (Q, Dq) rows or one shared (Dq,) row.
    Returns (vals (Q,) f32, grads (Q, Dx) f32 = df/dx, x (Q, Dx) f32), x
    the dequantized frontier rows (equal to
    ``store.take(idx.clamp_min(0))``), which the rank stage consumes."""
    M, Dx, Dq, w, b = check_fused_rows(store, idx, query, mlp_params)
    dev = store.device
    if dev.type == "cpu":
        shared = query if query.dim() == 1 else None
        return _lib.cpu_row_blocks(
            lambda i, q: mlp_grad_fused_ref(store, i,
                                            shared if q is None else q, w, b),
            idx, None if query.dim() == 1 else query)
    if dev.type != "cuda":
        raise ValueError(f"mlp_grad_fused: no kernel for {dev}")
    net = net_args(w, b, Dx, dev)
    vals = torch.empty((M,), dtype=torch.float32, device=dev)
    grads = torch.empty((M, Dx), dtype=torch.float32, device=dev)
    x = torch.empty((M, Dx), dtype=torch.float32, device=dev)
    data, scales, residency = _lib.corpus_args(store)
    rc = _lib.load().mlp_grad_fused(
        data, scales, idx.data_ptr(), residency, query.data_ptr(),
        int(query.dim() == 1), *net, vals.data_ptr(), grads.data_ptr(),
        x.data_ptr(), M, Dx, Dq, _lib.stream_of(dev))
    _lib.check(rc, "mlp_grad_fused")
    mlp_grad_fused.launches += 1
    return vals, grads, x


mlp_grad_fused.launches = 0
