"""Wrapper of the analytic MLP-measure value+gradient kernel
(``csrc/mlp_grad.cu``): checks its arguments, launches the kernel for CUDA
tensors, and uses the plain version only for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.mlp_grad.ref import mlp_value_and_grad_ref
from repro_torch.kernels.mlp_score.ops import (check_mlp,
                                               check_rows_and_query,
                                               net_args)


def mlp_value_and_grad(cand: torch.Tensor, query: torch.Tensor,
                       mlp_params: dict):
    """cand: (M, Dx) item rows; query: (M, Dq) rows or one shared (Dq,)
    row; mlp_params: {'w': [...], 'b': [...]}. Returns (vals (M,) f32,
    grads (M, Dx) f32), grads = df/d cand (paper Eq. 2)."""
    M, Dx, Dq = check_rows_and_query(cand, query)
    w, b = check_mlp(mlp_params, Dx, Dq, cand.device)
    if cand.device.type == "cpu":
        q = query.expand(M, Dq) if query.dim() == 1 else query
        return mlp_value_and_grad_ref(cand, q, w, b)
    if cand.device.type != "cuda":
        raise ValueError(f"mlp_value_and_grad: no kernel for {cand.device}")
    net = net_args(w, b, Dx, cand.device)
    vals = torch.empty((M,), dtype=torch.float32, device=cand.device)
    grads = torch.empty((M, Dx), dtype=torch.float32, device=cand.device)
    rc = _lib.load().mlp_grad_f32(
        cand.data_ptr(), query.data_ptr(), int(query.dim() == 1), *net,
        vals.data_ptr(), grads.data_ptr(), M, Dx, Dq,
        _lib.stream_of(cand.device))
    _lib.check(rc, "mlp_value_and_grad")
    mlp_value_and_grad.launches += 1
    return vals, grads


mlp_value_and_grad.launches = 0
