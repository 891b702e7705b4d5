"""Wrapper of the analytic DeepFM value+gradient kernel
(``csrc/deepfm_grad.cu``): checks its arguments, launches the kernel for
CUDA tensors, and uses the plain version only for CPU tensors.
``deepfm_grad_plan`` gives the launch layout of the grad pair's body (the
MLP grad pair's cluster body, ``csrc/mlp_grad.cuh``, over the DeepFM
input)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.deepfm_grad.ref import deepfm_value_and_grad_ref
from repro_torch.kernels.deepfm_score.ops import (check_deepfm_mlp,
                                                  check_deepfm_plan,
                                                  check_rows_and_query)
from repro_torch.kernels.mlp_grad.ops import GRAD_SMEM_CAP, mlp_grad_plan


def deepfm_grad_plan(D: int, fm_dim: int, h0: int, h1: int,
                     cap: Optional[int] = GRAD_SMEM_CAP):
    """The DeepFM grad kernels' launch layout (``mlp_grad_plan`` of the
    deep part [q_deep | x_deep] -> h0 -> h1 -> 1, d_x = D - fm_dim, with
    the tile's FM columns), or None if a CTA's shared memory does not
    fit ``cap``."""
    dd = D - fm_dim
    return mlp_grad_plan([2 * dd, h0, h1, 1], dd, fm_dim, cap)


def deepfm_value_and_grad(cand: torch.Tensor, query: torch.Tensor,
                          mlp_params: dict, fm_dim: int = 8):
    """cand: (M, D) item rows; query: (M, D) rows or one shared (D,) row;
    mlp_params: {'w': [w0, w1, w2], 'b': [b0, b1, b2]}. Returns
    (vals (M,) f32, grads (M, D) f32), grads = df/d cand (paper Eq. 2)."""
    M, D = check_rows_and_query(cand, query, fm_dim)
    w, b = check_deepfm_mlp(mlp_params, 2 * (D - fm_dim))
    if w[0].device != cand.device:
        raise ValueError(f"weights on {w[0].device}, rows on {cand.device}")
    if cand.device.type == "cpu":
        q = query.expand(M, D) if query.dim() == 1 else query
        return _lib.cpu_row_blocks(
            lambda c, qq: deepfm_value_and_grad_ref(
                c, qq, w[0], b[0], w[1], b[1], w[2], b[2], fm_dim), cand, q)
    if cand.device.type != "cuda":
        raise ValueError(f"deepfm_value_and_grad: no kernel for "
                         f"{cand.device}")
    check_deepfm_plan(deepfm_grad_plan, "grad", D, fm_dim, w[0].shape[1],
                      w[1].shape[1])
    vals = torch.empty((M,), dtype=torch.float32, device=cand.device)
    grads = torch.empty((M, D), dtype=torch.float32, device=cand.device)
    lib = _lib.load()
    rc = lib.deepfm_grad_f32(
        cand.data_ptr(), query.data_ptr(), int(query.dim() == 1),
        w[0].data_ptr(), b[0].data_ptr(), w[1].data_ptr(), b[1].data_ptr(),
        w[2].data_ptr(), b[2].data_ptr(), vals.data_ptr(), grads.data_ptr(),
        M, D, fm_dim, w[0].shape[1], w[1].shape[1],
        _lib.stream_of(cand.device))
    _lib.check(rc, "deepfm_value_and_grad")
    deepfm_value_and_grad.launches += 1
    return vals, grads


deepfm_value_and_grad.launches = 0
