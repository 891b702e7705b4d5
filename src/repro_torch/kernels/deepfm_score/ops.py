"""Wrapper of the DeepFM scoring kernel (``csrc/deepfm_score.cu``): checks
its arguments, launches the kernel for CUDA tensors, and uses the plain
version only for CPU tensors. ``deepfm_score_plan`` gives the launch
layout of the score pair's body (the MLP score's cluster body,
``csrc/mlp_grad.cuh``, over the DeepFM input)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.deepfm_score.ref import deepfm_score_ref
from repro_torch.kernels.mlp_grad.ops import (GRAD_SMEM_CAP, SCORE_CLUSTER,
                                              SCORE_TILE, cluster_plan)
from repro_torch.kernels.mlp_score.ops import GENERIC


def deepfm_score_plan(D: int, fm_dim: int, h0: int, h1: int,
                      cap: Optional[int] = GRAD_SMEM_CAP):
    """The DeepFM score kernels' launch layout (``deepfm_cluster_plan`` in
    csrc/mlp_grad.cuh at the score's tile: SCORE_TILE rows per cluster of
    up to SCORE_CLUSTER CTAs, forward only, of the deep part [q_deep |
    x_deep] -> h0 -> h1 -> 1 with the tile's FM columns), with its
    ``rows``, or None if a CTA's shared memory does not fit ``cap``."""
    dd = D - fm_dim
    plan = cluster_plan([2 * dd, h0, h1, 1], dd, SCORE_TILE, SCORE_CLUSTER,
                        False, fm_dim, cap)
    return None if plan is None else {**plan, "rows": SCORE_TILE}


def check_deepfm_plan(plan_of, kernel: str, D: int, fm_dim: int, h0: int,
                      h1: int) -> None:
    """Raise ValueError, naming the generic stages, where the cluster plan
    ``plan_of`` (``deepfm_score_plan`` or ``deepfm_grad_plan``) refuses the
    net: the C launcher would refuse it too, with only a CUDA error."""
    if plan_of(D, fm_dim, h0, h1) is None:
        need = plan_of(D, fm_dim, h0, h1, cap=None)["smem_bytes"]
        raise ValueError(
            f"the deepfm {kernel} kernels' cluster plan does not fit a CTA: "
            f"D={D}, fm={fm_dim}, hidden {h0}x{h1} need {need} bytes of "
            f"shared memory per CTA, more than {GRAD_SMEM_CAP}; {GENERIC}")


def check_deepfm_mlp(mlp_params: dict, d_deep_in: int):
    """The DeepFM kernels take exactly the paper's 2-hidden-layer measure
    MLP (three weight matrices); anything else raises rather than being
    silently truncated. Returns (w, b) lists."""
    w, b = list(mlp_params["w"]), list(mlp_params["b"])
    if len(w) != 3 or len(b) != 3:
        raise ValueError(
            f"deepfm kernels support exactly 3 MLP weight matrices, got "
            f"{len(w)}; force the generic stages via EngineOptions("
            f"measure_impl='vmap', grad_impl='vmap')")
    dev = w[0].device
    h0, h1 = w[0].shape[-1], w[1].shape[-1]
    for t, name, shape in ((w[0], "w0", (d_deep_in, h0)), (b[0], "b0", (h0,)),
                           (w[1], "w1", (h0, h1)), (b[1], "b1", (h1,)),
                           (w[2], "w2", (h1, 1)), (b[2], "b2", (1,))):
        _lib.require(t, name, dev, shape)
    return w, b


def check_rows_and_query(cand: torch.Tensor, query: torch.Tensor,
                         fm_dim: int):
    """cand (M, D) f32; query (M, D) or a shared (D,) row, same device."""
    _lib.require(cand, "cand", cand.device, (None, None))
    M, D = cand.shape
    if not 0 < fm_dim < D:
        raise ValueError(f"fm_dim={fm_dim} must lie in (0, D={D})")
    q_shape = (D,) if query.dim() == 1 else (M, D)
    _lib.require(query, "query", cand.device, q_shape)
    return M, D


def deepfm_score(cand: torch.Tensor, query: torch.Tensor, mlp_params: dict,
                 fm_dim: int = 8) -> torch.Tensor:
    """cand: (M, D) candidate rows; query: (M, D) rows or one shared (D,)
    row (read in place by the kernel, never broadcast into an (M, D) copy);
    mlp_params: {'w': [w0, w1, w2], 'b': [b0, b1, b2]}. Returns (M,) f32."""
    M, D = check_rows_and_query(cand, query, fm_dim)
    w, b = check_deepfm_mlp(mlp_params, 2 * (D - fm_dim))
    if w[0].device != cand.device:
        raise ValueError(f"weights on {w[0].device}, rows on {cand.device}")
    if cand.device.type == "cpu":
        q = query.expand(M, D) if query.dim() == 1 else query
        return _lib.cpu_row_blocks(
            lambda c, qq: deepfm_score_ref(c, qq, w[0], b[0], w[1], b[1],
                                           w[2], b[2], fm_dim), cand, q)
    if cand.device.type != "cuda":
        raise ValueError(f"deepfm_score: no kernel for {cand.device}")
    check_deepfm_plan(deepfm_score_plan, "score", D, fm_dim, w[0].shape[1],
                      w[1].shape[1])
    out = torch.empty((M,), dtype=torch.float32, device=cand.device)
    lib = _lib.load()
    rc = lib.deepfm_score_f32(
        cand.data_ptr(), query.data_ptr(), int(query.dim() == 1),
        w[0].data_ptr(), b[0].data_ptr(), w[1].data_ptr(), b[1].data_ptr(),
        w[2].data_ptr(), b[2].data_ptr(), out.data_ptr(),
        M, D, fm_dim, w[0].shape[1], w[1].shape[1],
        _lib.stream_of(cand.device))
    _lib.check(rc, "deepfm_score")
    deepfm_score.launches += 1
    return out


deepfm_score.launches = 0
