"""Wrapper of the analytic MLP-measure value+gradient kernel
(``csrc/mlp_grad.cu``): checks its arguments, launches the kernel for CUDA
tensors, and uses the plain version only for CPU tensors. ``mlp_grad_plan``
and ``mlp_score_plan`` mirror the launch layouts of the MLP kernels' body
(``csrc/mlp_grad.cuh``): a tile of rows per thread-block cluster."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.mlp_grad.ref import mlp_value_and_grad_ref
from repro_torch.kernels.mlp_score.ops import (check_mlp,
                                               check_rows_and_query,
                                               net_args)


GRAD_THREADS = 256          # kMLPGradThreads in csrc/mlp_grad.cuh
GRAD_MAX_CLUSTER = 8        # the portable cluster size
GRAD_UNITS_PER_CTA = 8      # hidden units per CTA the plan aims at
GRAD_TILE = 4               # the grad's rows per cluster
GRAD_SMEM_CAP = 232_448     # opt-in shared memory per block (H100)
GRAD_BAR_FLOATS = 32        # the exchanges' mbarriers
# the score's tile (kMLPScoreTile, kMLPScoreCluster): rows and at most CTAs
# per cluster, at every width
SCORE_TILE = 8
SCORE_CLUSTER = 4


def _align4(v: int) -> int:
    return (v + 3) & ~3


def cluster_plan(dims, d_x: int, tile: int, n_max: int, grad: bool,
                 fm: int = 0, cap: Optional[int] = GRAD_SMEM_CAP):
    """The cluster body's launch layout for widths ``dims`` = [d_x + d_q,
    h_1, ..., 1] at ``tile`` rows per cluster (mirrors
    ``mlp_cluster_plan`` in csrc/mlp_grad.cuh): n CTAs per cluster (a power
    of two from 2 to ``n_max`` with about GRAD_UNITS_PER_CTA hidden units
    each; 1 without a hidden layer), the units of each hidden layer per
    CTA (a multiple of 4), the d_x gradient columns per CTA and a CTA's
    shared memory in bytes, with the backward's buffers (``grad``) or
    without. None if that does not fit. ``fm`` > 0 plans the deep part of
    a DeepFM net with fm FM columns, whose tile also holds x[:fm] and
    q[:fm] (``deepfm_grad_plan``). ``cap=None`` returns the plan whatever
    its shared memory, for a refusal that names the bytes it would need."""
    L = len(dims) - 1
    hidden = list(dims[1:L])
    n = 1
    if L > 1:
        n = 2
        while n < n_max and n * GRAD_UNITS_PER_CTA < max(hidden):
            n *= 2
    s = [_align4(-(-h // n)) for h in hidden]
    ks = -(-d_x // n)
    floats = GRAD_BAR_FLOATS
    for i in range(L - 1):
        floats += _align4(dims[i]) * s[i] + s[i]
        if grad:
            floats += (s[i - 1] if i else _align4(ks)) * _align4(dims[i + 1])
    floats += _align4(dims[L - 1]) + _align4(1)
    if grad:
        floats += tile * (_align4(dims[0]) + 2 * sum(map(_align4, hidden)))
    else:   # rows at odd multiples of 4 floats, dense4's partial sums
        floats += tile * sum(_align4(d) | 4 for d in dims[:L])
        floats += 4 * GRAD_THREADS if hidden else 0
    floats += _align4(tile if grad else n * tile)
    if fm > 0:
        floats += 2 * tile * _align4(fm)
    if cap is not None and 4 * floats > cap:
        return None
    return {"n": n, "slices": s, "ks": ks, "smem_bytes": 4 * floats}


def mlp_grad_plan(dims, d_x: int, fm: int = 0,
                  cap: Optional[int] = GRAD_SMEM_CAP):
    """The grad kernels' plan: GRAD_TILE rows per cluster of up to
    GRAD_MAX_CLUSTER CTAs (``mlp_grad_plan`` in csrc/mlp_grad.cuh)."""
    return cluster_plan(dims, d_x, GRAD_TILE, GRAD_MAX_CLUSTER, True, fm,
                        cap)


def mlp_score_plan(dims, d_x: int):
    """The score kernels' plan (``with_score_copy`` in
    csrc/mlp_grad.cuh): SCORE_TILE rows per cluster of up to SCORE_CLUSTER
    CTAs, forward only; the plan with its ``rows``."""
    plan = cluster_plan(dims, d_x, SCORE_TILE, SCORE_CLUSTER, False)
    return None if plan is None else {**plan, "rows": SCORE_TILE}


def mlp_value_and_grad(cand: torch.Tensor, query: torch.Tensor,
                       mlp_params: dict):
    """cand: (M, Dx) item rows; query: (M, Dq) rows or one shared (Dq,)
    row; mlp_params: {'w': [...], 'b': [...]}. Returns (vals (M,) f32,
    grads (M, Dx) f32), grads = df/d cand (paper Eq. 2)."""
    M, Dx, Dq = check_rows_and_query(cand, query)
    w, b = check_mlp(mlp_params, Dx, Dq, cand.device)
    if cand.device.type == "cpu":
        q = query.expand(M, Dq) if query.dim() == 1 else query
        return _lib.cpu_row_blocks(
            lambda c, qq: mlp_value_and_grad_ref(c, qq, w, b), cand, q)
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
