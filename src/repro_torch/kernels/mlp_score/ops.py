"""Wrapper of the MLP-measure scoring kernel (``csrc/mlp_score.cu``):
checks its arguments, launches the kernel for CUDA tensors, and uses the
plain version only for CPU tensors. The network checks and the admission
rule (which networks the kernels take) live here for all four MLP
kernels."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.mlp_score.ref import mlp_score_ref

MAX_LAYERS = 8          # kMaxMLPLayers in csrc/mlp.cuh
WARPS_PER_BLOCK = 8     # kMLPAdmitWarps in csrc/mlp.cuh
GENERIC = ("force the generic stages via EngineOptions(measure_impl='vmap', "
           "grad_impl='vmap')")


def check_mlp(mlp_params: dict, d_x: int, d_q: int, device):
    """The MLP kernels take 1 to MAX_LAYERS dense layers with chained
    widths from d_x + d_q down to a last layer of width 1, float32 on
    ``device``; anything else raises. Returns (w, b) lists."""
    w, b = list(mlp_params["w"]), list(mlp_params["b"])
    if len(w) != len(b) or not 1 <= len(w) <= MAX_LAYERS:
        raise ValueError(
            f"the mlp kernels take 1 to {MAX_LAYERS} layers with one bias "
            f"each, got {len(w)} weights and {len(b)} biases; {GENERIC}")
    d = d_x + d_q
    for i, (wi, bi) in enumerate(zip(w, b)):
        _lib.require(wi, f"w{i}", device, (d, None))
        d = wi.shape[1]
        _lib.require(bi, f"b{i}", device, (d,))
    if d != 1:
        raise ValueError(f"the last mlp layer must have width 1 (the "
                         f"measure is sigmoid(h[:, 0])), got {d}")
    return w, b


def mlp_dims(w) -> list:
    """[d_in, h_1, ..., 1]: the layer widths of ``w``."""
    return [w[0].shape[0]] + [t.shape[1] for t in w]


def mlp_smem_bytes(dims, d_x: int) -> int:
    """The admission rule's bytes (mirrors ``mlp_net`` and
    ``mlp_smem_bytes`` in csrc/mlp.cuh): the layout of the port's first
    MLP kernels, one block staging every hidden layer's weights padded to
    cols + 1 plus its bias, the last layer's vector and bias, then per
    warp of 8 the input, every hidden pre-activation, two gradient buffers
    of the widest hidden layer and the row slice. The kernels' cluster
    body needs less per CTA for every network this admits
    (``mlp_grad_plan``, ``mlp_score_plan``)."""
    L = len(dims) - 1
    weights = sum(dims[i] * (dims[i + 1] + 1) + dims[i + 1]
                  for i in range(L - 1)) + dims[L - 1] + 1
    hidden = dims[1:L]
    scratch = sum(dims[:L]) + 2 * max(hidden, default=0) + d_x
    return 4 * (weights + WARPS_PER_BLOCK * scratch)


def net_args(w, b, d_x: int, device):
    """The network as the C entry points take it: (ws, bs, dims, L) as
    ctypes arrays. Raises if the admission rule (``mlp_smem_bytes``)
    does not fit the card's opt-in shared memory."""
    dims = mlp_dims(w)
    need, have = mlp_smem_bytes(dims, d_x), _lib.smem_optin(device.index)
    if need > have:
        raise ValueError(f"the mlp kernels take networks whose one-block "
                         f"layout fits shared memory: {need} bytes for "
                         f"widths {dims}, but {device} allows {have}; "
                         f"{GENERIC}")
    L = len(w)
    return ((ctypes.c_void_p * L)(*[t.data_ptr() for t in w]),
            (ctypes.c_void_p * L)(*[t.data_ptr() for t in b]),
            (ctypes.c_int * (L + 1))(*dims), L)


def check_rows_and_query(cand: torch.Tensor, query: torch.Tensor):
    """cand (M, Dx) f32; query (M, Dq) rows or a shared (Dq,) row, same
    device. Returns (M, Dx, Dq)."""
    _lib.require(cand, "cand", cand.device, (None, None))
    M, Dx = cand.shape
    if query.dim() == 1:
        _lib.require(query, "query", cand.device, (None,))
    else:
        _lib.require(query, "query", cand.device, (M, None))
    return M, Dx, query.shape[-1]


def mlp_score(cand: torch.Tensor, query: torch.Tensor,
              mlp_params: dict) -> torch.Tensor:
    """cand: (M, Dx) candidate rows; query: (M, Dq) rows or one shared
    (Dq,) row (read in place by the kernel, never broadcast into an
    (M, Dq) copy); mlp_params: {'w': [...], 'b': [...]}, any depth up to
    MAX_LAYERS. Returns (M,) f32 = sigmoid(MLP([x, q]))."""
    M, Dx, Dq = check_rows_and_query(cand, query)
    w, b = check_mlp(mlp_params, Dx, Dq, cand.device)
    if cand.device.type == "cpu":
        q = query.expand(M, Dq) if query.dim() == 1 else query
        return _lib.cpu_row_blocks(lambda c, qq: mlp_score_ref(c, qq, w, b),
                                   cand, q)
    if cand.device.type != "cuda":
        raise ValueError(f"mlp_score: no kernel for {cand.device}")
    net = net_args(w, b, Dx, cand.device)
    out = torch.empty((M,), dtype=torch.float32, device=cand.device)
    rc = _lib.load().mlp_score_f32(
        cand.data_ptr(), query.data_ptr(), int(query.dim() == 1), *net,
        out.data_ptr(), M, Dx, Dq, _lib.stream_of(cand.device))
    _lib.check(rc, "mlp_score")
    mlp_score.launches += 1
    return out


mlp_score.launches = 0
