"""Wrapper of the gradient-ranking kernel (``csrc/neighbor_rank.cu``):
checks its arguments, launches the kernel for CUDA tensors, and uses the
plain version only for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.neighbor_rank.ref import neighbor_rank_ref

RANK_BY = ("angle", "projection")


def neighbor_rank(x, grad, nvecs, valid, alpha: float = 1.01,
                  rank_by: str = "angle"):
    """Batched Eq. 3/4 ranking. x, grad: (Q, D) f32; nvecs: (Q, B, D) f32;
    valid: (Q, B) bool. Returns (key (Q, B) f32, in_range (Q, B) bool)."""
    if rank_by not in RANK_BY:
        raise ValueError(f"rank_by must be one of {RANK_BY}, got {rank_by!r}")
    _lib.require(nvecs, "nvecs", nvecs.device, (None, None, None))
    Q, B, D = nvecs.shape
    dev = nvecs.device
    _lib.require(x, "x", dev, (Q, D))
    _lib.require(grad, "grad", dev, (Q, D))
    _lib.require(valid, "valid", dev, (Q, B), dtype=torch.bool)
    if dev.type == "cpu":
        return neighbor_rank_ref(x, grad, nvecs, valid, alpha, rank_by)
    if dev.type != "cuda":
        raise ValueError(f"neighbor_rank: no kernel for {dev}")
    key = torch.empty((Q, B), dtype=torch.float32, device=dev)
    mask = torch.empty((Q, B), dtype=torch.bool, device=dev)
    lib = _lib.load()
    rc = lib.neighbor_rank_f32(
        x.data_ptr(), grad.data_ptr(), nvecs.data_ptr(), valid.data_ptr(),
        key.data_ptr(), mask.data_ptr(), Q, B, D, float(alpha),
        int(rank_by == "angle"), _lib.stream_of(dev))
    _lib.check(rc, "neighbor_rank")
    neighbor_rank.launches += 1
    return key, mask


neighbor_rank.launches = 0
