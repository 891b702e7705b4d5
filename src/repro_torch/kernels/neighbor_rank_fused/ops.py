"""Wrapper of the index-fused gradient-ranking kernel
(``csrc/neighbor_rank_fused.cu``): checks its arguments, launches the
kernel for a store on the card, and uses the plain version only for a store
on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.neighbor_rank.ops import RANK_BY
from repro_torch.kernels.neighbor_rank_fused.ref import neighbor_rank_fused_ref


def neighbor_rank_fused(x, grad, store, idx, valid, alpha: float = 1.01,
                        rank_by: str = "angle"):
    """Batched Eq. 3/4 ranking straight off the resident corpus. x, grad:
    (Q, D) f32; store: ``CorpusStore``; idx: (Q, B) int64 neighbor ids (-1
    padding is clamped to 0 in the kernel, and masked by ``valid``); valid:
    (Q, B) bool. Returns (key (Q, B) f32, in_range (Q, B) bool)."""
    if rank_by not in RANK_BY:
        raise ValueError(f"rank_by must be one of {RANK_BY}, got {rank_by!r}")
    dev = store.device
    _lib.require(idx, "idx", dev, (None, None), dtype=torch.int64)
    Q, B = idx.shape
    D = store.dim
    _lib.require(x, "x", dev, (Q, D))
    _lib.require(grad, "grad", dev, (Q, D))
    _lib.require(valid, "valid", dev, (Q, B), dtype=torch.bool)
    if dev.type == "cpu":
        return _lib.cpu_row_blocks(
            lambda xx, g, i, v: neighbor_rank_fused_ref(xx, g, store, i, v,
                                                        alpha, rank_by),
            x, grad, idx, valid)
    if dev.type != "cuda":
        raise ValueError(f"neighbor_rank_fused: no kernel for {dev}")
    key = torch.empty((Q, B), dtype=torch.float32, device=dev)
    mask = torch.empty((Q, B), dtype=torch.bool, device=dev)
    data, scales, residency = _lib.corpus_args(store)
    rc = _lib.load().neighbor_rank_fused(
        x.data_ptr(), grad.data_ptr(), data, scales, idx.data_ptr(),
        residency, valid.data_ptr(), key.data_ptr(), mask.data_ptr(), Q, B, D,
        float(alpha), int(rank_by == "angle"), _lib.stream_of(dev))
    _lib.check(rc, "neighbor_rank_fused")
    neighbor_rank_fused.launches += 1
    return key, mask


neighbor_rank_fused.launches = 0
