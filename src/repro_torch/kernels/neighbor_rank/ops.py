"""Wrapper of the gradient-ranking kernel (``csrc/neighbor_rank.cu``):
checks its arguments, launches the kernel for CUDA tensors, and uses the
plain version only for CPU tensors. ``neighbor_rank_plan`` gives the
launch layout of the rank pair's body (``csrc/neighbor_rank.cuh``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.neighbor_rank.ref import neighbor_rank_ref

RANK_BY = ("angle", "projection")

# the plan's constants (csrc/neighbor_rank.cuh)
RANK_MAX_THREADS = 1024     # kRankMaxThreads: threads per CTA at most
RANK_ELEMS = 10             # kRankElems: row columns per thread aimed at
RANK_LANES = 1              # kRankLanes: lanes per CTA
RANK_MAX_COLS = 1024        # kRankMaxCols: columns per chunk at most
RANK_ROW_FLOATS = 16384     # kRankRowFloats: staged row floats per CTA


def _align(v: int, a: int) -> int:
    return -(-v // a) * a


def neighbor_rank_plan(B: int, D: int) -> dict:
    """The launch layout of a call with B neighbors of width D
    (``neighbor_rank_plan`` and ``rank_plan_at`` in csrc/neighbor_rank.cuh):
    G threads per row, the fewest (a power of two up to 32) that leave each
    at most RANK_ELEMS columns; RANK_LANES lanes per CTA; rows per pass of
    a lane, columns per chunk (multiples of max(G, 4)), floats per staged
    row (one unit more where an even number of units would put the rows a
    warp reads on the same banks), threads, shared memory per CTA (the
    pass's rows, x and g of a chunk, the ids and the rows' scales per lane,
    a partial per warp), and the passes over B and chunks over D."""
    G, lanes = 1, RANK_LANES
    while G < 32 and G * RANK_ELEMS < D:
        G *= 2
    unit = max(G, 4)
    cols = min(_align(D, unit), RANK_MAX_COLS)
    pitch = cols + unit if G < 32 and cols // unit % 2 == 0 else cols
    rows = min(B, RANK_MAX_THREADS // (lanes * G),
               RANK_ROW_FLOATS // (lanes * pitch))
    lane_threads = _align(rows * G, 32)
    threads = lanes * lane_threads
    floats = lanes * (rows * pitch + 2 * cols + 3 * rows) + threads // 32
    return {"threads_per_row": G, "lanes": lanes, "rows": rows,
            "cols": cols, "pitch": pitch, "threads": threads,
            "smem_bytes": 4 * floats, "passes": -(-B // rows),
            "chunks": -(-D // cols)}


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
        return _lib.cpu_row_blocks(
            lambda *a: neighbor_rank_ref(*a, alpha, rank_by),
            x, grad, nvecs, valid)
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
