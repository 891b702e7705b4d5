"""Wrapper of the causal flash-attention forward kernel
(``csrc/flash_attn.cu``): checks its arguments, launches the kernel for
CUDA tensors, and uses the plain version only for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128)   # the kernel's compiled head widths


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """Causal attention. q/k/v: (B, S, H, hd) with equal head counts
    (expand GQA kv heads first), float32 or bfloat16, the channel dim
    contiguous (other strides are read as they are). Returns (B, S, H, hd)
    float32.

    ``block_q`` and ``block_k`` are kept from the JAX signature; on the
    card the kernel chooses its own tiles (64 x 64) and masks the ragged
    S edge itself, so any S works."""
    del block_q, block_k
    if q.dim() != 4 or q.dtype not in _lib.DTYPE:
        raise TypeError(f"flash_attention: q must be (B, S, H, hd) float32 "
                        f"or bfloat16, got {tuple(q.shape)} {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.shape != q.shape \
                or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes hd in "
                         f"{HEAD_DIMS}, got {hd}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the channel dim must be "
                         "contiguous")
    strides = (ctypes.c_longlong * 9)(*[t.stride(i) for t in (q, k, v)
                                        for i in range(3)])
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    rc = _lib.load().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _lib.DTYPE[q.dtype],
        strides, out.data_ptr(), B, S, H, hd, _lib.stream_of(q.device))
    _lib.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
