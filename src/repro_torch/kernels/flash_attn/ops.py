"""Wrapper of the causal flash-attention forward kernels: checks its
arguments, launches a kernel for CUDA tensors, and uses the plain version
only for CPU tensors.

Three kernels, chosen by dtype and head width alone (``kernel_path``):
float32 runs on the tensor cores in 3xTF32 (``csrc/flash_attn_tf32.cu``,
S by wgmma and P V by mma.sync, fed by TMA; every operand split into TF32
big + small and each product taken three times, so float32 keeps its
accuracy: this is not TF32 mode, and ``allow_tf32`` stays False); bfloat16 at hd >= 16 runs on
the tensor cores (``csrc/flash_attn_tc.cu``, wgmma fed by TMA, P split
into bf16 hi + lo); bfloat16 at hd = 8, under wgmma's k16 depth, runs on
the CUDA cores (``csrc/flash_attn.cu``). ``flash_attention.path_launches``
counts the launches of each. No path falls back to another: a kernel that
refuses its inputs raises.

The kernels run behind a ``torch.library`` custom op,
``torch.ops.repro_torch.flash_attention``, so a step also runs on
``meta`` tensors (its fake implementation gives the output's shape and
dtype, and launches nothing) and ``torch.utils.flop_counter`` counts its
work, ``flash_flops``, on ``meta``, CPU and CUDA tensors alike."""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128)   # the kernels' compiled head widths
TC_HEAD_DIMS = (16, 32, 64, 128)   # bf16 widths on the tensor cores
TMA_ALIGN = 16                     # bytes: TMA's base and stride rule
# the kernels by path; the two tensor-core ones read through TMA
ENTRY = {"tensor_core_tf32": "flash_attention_tf32",
         "tensor_core": "flash_attention_tc", "cuda_core": "flash_attention"}


def kernel_path(dtype: torch.dtype, hd: int) -> str:
    """Which kernel a CUDA call launches: ``"tensor_core_tf32"`` (float32,
    3xTF32), ``"tensor_core"`` (bf16 at hd >= 16) or ``"cuda_core"``
    (bf16 at hd = 8)."""
    if dtype == torch.float32:
        return "tensor_core_tf32"
    if hd in TC_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def _strides(q, k, v):
    return (ctypes.c_longlong * 9)(*[t.stride(i) for t in (q, k, v)
                                     for i in range(3)])


def _check_tma(q, k, v):
    """The tensor-core kernels read q, k, v through TMA descriptors: each
    base 16-byte aligned and each batch, sequence and head stride a
    multiple of 16 bytes (8 bf16 or 4 float32 elements)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % TMA_ALIGN or any(
                (t.stride(i) * t.element_size()) % TMA_ALIGN
                for i in range(3)):
            raise ValueError(
                f"flash_attention: {t.dtype} {name} is read by TMA, which "
                f"needs a 16-byte-aligned base and batch/sequence/head "
                f"strides that are multiples of 16 bytes; got strides "
                f"{tuple(t.stride())} at address {t.data_ptr():#x}")


def flash_flops(B: int, S: int, H: int, hd: int) -> int:
    """The causal work: q·k and p·v over the S(S+1)/2 (query, key) pairs
    at or below the diagonal, 2 x 2 x hd FLOPs a pair and head."""
    return 4 * B * H * hd * (S * (S + 1) // 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """Causal attention. q/k/v: (B, S, H, hd) with equal head counts
    (expand GQA kv heads first), float32 or bfloat16, the channel dim
    contiguous (other strides are read as they are). Returns (B, S, H, hd)
    float32.

    ``block_q`` and ``block_k`` are kept from the JAX signature; on the
    card the kernels choose their own tiles and mask the ragged S edge
    themselves, so any S works."""
    del block_q, block_k
    if q.dim() != 4 or q.dtype not in _lib.DTYPE:
        raise TypeError(f"flash_attention: q must be (B, S, H, hd) float32 "
                        f"or bfloat16, got {tuple(q.shape)} {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.shape != q.shape \
                or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return torch.ops.repro_torch.flash_attention(q, k, v)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _flash_op(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """The op behind ``flash_attention`` (arguments checked there): the
    plain version for CPU tensors, a kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernels take hd in "
                         f"{HEAD_DIMS}, got {hd}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the channel dim must be "
                         "contiguous")
    path = kernel_path(q.dtype, hd)
    if path != "cuda_core":
        _check_tma(q, k, v)
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    rc = getattr(_lib.load(), ENTRY[path])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v),
        out.data_ptr(), B, S, H, hd, _lib.stream_of(q.device))
    _lib.check(rc, f"flash_attention ({path})")
    flash_attention.launches += 1
    flash_attention.path_launches[path] += 1
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v):
    return q.new_empty(q.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flop_formula(q_shape, k_shape, v_shape, *args, out_shape=None,
                        **kwargs) -> int:
    return flash_flops(*q_shape)


flash_attention.launches = 0
flash_attention.path_launches = {path: 0 for path in ENTRY}


def _register_sharding():
    """DTensor arguments: batch (dim 0) and heads (dim 2) shard, the
    kernel runs on each rank's (B, S, H, hd) block; a sharded S or hd is
    gathered first (what XLA does around a Pallas call it cannot
    partition)."""
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _flash_sharding(q, k, v):
        return [([p], [p, p, p]) for p in (Replicate(), Shard(0),
                                            Shard(2))]


_register_sharding()
