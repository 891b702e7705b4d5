"""Wrapper of the flash-decode GQA attention kernels
(``csrc/decode_attn.cu``): checks its arguments, launches a kernel for
CUDA tensors, and uses the plain version only for CPU tensors.

Two chunk kernels share the split and the merge, chosen by the cache's
dtype and the head width alone (``kernel_path``): a bfloat16 cache at
hd >= 16 runs on the tensor cores (mma.sync fed by a cp.async ring, P and
a float32 q split into bf16 hi + lo); a float32 cache (TF32 stays off) and
bfloat16 at hd = 8, under mma's k16 depth, run on the CUDA cores.
``decode_attention.path_launches`` counts the launches of each.

The kernels run behind a ``torch.library`` custom op,
``torch.ops.repro_torch.decode_attention``, so a decode step also runs on
``meta`` tensors (its fake implementation gives the output's shape and
dtype, and launches nothing) and ``torch.utils.flop_counter`` counts its
work, ``decode_flops``, on ``meta``, CPU and CUDA tensors alike."""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _lib
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128)   # the kernels' compiled head widths
TC_HEAD_DIMS = (16, 32, 64, 128)   # bf16 widths on the tensor cores
MAX_GROUP = 16                     # query heads per kv head (csrc kMaxG)
TILE = 128                         # chunk granule (csrc kDecTile; kTcTile
                                   # = 64 divides it)
BLOCKS_PER_SM = 16                 # the split's target occupancy


def kernel_path(cache_dtype: torch.dtype, hd: int) -> str:
    """Which chunk kernel a CUDA call launches: ``"tensor_core"`` or
    ``"cuda_core"``."""
    if cache_dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _tc_resident(index: int, hd: int, q_f32: bool) -> int:
    """Blocks of the tensor-core chunk kernel at ``hd`` that fit on one SM
    of card ``index`` at once, as the CUDA occupancy calculator counts them
    (2 at hd = 128, 104 KB of shared memory each). With few (batch, kv
    head) rows ``split`` fills exactly one wave of them: at long_500k
    (hd = 128) one wave, 64 chunks, took 0.38 ms, 512 chunks 0.50 and 1.3
    waves 0.49-0.54 (PERF.md §6, runs P2-P8); only hd = 128 was timed."""
    with torch.cuda.device(index):
        n = _lib.load().decode_attention_tc_resident(hd, int(q_f32))
    if n < 1:
        raise RuntimeError(f"decode_attention: no resident count of the "
                           f"tensor-core kernel at hd={hd} on cuda:{index}")
    return n


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chunking(T: int, n_chunks: int):
    """(chunk, n_chunks): T cut into at most ``n_chunks`` runs of positions,
    each a multiple of TILE long, and how many runs that makes."""
    chunk = max(1, _cdiv(_cdiv(T, n_chunks), TILE)) * TILE
    return chunk, max(1, _cdiv(T, chunk))


def split(B: int, KV: int, T: int, sms: int, resident: int = 0):
    """(chunk, n_chunks) per (batch, kv head) such that B * KV * n_chunks
    is about BLOCKS_PER_SM blocks per SM, with no chunk shorter than one
    tile; with ``resident`` (blocks that fit on an SM at once) and fewer
    rows than one wave of them, exactly one wave instead."""
    if resident and B * KV < resident * sms:
        n = resident * sms // (B * KV)
    else:
        n = _cdiv(BLOCKS_PER_SM * sms, B * KV)
    return chunking(T, max(1, min(n, _cdiv(T, TILE))))


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"decode_attention: q must be (B, H, hd) and k/v "
                         f"(B, T, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.dtype not in _lib.DTYPE:
        raise TypeError(f"decode_attention: cache dtype {k.dtype}, expected "
                        f"float32 or bfloat16")
    if q.dtype not in (torch.float32, k.dtype):
        raise TypeError(f"decode_attention: q dtype {q.dtype}, expected "
                        f"float32 or the cache's {k.dtype}")
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"fit the cache {tuple(k.shape)}")
    _lib.require(v, "v", k.device, tuple(k.shape), k.dtype)
    if q.device != k.device:
        raise ValueError(f"decode_attention: q on {q.device}, cache on "
                         f"{k.device}")
    return B, H, hd, T, KV


def _launch(q, k, v, length, n_chunks=None):
    """Launch the chunk and merge kernels; returns (out, path). No launch
    count: the public wrapper counts. ``n_chunks`` None splits T as
    ``split`` says."""
    B, H, hd, T, KV = _check(q, k, v)
    dev = k.device
    G = H // KV
    if hd not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"decode_attention: the kernel takes hd in "
                         f"{HEAD_DIMS} and at most {MAX_GROUP} query heads "
                         f"per kv head, got hd={hd}, G={G}")
    _lib.require(q, "q", dev, (B, H, hd), q.dtype)
    _lib.require(k, "k", dev, (B, T, KV, hd), k.dtype)
    if k.data_ptr() % 16 or v.data_ptr() % 16 or q.data_ptr() % 8:
        raise ValueError("decode_attention: the cache must be 16-byte "
                         "aligned and q 8-byte aligned")
    if isinstance(length, torch.Tensor):
        if length.numel() != 1 or length.dtype != torch.int32 \
                or length.device != dev:
            raise ValueError(f"decode_attention: length must be an int or a "
                             f"one-element int32 tensor on {dev}")
        len_ptr, len_val = length.data_ptr(), 0
    else:
        len_ptr, len_val = None, int(length)
    path = kernel_path(k.dtype, hd)
    if n_chunks is None:
        index = dev.index or 0
        chunk, n_chunks = split(
            B, KV, T, _sm_count(index),
            _tc_resident(index, hd, q.dtype == torch.float32)
            if path == "tensor_core" else 0)
    else:
        chunk, n_chunks = chunking(T, n_chunks)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    part_acc = torch.empty((B, KV, n_chunks, G, hd), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((B, KV, n_chunks, G, 2), dtype=torch.float32,
                          device=dev)
    lib = _lib.load()
    args = (len_ptr, len_val, B, T, KV, G, hd, chunk, n_chunks,
            part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
            _lib.stream_of(dev))
    q_f32 = int(q.dtype == torch.float32)
    if path == "tensor_core":
        rc = lib.decode_attention_tc(q.data_ptr(), q_f32, k.data_ptr(),
                                     v.data_ptr(), *args)
    else:
        rc = lib.decode_attention(q.data_ptr(), q_f32, k.data_ptr(),
                                  v.data_ptr(), _lib.DTYPE[k.dtype], *args)
    _lib.check(rc, f"decode_attention ({path})")
    return out, path


def decode_flops(B: int, H: int, hd: int, keys: int) -> int:
    """q·k and p·v over ``keys`` cache positions: 2 x 2 x hd FLOPs a key
    and query head."""
    return 4 * B * H * hd * keys


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length, block_t: int = 512) -> torch.Tensor:
    """q: (B, H, hd) float32 or in the cache's dtype; k/v: (B, T, KV, hd)
    cache, float32 or bfloat16; length: int, or a one-element int32
    tensor on the cache's device (read there, so a decode loop never syncs
    the host): the valid prefix, clamped to [0, T]. Returns (B, H, hd)
    float32; an empty prefix gives zeros.

    ``block_t`` is kept from the JAX signature; on the card the kernels
    choose their own tiles and split T across blocks."""
    del block_t
    if k.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"decode_attention: no kernel for {k.device}")
    if k.device.type != "cuda":
        _check(q, k, v)
    if isinstance(length, torch.Tensor):
        return torch.ops.repro_torch.decode_attention(q, k, v, length, 0)
    return torch.ops.repro_torch.decode_attention(q, k, v, None,
                                                  int(length))


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length: Optional[torch.Tensor],
               length_value: int) -> torch.Tensor:
    """The op behind ``decode_attention``: the valid prefix is ``length``
    (a tensor read on the device) or, where that is None, the host int
    ``length_value``. The plain version for CPU tensors, a kernel for CUDA
    tensors."""
    ln = length_value if length is None else length
    if k.device.type == "cpu":
        return decode_attention_ref(q, k, v, ln)
    out, path = _launch(q, k, v, ln)
    decode_attention.launches += 1
    decode_attention.path_launches[path] += 1
    return out


@_decode_op.register_fake
def _decode_fake(q, k, v, length, length_value):
    return q.new_empty(q.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.decode_attention,
                       get_raw=True)
def _decode_flop_formula(q, k, v, length, length_value, *args,
                         out_val=None, **kwargs) -> int:
    """A host int prefix counts its keys; a prefix in a tensor cannot be
    read without a host sync (and has no value on ``meta``), so it counts
    all T positions of the cache, the most the call can read: the same
    count on ``meta``, CPU and CUDA tensors."""
    B, H, hd = q.shape
    T = k.shape[1]
    keys = T if length is not None else min(max(length_value, 0), T)
    return decode_flops(B, H, hd, keys)


decode_attention.launches = 0
decode_attention.path_launches = {"tensor_core": 0, "cuda_core": 0}


def _register_sharding():
    """DTensor arguments: the batch (dim 0 of q, k, v and the output)
    shards, the kernel runs on each rank's rows; a sharded cache position
    or head is gathered first (what XLA does around a Pallas call it
    cannot partition). ``length`` is replicated."""
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.decode_attention.default)
    def _decode_sharding(q, k, v, length, length_value):
        ln = None if length is None else Replicate()
        return [([p], [p, p, p, ln, None]) for p in (Replicate(),
                                                      Shard(0))]


_register_sharding()
