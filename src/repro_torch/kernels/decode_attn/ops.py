"""Wrapper of the flash-decode GQA attention kernel
(``csrc/decode_attn.cu``): checks its arguments, launches the kernel for
CUDA tensors, and uses the plain version only for CPU tensors."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128)   # the kernel's compiled head widths
MAX_GROUP = 16                     # query heads per kv head (csrc kMaxG)
TILE = 128                         # positions per tile (csrc kDecTile)
BLOCKS_PER_SM = 16                 # the split's target occupancy


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chunking(T: int, n_chunks: int):
    """(chunk, n_chunks): T cut into at most ``n_chunks`` runs of positions,
    each a multiple of TILE long, and how many runs that makes."""
    chunk = max(1, _cdiv(_cdiv(T, n_chunks), TILE)) * TILE
    return chunk, max(1, _cdiv(T, chunk))


def split(B: int, KV: int, T: int, sms: int):
    """(chunk, n_chunks) per (batch, kv head) such that B * KV * n_chunks
    is about BLOCKS_PER_SM blocks per SM, with no chunk shorter than one
    tile."""
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
    """Launch the chunk and merge kernels (no launch count; the public
    wrapper counts). ``n_chunks`` None splits T as ``split`` says."""
    B, H, hd, T, KV = _check(q, k, v)
    dev = k.device
    G = H // KV
    if hd not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"decode_attention: the kernel takes hd in "
                         f"{HEAD_DIMS} and at most {MAX_GROUP} query heads "
                         f"per kv head, got hd={hd}, G={G}")
    _lib.require(q, "q", dev, (B, H, hd), q.dtype)
    _lib.require(k, "k", dev, (B, T, KV, hd), k.dtype)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: the cache must be 16-byte "
                         "aligned")
    if isinstance(length, torch.Tensor):
        if length.numel() != 1 or length.dtype != torch.int32 \
                or length.device != dev:
            raise ValueError(f"decode_attention: length must be an int or a "
                             f"one-element int32 tensor on {dev}")
        len_ptr, len_val = length.data_ptr(), 0
    else:
        len_ptr, len_val = None, int(length)
    if n_chunks is None:
        chunk, n_chunks = split(B, KV, T, _sm_count(dev.index or 0))
    else:
        chunk, n_chunks = chunking(T, n_chunks)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    part_acc = torch.empty((B, KV, n_chunks, G, hd), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((B, KV, n_chunks, G, 2), dtype=torch.float32,
                          device=dev)
    rc = _lib.load().decode_attention(
        q.data_ptr(), int(q.dtype == torch.float32), k.data_ptr(),
        v.data_ptr(), _lib.DTYPE[k.dtype], len_ptr, len_val, B, T, KV, G, hd,
        chunk, n_chunks, part_acc.data_ptr(), part_ml.data_ptr(),
        out.data_ptr(), _lib.stream_of(dev))
    _lib.check(rc, "decode_attention")
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length, block_t: int = 512) -> torch.Tensor:
    """q: (B, H, hd) float32 or in the cache's dtype; k/v: (B, T, KV, hd)
    cache, float32 or bfloat16; length: int, or a one-element int32
    tensor on the cache's device (read there, so a decode loop never syncs
    the host): the valid prefix, clamped to [0, T]. Returns (B, H, hd)
    float32; an empty prefix gives zeros.

    ``block_t`` is kept from the JAX signature; on the card the kernel
    chooses its own tile (128 positions) and splits T across blocks."""
    del block_t
    if k.device.type == "cpu":
        _check(q, k, v)
        return decode_attention_ref(q, k, v, length)
    if k.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {k.device}")
    out = _launch(q, k, v, length)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
