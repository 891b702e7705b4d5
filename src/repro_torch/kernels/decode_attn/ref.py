"""Plain PyTorch version of the flash-decode GQA attention kernel
(counterpart of the JAX package's ``kernels/decode_attn/ref.py``), with the
Pallas kernel's semantics where the two differ: an empty prefix
(``length`` <= 0) gives zeros, not NaN, and ``length`` > T acts as T."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length) -> torch.Tensor:
    """q: (B, H, hd) single-position queries; k/v: (B, T, KV, hd) cache;
    length: int or 0-d/one-element int tensor (read on the device, no host
    sync): the valid prefix. Returns (B, H, hd) float32: softmax over the
    prefix in float32, ``acc / max(l, 1e-30)``."""
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    logits = torch.einsum("bkgh,btkh->bkgt", qg, k.float()) / math.sqrt(hd)
    length = torch.as_tensor(length, device=q.device).reshape(())
    mask = torch.arange(T, device=q.device) < length
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(logits - m)                 # exp(-inf) = 0 where masked
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkh->bkgh", p, v.float()) / l.clamp_min(1e-30)
    return out.reshape(B, H, hd)
