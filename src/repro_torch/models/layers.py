"""Shared network building blocks: plain tensors, explicit generators.

Parameters are the JAX package's pytree layout as a dict of tensor lists,
``{'w': [W0, W1, ...], 'b': [b0, b1, ...]}`` with ``W_i`` of shape
(d_in, d_out), so ``params_from_jax`` carries weights across unchanged;
``tensor_from_jax`` carries tables and caches (float32 or bfloat16).

The attention functions are the plain counterparts of the JAX package's
model layers (q/k/v in the (B, S, heads, hd) layout); like them, they call
no kernel. ``kernels.decode_attn`` and ``kernels.flash_attn`` are held
against them.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, device="cuda") -> torch.Tensor:
    """N(0, 1) * scale with scale = 1/sqrt(d_in), drawn on the CPU from
    ``generator`` (so a seed gives the same weights on every device)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    dtype=torch.float32) * scale
    return w.to(resolve_device(device))


def init_mlp(generator: torch.Generator, dims: Sequence[int],
             device="cuda") -> dict:
    """dims = [d_in, h1, ..., d_out] -> {'w': [...], 'b': [...]}, zero
    biases."""
    dev = resolve_device(device)
    ws, bs = [], []
    for i in range(len(dims) - 1):
        ws.append(dense_init(generator, dims[i], dims[i + 1], device=dev))
        bs.append(torch.zeros((dims[i + 1],), dtype=torch.float32,
                              device=dev))
    return {"w": ws, "b": bs}


def mlp_apply(params: dict, x: torch.Tensor, act=torch.relu) -> torch.Tensor:
    """Simple MLP: ``act`` between layers, none after the last."""
    n = len(params["w"])
    for i in range(n):
        x = x @ params["w"][i] + params["b"][i]
        if i < n - 1:
            x = act(x)
    return x


VOCAB_PAD = 16  # vocab/table rows padded to a multiple of this (TP evenness)


def pad_vocab(n: int) -> int:
    return ((n + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def tensor_from_jax(a, device="cuda") -> torch.Tensor:
    """A numpy array from the JAX side -> a tensor on ``device`` with the
    same values: float32 (and integer) arrays as they are, an
    ``ml_dtypes.bfloat16`` array as ``torch.bfloat16`` with the same bits
    (through an int16 view, since numpy has no bfloat16 of its own)."""
    a = np.ascontiguousarray(a)
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16), device=dev).view(torch.bfloat16)
    return torch.tensor(a, device=dev)


# ---------------------------------------------------------------------------
# Attention (GQA): counterparts of the JAX model layers
# ---------------------------------------------------------------------------

def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, H, hd) (GQA pre-expanded). Logits in
    float32, masked entries set to -1e30, probabilities cast to
    ``v.dtype``; returns (B, S, H, hd) in v's dtype."""
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def chunked_causal_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       chunk: int, scale: Optional[float] = None
                       ) -> torch.Tensor:
    """Causal MHA, one query chunk at a time: bounds the transient logits
    to (B, H, chunk, T). Forward only (a Python loop over chunks, where
    the JAX layer scans with rematerialization). S must be a multiple of
    ``chunk``, as there."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if S % chunk:
        raise ValueError(f"chunked_causal_mha: S={S} is not a multiple of "
                         f"chunk={chunk}")
    kpos = torch.arange(T, device=q.device)
    outs = []
    for i in range(S // chunk):
        qb = q[:, i * chunk:(i + 1) * chunk]
        logits = torch.einsum("bshd,bthd->bhst", qb, k).float() * scale
        qpos = i * chunk + torch.arange(chunk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhst,bthd->bshd", probs, v))
    return torch.cat(outs, dim=1)


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, H, hd) by repeating each kv head G times."""
    return torch.repeat_interleave(k, n_heads // k.shape[2], dim=2)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention with k/v kept at KV heads. q: (B, S, H, hd);
    k/v: (B, T, KV, hd); mask broadcastable to (B, KV, G, S, T), e.g.
    (S, T) or (B, 1, 1, S, T). Returns (B, S, H, hd) in v's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, KV, G, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, hd)


def causal_mask(S: int, T: Optional[int] = None, device=DEFAULT_DEVICE
                ) -> torch.Tensor:
    """(S, T) bool on ``device`` (the card unless the caller says
    otherwise): query i (at absolute position T - S + i) attends to keys
    at positions <= its own."""
    device = resolve_device(device)
    T = T if T is not None else S
    qi = torch.arange(S, device=device)[:, None] + (T - S)
    ki = torch.arange(T, device=device)[None, :]
    return ki <= qi
