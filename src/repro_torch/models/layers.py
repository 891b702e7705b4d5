"""Shared network building blocks: plain tensors, explicit generators.

Parameters are the JAX package's pytree layout as a dict of tensor lists,
``{'w': [W0, W1, ...], 'b': [b0, b1, ...]}`` with ``W_i`` of shape
(d_in, d_out), so ``params_from_jax`` carries weights across unchanged;
``tensor_from_jax`` carries tables and caches (float32, bfloat16 or
float8_e4m3fn).

The LM layers (``rms_norm``, ``rope_freqs``, ``apply_rope``, ``swiglu``)
and the attention functions are the plain counterparts of the JAX
package's model layers (q/k/v in the (B, S, heads, hd) layout); like
them, they call no kernel. ``kernels.decode_attn`` and
``kernels.flash_attn`` are held against them, and
``models/transformer.py`` calls those kernels where it needs no gradient.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import DEFAULT_DEVICE, resolve_device


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, device="cuda") -> torch.Tensor:
    """N(0, 1) * scale with scale = 1/sqrt(d_in), drawn on the generator's
    device from ``generator`` (a CPU generator gives the same weights on
    every device), then moved to ``device``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    dtype=torch.float32, device=generator.device) * scale
    return w.to(resolve_device(device))


def embed_init(generator: torch.Generator, n: int, d: int,
               scale: float = 0.02, device="cuda") -> torch.Tensor:
    """An (n, d) table of N(0, 1) * scale, drawn as ``dense_init`` draws (a
    generator on the card draws a table of billions of elements there)."""
    return dense_init(generator, n, d, scale=scale, device=device)


def stacked_normal(generator: torch.Generator, n_layers: int, shape,
                   scale: float, dtype, device) -> torch.Tensor:
    """(n_layers, *shape) of N(0, 1) x ``scale`` in ``dtype`` on
    ``device``: each layer drawn in float32 on the generator's device and
    written into the stack, so a generator on the card draws a model of
    billions of parameters there with one layer's float32 temporary."""
    dev = resolve_device(device)
    out = torch.empty((n_layers, *shape), dtype=dtype, device=dev)
    for i in range(n_layers):
        w = torch.randn(tuple(shape), generator=generator,
                        dtype=torch.float32, device=generator.device)
        out[i].copy_(w.mul_(scale).to(dev, dtype))
    return out


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


def mask_pad_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """-1e30 on the padded vocab tail so softmax/argmax ignore it."""
    if logits.shape[-1] == vocab:
        return logits
    ok = torch.arange(logits.shape[-1], device=logits.device) < vocab
    return torch.where(ok, logits, -1e30)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in float32 (mean, biased variance, rsqrt), cast
    back to x's dtype, as the JAX layer."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32 (mean of squares, rsqrt), cast back to
    x's dtype, as the JAX layer."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32)).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=DEFAULT_DEVICE) -> torch.Tensor:
    """(head_dim / 2,) float32 inverse frequencies theta^(-2i / head_dim),
    the exponent and the power taken in float32 as in JAX."""
    expo = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=resolve_device(device)) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=expo.device), expo)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """(cos, sin) of the angles positions x freqs, each (..., seq, 1,
    head_dim / 2) float32, as ``apply_rope`` computes them. A model
    computes them once per call and rotates every layer's q and k with
    ``rotate`` (the same numbers as ``apply_rope`` in each layer)."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x's halves rotated in float32 by ``rope_angles``'s (cos, sin), cast
    back to x's dtype; the result is a new contiguous tensor."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, n_heads, head_dim); positions: broadcastable to
    (..., seq)."""
    return rotate(x, *rope_angles(positions, x.shape[-1], theta))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` whose backward sums each id's rows in a fixed order:
    the ids sorted (stable), each run of equal ids reduced in sequence
    (``torch.segment_reduce``), one write per distinct row. The default
    backward of a gather adds by atomics on the card, so duplicate ids
    would add up in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return segment_sum_rows(g, ids, ctx.n_rows), None


def segment_sum_rows(g: torch.Tensor, ids: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """(n_rows, d) zeros plus, at each distinct id, the sum of g's rows
    with that id in their original order (deterministic on every device;
    on the CPU the same sums as ``index_add_``)."""
    srt, perm = torch.sort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(srt, return_counts=True)
    sums = torch.segment_reduce(g.index_select(0, perm), "sum",
                                lengths=counts)
    out = torch.zeros((n_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_copy_(0, uniq, sums)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather (rows, d) x (...,) -> (..., d) with the deterministic
    backward of ``_GatherRows``."""
    flat = ids.reshape(-1).long()
    return _GatherRows.apply(table, flat).reshape(*ids.shape,
                                                  table.shape[1])


# ml_dtypes arrays (numpy has no such dtypes of its own) -> (an integer
# view of the same width, the torch dtype with the same bits)
_BIT_VIEWS = {"bfloat16": (np.int16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor_from_jax(a, device="cuda") -> torch.Tensor:
    """A numpy array from the JAX side -> a tensor on ``device`` with the
    same values: float32 (and integer) arrays as they are, an
    ``ml_dtypes.bfloat16`` or ``float8_e4m3fn`` array as ``torch.bfloat16``
    or ``torch.float8_e4m3fn`` with the same bits (through an int16 or
    uint8 view)."""
    a = np.ascontiguousarray(a)
    dev = resolve_device(device)
    if a.dtype.name in _BIT_VIEWS:
        view, dtype = _BIT_VIEWS[a.dtype.name]
        return torch.tensor(a.view(view), device=dev).view(dtype)
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
