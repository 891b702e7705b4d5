"""Decoder-only transformer family (dense GQA + optional MoE FFN): the JAX
package's ``models/transformer.py`` in PyTorch over the JAX parameter
tree.

Covers yi-9b / starcoder2-3b (llama-style), command-r-plus (parallel
block, qk-norm), granite-moe (MoE FFN). DeepSeek-V3 (MLA) is not ported
yet.

- Params for the repeated layer stack are stacked along a leading
  ``layers`` dim (the JAX tree, so ``tree.tree_from_jax`` carries a JAX
  init across unchanged); the forward walks the layers in a Python loop,
  each under ``torch.utils.checkpoint`` when ``cfg.remat`` and autograd
  is recording (the JAX ``scan`` + remat: less memory, the same numbers).
- Every init returns ``(params, axes)``.
- KV caches are stacked per layer: ``{'k': (L, B, T, KV, hd), 'v': ...}``.

Attention, the rule of this module (not a fallback): the two inference
entry points run the port's attention kernels, which have no backward
(neither have the JAX Pallas kernels); the training forward runs the
plain autograd attention.

- ``prefill``: causal attention over the expanded heads through
  ``kernels.flash_attn.flash_attention`` (float32 out, cast to the
  compute dtype). It computes what JAX's ``mha_attention`` under
  ``causal_mask(S)`` and ``chunked_causal_mha`` compute.
- ``decode_step``: the new k/v written into the cache at ``pos`` in place
  (``index_copy_`` with ``pos`` on the device: no host sync; JAX returns
  a new cache), then one position against the cache through
  ``kernels.decode_attn.decode_attention`` with ``length = pos + 1``.
  The cache branch takes S = 1 only.
- ``forward`` / ``lm_loss``: ``layers.mha_attention`` under the causal
  mask, or ``layers.chunked_causal_mha`` when ``attn_chunk`` is set.

On a CPU tensor both kernels' wrappers run their plain versions, so the
same code serves both devices. ``prefill`` and ``decode_step`` run under
``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.kernels.decode_attn import decode_attention
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "transformer"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 256
    vocab_size: int = 512
    head_dim: int = 32
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    use_bias: bool = False
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    mlp_type: str = "swiglu"         # swiglu | gelu
    parallel_block: bool = False      # command-r style
    qk_norm: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    param_dtype: object = None        # e.g. torch.float8_e4m3fn for serving
                                      # (weights stored narrow, cast to
                                      # dtype at use)
    # MoE (granite)
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 16              # hierarchical dispatch groups
    moe_impl: str = "scatter"         # scatter | ep (ep needs a mesh: on one
                                      # device both run moe_ffn, as in JAX)
    attn_chunk: int = 0               # >0: chunked-causal attention
    remat: bool = True

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device="cuda") -> Tuple[dict, dict]:
    """(params, axes) in the JAX tree: N(0, 1/fan_in) matrices, unit norm
    scales, zero biases, in ``cfg.param_dtype or cfg.dtype``, drawn layer
    by layer from ``generator`` (on its device; a generator on the card
    draws Yi-9B's 8.8e9 parameters there)."""
    dev = resolve_device(device)
    H, KV, hd, d, ff, Lx = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                            cfg.d_model, cfg.d_ff, cfg.n_layers)
    dt = cfg.param_dtype or cfg.dtype

    def stack(*shape):
        return L.stacked_normal(generator, Lx, shape,
                                1.0 / math.sqrt(shape[0]), dt, dev)

    def const(value, *shape):
        return torch.full(shape, value, dtype=torch.float32,
                          device=dev).to(dt)

    attn = {"wq": stack(d, H * hd), "wk": stack(d, KV * hd),
            "wv": stack(d, KV * hd), "wo": stack(H * hd, d)}
    attn_axes = {"wq": ("layers", "embed", "heads"),
                 "wk": ("layers", "embed", "kv_heads"),
                 "wv": ("layers", "embed", "kv_heads"),
                 "wo": ("layers", "heads", "embed")}
    if cfg.qk_norm:
        attn["q_norm"] = const(1.0, Lx, hd)
        attn["k_norm"] = const(1.0, Lx, hd)
        attn_axes["q_norm"] = ("layers", None)
        attn_axes["k_norm"] = ("layers", None)

    if cfg.is_moe:
        mlp, mlp_axes = moe_lib.init_moe(
            generator, n_layers=Lx, d_model=d, d_ff=cfg.moe_d_ff,
            n_experts=cfg.n_experts, dtype=dt, device=dev)
    elif cfg.mlp_type == "swiglu":
        mlp = {"w_gate": stack(d, ff), "w_up": stack(d, ff),
               "w_down": stack(ff, d)}
        mlp_axes = {"w_gate": ("layers", "embed", "mlp"),
                    "w_up": ("layers", "embed", "mlp"),
                    "w_down": ("layers", "mlp", "embed")}
    else:  # gelu (starcoder2)
        mlp = {"w_up": stack(d, ff), "b_up": const(0.0, Lx, ff),
               "w_down": stack(ff, d), "b_down": const(0.0, Lx, d)}
        mlp_axes = {"w_up": ("layers", "embed", "mlp"),
                    "b_up": ("layers", "mlp"),
                    "w_down": ("layers", "mlp", "embed"),
                    "b_down": ("layers", "embed")}

    norms = {"ln1": const(1.0, Lx, d)}
    norm_axes = {"ln1": ("layers", "embed")}
    if not cfg.parallel_block:
        norms["ln2"] = const(1.0, Lx, d)
        norm_axes["ln2"] = ("layers", "embed")
    if cfg.norm_type == "layernorm":
        norms["ln1_b"] = const(0.0, Lx, d)
        norm_axes["ln1_b"] = ("layers", "embed")
        if not cfg.parallel_block:
            norms["ln2_b"] = const(0.0, Lx, d)
            norm_axes["ln2_b"] = ("layers", "embed")

    V_pad = L.pad_vocab(cfg.vocab_size)
    params = {
        "embed": L.stacked_normal(generator, 1, (V_pad, d), 0.02, dt,
                                  dev)[0],
        "layers": {"attn": attn, "mlp": mlp, "norm": norms},
        "final_norm": const(1.0, d),
    }
    axes = {
        "embed": ("vocab", "embed"),
        "layers": {"attn": attn_axes, "mlp": mlp_axes, "norm": norm_axes},
        "final_norm": ("embed",),
    }
    if cfg.norm_type == "layernorm":
        params["final_norm_b"] = const(0.0, d)
        axes["final_norm_b"] = ("embed",)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.stacked_normal(
            generator, 1, (d, V_pad), 1.0 / math.sqrt(d), dt, dev)[0]
        axes["lm_head"] = ("embed", "vocab")
    return params, axes


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _norm(cfg, x, scale, bias=None):
    if cfg.norm_type == "layernorm":
        return L.layer_norm(x, scale, bias, cfg.norm_eps)
    return L.rms_norm(x, scale, cfg.norm_eps)


def _attn_block(cfg, p, x, rope, mode, cache_kv=None, slot=None,
                length=None):
    """x: (B, S, d); rope: ``layers.rope_angles`` of the positions.
    Returns (out, (k, v)): the new k/v entries at KV heads, or with
    ``cache_kv=(ck, cv)`` (``mode="decode"``) the cache after the write.

    ``mode``: "train" (plain autograd attention), "prefill" (the flash
    kernel) or "decode" (one position: the cache written at ``slot``, a
    one-element int64 tensor, then the decode kernel over ``length``)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = x.dtype
    q = (x @ p["wq"].to(cd)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(cd)).reshape(B, S, KV, hd)
    v = (x @ p["wv"].to(cd)).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.rotate(q, *rope)
    k = L.rotate(k, *rope)

    if mode == "decode":
        if S != 1:
            raise ValueError(f"decode attention takes one position, got "
                             f"S={S}")
        ck, cv = cache_kv
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        qd = q[:, 0] if q.dtype in (torch.float32, ck.dtype) else \
            q[:, 0].to(torch.float32)
        out = decode_attention(qd, ck, cv, length=length).to(cd)[:, None]
        new_kv = (ck, cv)
    else:
        # expand kv heads: q, kf, vf are (B, S, H, hd), channel dim
        # contiguous (rotate and repeat_interleave write new tensors)
        kf = L.expand_kv(k, H)
        vf = L.expand_kv(v, H)
        if mode == "prefill":
            out = flash_attention(q, kf, vf).to(cd)
        elif cfg.attn_chunk and S > cfg.attn_chunk:
            out = L.chunked_causal_mha(q, kf, vf, cfg.attn_chunk)
        else:
            out = L.mha_attention(q, kf, vf,
                                  mask=L.causal_mask(S, device=x.device))
        new_kv = (k, v)
    return out.reshape(B, S, H * hd) @ p["wo"].to(cd), new_kv


def _mlp_block(cfg, p, x):
    if cfg.is_moe:
        return moe_lib.moe_ffn(p, x, n_experts=cfg.n_experts,
                               top_k=cfg.moe_top_k,
                               capacity_factor=cfg.capacity_factor,
                               n_groups=cfg.moe_groups)
    cd = x.dtype
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"].to(cd)) * (x @ p["w_up"].to(cd))
        return h @ p["w_down"].to(cd)
    h = F.gelu(x @ p["w_up"].to(cd) + p["b_up"].to(cd), approximate="tanh")
    return h @ p["w_down"].to(cd) + p["b_down"].to(cd)


def _layer(cfg, x, p, rope, mode, cache_kv=None, slot=None, length=None):
    nb = p["norm"].get("ln1_b") if cfg.norm_type == "layernorm" else None
    h1 = _norm(cfg, x, p["norm"]["ln1"], nb)
    attn_out, new_kv = _attn_block(cfg, p["attn"], h1, rope, mode,
                                   cache_kv=cache_kv, slot=slot,
                                   length=length)
    if cfg.parallel_block:
        x = x + attn_out + _mlp_block(cfg, p["mlp"], h1)
    else:
        x = x + attn_out
        nb2 = p["norm"].get("ln2_b") if cfg.norm_type == "layernorm" else None
        h2 = _norm(cfg, x, p["norm"]["ln2"], nb2)
        x = x + _mlp_block(cfg, p["mlp"], h2)
    return x, new_kv


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``params['layers']`` (views)."""
    return tree_map(lambda t: t[i], params["layers"])


def _embed(params, tokens, cfg):
    return L.gather_rows(params["embed"].to(cfg.dtype), tokens)


def _head(params, x, cfg):
    """Final norm, the (tied) head, the vocab mask and the soft cap."""
    fb = params.get("final_norm_b") if cfg.norm_type == "layernorm" else None
    x = _norm(cfg, x, params["final_norm"], fb)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.dtype)
    logits = L.mask_pad_vocab(x @ head, cfg.vocab_size)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _rope(cfg, positions):
    return L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def forward(params: dict, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Training forward: tokens (B, S) -> logits (B, S, V_pad), plain
    autograd attention."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    rope = _rope(cfg, torch.arange(S, device=tokens.device)[None, :]
                 .expand(B, S))
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if remat:
            x = checkpoint(lambda x_, lp_: _layer(cfg, x_, lp_, rope,
                                                  "train")[0],
                           x, lp, use_reentrant=False)
        else:
            x, _ = _layer(cfg, x, lp, rope, "train")
    return _head(params, x, cfg)


@torch.no_grad()
def prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig
            ) -> Tuple[torch.Tensor, dict]:
    """Prefill pass: tokens (B, S) -> (next-token logits (B, V_pad), cache
    {'k','v': (L, B, S, KV, hd)} in the compute dtype), attention through
    the flash kernel."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    rope = _rope(cfg, torch.arange(S, device=tokens.device)[None, :]
                 .expand(B, S))
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.empty(shape, dtype=x.dtype, device=x.device),
             "v": torch.empty(shape, dtype=x.dtype, device=x.device)}
    for i in range(cfg.n_layers):
        x, (k, v) = _layer(cfg, x, layer_params(params, i), rope, "prefill")
        cache["k"][i].copy_(k)
        cache["v"][i].copy_(v)
    return _head(params, x[:, -1, :], cfg), cache


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_axes(decode_seq_shard: bool = True) -> dict:
    seq_ax = "kv_seq" if decode_seq_shard else None
    return {"k": ("layers", "batch", seq_ax, None, None),
            "v": ("layers", "batch", seq_ax, None, None)}


@torch.no_grad()
def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos,
                cfg: TransformerConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B,) ids; pos: the current length, an int
    or a one-element integer tensor (on the cache's device, a loop never
    syncs the host). Writes the new k/v into ``cache`` at ``pos`` in place
    and returns (logits (B, V_pad), cache)."""
    B = tokens.shape[0]
    dev = cache["k"].device
    pos_t = torch.as_tensor(pos, device=dev).reshape(1)
    slot = pos_t.to(torch.int64)
    length = (pos_t + 1).to(torch.int32)
    x = _embed(params, tokens, cfg)[:, None, :]                  # (B, 1, d)
    rope = _rope(cfg, slot.reshape(1, 1).expand(B, 1))
    for i in range(cfg.n_layers):
        x, _ = _layer(cfg, x, layer_params(params, i), rope, "decode",
                      cache_kv=(cache["k"][i], cache["v"][i]), slot=slot,
                      length=length)
    return _head(params, x[:, 0, :], cfg), cache


def lm_loss(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    logits = forward(params, tokens, cfg).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return torch.mean(nll)
