"""DeepSeek-V3 (Multi-head Latent Attention, the fine-grained sigmoid MoE
with a shared expert, the MTP head): the JAX package's
``models/deepseek.py`` in PyTorch over the JAX parameter tree.

Published widths [arXiv:2412.19437]: d_model 7168, 128 heads, qk_nope 128,
qk_rope 64, v_head 128, q_lora 1536, kv_lora 512; the first 3 layers dense
(d_ff 18432), the rest MoE (1 shared + 256 routed experts of d_ff 2048,
top-8 by sigmoid affinity, renormalised, as JAX's ``moe.route``: no
group-limited routing and no balancing bias).

- Params are the JAX tree: ``dense_layers`` and ``moe_layers`` each
  stacked along a leading ``layers`` dim, ``mtp`` unstacked, so
  ``tree.tree_from_jax`` carries a JAX init across unchanged. Every init
  returns ``(params, axes)``. The layers run in a Python loop, dense ones
  first, each under ``torch.utils.checkpoint`` when ``cfg.remat`` and
  autograd is recording (JAX's ``scan`` + remat: the same numbers).
- Every entry point takes ``rules=`` and calls ``sharding.constrain`` at
  JAX's points (see ``models/transformer.py``): the identity without a
  mesh, a redistribution of DTensors under one. ``moe_impl="ep"`` takes
  ``moe.moe_ffn_ep`` under a mesh and ``moe_ffn`` without one, as in JAX;
  the decode step's MoE is ``moe_ffn`` in one group either way.

Attention, in two forms. Both are plain products: the JAX module calls no
Pallas kernel, and neither MLA form fits the port's attention kernels
(q.k is 192 wide against v's 128; the absorbed decode is one 576-wide
latent "kv head" shared by all heads).

- ``forward``, ``lm_loss``, ``prefill``: the full MLA (``_mla_train``),
  k and v expanded from the normalised latent through ``wkv_b``, the
  rotated rope key computed once on a (B, S, 1, rr) slice and broadcast
  to the heads; ``layers.mha_attention`` under the causal mask, or
  ``layers.chunked_causal_mha`` when ``attn_chunk`` is set and S exceeds
  it (a query chunk's logits are (B, H, chunk, S) in float32: pick the
  chunk that fits; it changes no result but float32 summation order).
- ``decode_step``: the absorbed form (``_mla_decode``). The cache holds
  only the latent ``c`` (kv_lora) and the rotated rope key ``kr`` per
  token; q_nope is absorbed through ``wkv_b``'s key half into the latent
  space, and the latent output leaves through its value half. The two
  logit products are added in the compute dtype and only then cast to
  float32; the probabilities are cast to the cache dtype, as in JAX. The
  new latent and rope key are written into the cache in place
  (``index_copy_`` at ``pos`` on the device: a decode loop never syncs
  the host; JAX returns a new cache), and the same dict is returned.

The latent cache is ``{'c': (L, B, T, kv_lora), 'kr': (L, B, T, rr)}``,
dense layers first. ``prefill`` and ``decode_step`` run under
``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.sharding import (ShardingRules, constrain, gather_inner,
                                  gather_inner_grad, is_dtensor, mesh_scope,
                                  per_shard)
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class DeepSeekConfig:
    name: str = "deepseek"
    n_layers: int = 61
    n_dense_layers: int = 3
    d_model: int = 7168
    n_heads: int = 128
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    dense_d_ff: int = 18432
    moe_d_ff: int = 2048
    n_experts: int = 256
    moe_top_k: int = 8
    n_shared_experts: int = 1
    vocab_size: int = 129280
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    capacity_factor: float = 1.25
    moe_groups: int = 16
    moe_impl: str = "scatter"   # scatter | ep (all-to-all over the mesh;
                                # without one both run moe_ffn)
    attn_chunk: int = 0         # >0: chunked-causal attention
    use_mtp: bool = True
    mtp_weight: float = 0.1
    remat: bool = True

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_mla(generator, cfg: DeepSeekConfig, n_layers: int, dev):
    d, H = cfg.d_model, cfg.n_heads
    qk, rr, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = cfg.dtype

    def stack(*shape):                     # N(0, 1/fan_in), fan_in = rows
        return L.stacked_normal(generator, n_layers, shape,
                                1.0 / math.sqrt(shape[0]), dt, dev)

    params = {
        "wq_a": stack(d, cfg.q_lora_rank),
        "q_norm": torch.ones((n_layers, cfg.q_lora_rank), dtype=dt,
                             device=dev),
        "wq_b": stack(cfg.q_lora_rank, H * (qk + rr)),
        "wkv_a": stack(d, cfg.kv_lora_rank + rr),
        "kv_norm": torch.ones((n_layers, cfg.kv_lora_rank), dtype=dt,
                              device=dev),
        "wkv_b": stack(cfg.kv_lora_rank, H * (qk + vh)),
        "wo": stack(H * vh, d),
    }
    axes = {
        "wq_a": ("layers", "embed", "q_lora"),
        "q_norm": ("layers", "q_lora"),
        "wq_b": ("layers", "q_lora", "heads"),
        "wkv_a": ("layers", "embed", "kv_lora"),
        "kv_norm": ("layers", "kv_lora"),
        "wkv_b": ("layers", "kv_lora", "heads"),
        "wo": ("layers", "heads", "embed"),
    }
    return params, axes


def init_params(generator: torch.Generator, cfg: DeepSeekConfig,
                device="cuda") -> Tuple[dict, dict]:
    """(params, axes) in the JAX tree: N(0, 1/fan_in) matrices, unit norm
    scales, in ``cfg.dtype``, drawn layer by layer from ``generator`` (on
    its device: one MoE layer's (256, 7168, 2048) expert stack is drawn as
    a 15 GB float32 temporary there before its cast)."""
    dev = resolve_device(device)
    d, dt = cfg.d_model, cfg.dtype
    n_dense, n_moe = cfg.n_dense_layers, cfg.n_layers - cfg.n_dense_layers

    dense_attn, attn_axes = _init_mla(generator, cfg, n_dense, dev)
    moe_attn, _ = _init_mla(generator, cfg, n_moe, dev)

    def stack(n, *shape):
        return L.stacked_normal(generator, n, shape,
                                1.0 / math.sqrt(shape[0]), dt, dev)

    dense_mlp = {"w_gate": stack(n_dense, d, cfg.dense_d_ff),
                 "w_up": stack(n_dense, d, cfg.dense_d_ff),
                 "w_down": stack(n_dense, cfg.dense_d_ff, d)}
    dense_mlp_axes = {"w_gate": ("layers", "embed", "mlp"),
                      "w_up": ("layers", "embed", "mlp"),
                      "w_down": ("layers", "mlp", "embed")}
    moe_mlp, moe_mlp_axes = moe_lib.init_moe(
        generator, n_layers=n_moe, d_model=d, d_ff=cfg.moe_d_ff,
        n_experts=cfg.n_experts, dtype=dt, n_shared=cfg.n_shared_experts,
        shared_d_ff=cfg.moe_d_ff * cfg.n_shared_experts, device=dev)

    def norms(n):
        return {"ln1": torch.ones((n, d), dtype=dt, device=dev),
                "ln2": torch.ones((n, d), dtype=dt, device=dev)}

    norm_axes = {"ln1": ("layers", "embed"), "ln2": ("layers", "embed")}
    V_pad = L.pad_vocab(cfg.vocab_size)
    params = {
        "embed": L.stacked_normal(generator, 1, (V_pad, d), 0.02, dt,
                                  dev)[0],
        "dense_layers": {"attn": dense_attn, "mlp": dense_mlp,
                         "norm": norms(n_dense)},
        "moe_layers": {"attn": moe_attn, "mlp": moe_mlp,
                       "norm": norms(n_moe)},
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
        "lm_head": L.stacked_normal(generator, 1, (d, V_pad),
                                    1.0 / math.sqrt(d), dt, dev)[0],
    }
    axes = {
        "embed": ("vocab", "embed"),
        "dense_layers": {"attn": attn_axes, "mlp": dense_mlp_axes,
                         "norm": norm_axes},
        "moe_layers": {"attn": attn_axes, "mlp": moe_mlp_axes,
                       "norm": norm_axes},
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }
    if cfg.use_mtp:
        mtp_attn, _ = _init_mla(generator, cfg, 1, dev)
        params["mtp"] = {
            "proj": stack(1, 2 * d, d)[0],
            "attn": tree_map(lambda t: t[0], mtp_attn),
            "norm1": torch.ones((d,), dtype=dt, device=dev),
            "norm2": torch.ones((d,), dtype=dt, device=dev),
            "w_gate": stack(1, d, cfg.moe_d_ff)[0],
            "w_up": stack(1, d, cfg.moe_d_ff)[0],
            "w_down": stack(1, cfg.moe_d_ff, d)[0],
        }
        axes["mtp"] = {
            "proj": ("embed", "embed"),
            "attn": {k: v[1:] for k, v in attn_axes.items()},
            "norm1": ("embed",), "norm2": ("embed",),
            "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed"),
        }
    return params, axes


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------

# the dims of the batch and the heads that ``sharding.per_shard`` runs the
# absorbed attention over: (B, S, H, .) activations, (B, T, .) latent
# caches, (R, H, .) halves of wkv_b
_BH, _B, _RH = {"batch": 0, "heads": 2}, {"batch": 0}, {"heads": 1}

def _rope(cfg, positions):
    """``layers.rope_angles`` at the rope width, once per call: every
    layer's q_rope and k_rope are rotated by them."""
    return L.rope_angles(positions, cfg.qk_rope_head_dim, cfg.rope_theta)


def _mla_q(cfg, p, x, rope):
    """(q_nope (B, S, H, qk), rotated q_rope (B, S, H, rr))."""
    B, S, _ = x.shape
    qk = cfg.qk_nope_head_dim
    q_lat = L.rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (q_lat @ p["wq_b"]).reshape(B, S, cfg.n_heads, cfg.qk_head_dim)
    return q[..., :qk], L.rotate(q[..., qk:], *rope)


def _mla_latent(cfg, p, x, rope):
    """(the normalised latent c (B, S, kv_lora), the rotated rope key
    (B, S, 1, rr)): what the cache keeps of a token."""
    R = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]                               # (B, S, kv_lora + rr)
    c = L.rms_norm(kv[..., :R], p["kv_norm"], cfg.norm_eps)
    return c, L.rotate(kv[..., None, R:], *rope)


def _mla_train(cfg, p, x, rope, rules=None):
    """Full (non-absorbed) MLA for train and prefill. x: (B, S, d).
    Returns (out (B, S, d), (c (B, S, kv_lora), kr (B, S, rr)))."""
    B, S, _ = x.shape
    H = cfg.n_heads
    qk, rr, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if S > 1:
        # SP gather point (Megatron SP): projections consume the full seq
        x = constrain(x, rules, "batch", None, None)
    q_nope, q_rope = _mla_q(cfg, p, x, rope)
    c, kr = _mla_latent(cfg, p, x, rope)
    kvu = (c @ p["wkv_b"]).reshape(B, S, H, qk + vh)
    k = torch.cat([kvu[..., :qk], kr.expand(B, S, H, rr)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    v = kvu[..., qk:]
    qf = constrain(qf, rules, "batch", "seq", "heads", None)
    k = constrain(k, rules, "batch", "seq", "heads", None)
    scale = 1.0 / math.sqrt(qk + rr)     # q.k width 192 (v is 128 wide)
    if cfg.attn_chunk and S > cfg.attn_chunk:
        out = L.chunked_causal_mha(qf, k, v, cfg.attn_chunk, scale=scale)
    else:
        out = L.mha_attention(qf, k, v,
                              mask=L.causal_mask(S, device=x.device),
                              scale=scale)
    out = constrain(out, rules, "batch", "seq", "heads", None)
    return out.reshape(B, S, H * vh) @ p["wo"], (c, kr[:, :, 0])


def _mla_decode(cfg, p, x, cache_c, cache_kr, slot, rope, key_ok,
                rules=None):
    """Absorbed MLA decode. x: (B, 1, d); cache_c: (B, T, kv_lora),
    cache_kr: (B, T, rr), both written at ``slot`` (a one-element int64
    tensor) in place; ``key_ok``: the (1, T) mask of keys at positions up
    to ``slot``. The products take the promoted dtype of the compute and
    the cache dtypes, as JAX's do (a float32 model over ``init_cache``'s
    bf16 cache); the output returns to the compute dtype, where JAX's
    would lift a bf16 model's residual over a float32 cache."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode attention takes one position, got S={S}")
    H, R = cfg.n_heads, cfg.kv_lora_rank
    qk, rr, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    cd = x.dtype
    q_nope, q_rope = _mla_q(cfg, p, x, rope)
    c_new, kr_new = _mla_latent(cfg, p, x, rope)
    L.write_at(cache_c, 1, slot, c_new.to(cache_c.dtype))
    L.write_at(cache_kr, 1, slot, kr_new[:, :, 0].to(cache_kr.dtype))

    # absorb: q_nope (B,S,H,qk) x wkv_b's key half (R,H,qk) -> (B,S,H,R)
    wkv_b = p["wkv_b"].reshape(R, H, qk + vh)
    w_k, w_v = wkv_b[..., :qk], wkv_b[..., qk:]
    q_abs = per_shard(lambda q_, w_: torch.einsum("bshq,rhq->bshr", q_, w_),
                      (q_nope, w_k), (_BH, _RH), _BH)
    q_abs = constrain(q_abs, rules, "batch", "seq", "heads", None)
    at = torch.promote_types(cd, cache_c.dtype)
    scale = 1.0 / math.sqrt(qk + rr)

    def attend(q_abs, q_rope, cache_c, cache_kr, w_v, key_ok):
        logits = (torch.einsum("bshr,btr->bhst", q_abs.to(at),
                               cache_c.to(at))
                  + torch.einsum("bshr,btr->bhst", q_rope.to(at),
                                 cache_kr.to(at))).float() * scale
        logits = torch.where(key_ok, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(cache_c.dtype)
        out_lat = torch.einsum("bhst,btr->bshr", probs, cache_c)  # (B,S,H,R)
        return torch.einsum("bshr,rhv->bshv", out_lat.to(at), w_v.to(at))

    # per rank's batch and head shards under a mesh (the cache gathered
    # along kv_seq first: every head reads all of it)
    out = per_shard(attend, (q_abs, q_rope, cache_c, cache_kr, w_v, key_ok),
                    (_BH, _BH, _B, _B, _RH, {}), _BH)
    out = constrain(out.to(cd), rules, "batch", "seq", "heads", None)
    return out.reshape(B, S, H * vh) @ p["wo"]


# ---------------------------------------------------------------------------
# Blocks / forward
# ---------------------------------------------------------------------------

def _dense_ffn(p, x, rules=None):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = constrain(h, rules, "batch", "seq", "mlp")
    return h @ p["w_down"]


def _ffn(cfg, p, x, is_moe, n_groups, rules=None, ep=False):
    if is_moe and ep and cfg.moe_impl == "ep" and rules is not None \
            and rules.mesh is not None:     # it takes x in its own layout
        return moe_lib.moe_ffn_ep(p, x, n_experts=cfg.n_experts,
                                  top_k=cfg.moe_top_k,
                                  capacity_factor=cfg.capacity_factor,
                                  rules=rules, router_type="sigmoid")
    x = gather_inner(x)
    if not is_moe:
        return _dense_ffn(p, x, rules)
    return moe_lib.moe_ffn(p, x, n_experts=cfg.n_experts,
                           top_k=cfg.moe_top_k,
                           capacity_factor=cfg.capacity_factor,
                           n_groups=n_groups, rules=rules,
                           router_type="sigmoid")


def _block(cfg, x, lp, rope, is_moe, rules=None):
    """One train/prefill layer: (x out, the layer's latents (c, kr))."""
    h = L.rms_norm(x, lp["norm"]["ln1"], cfg.norm_eps)
    attn_out, latents = _mla_train(cfg, lp["attn"], h, rope, rules)
    x = x + gather_inner_grad(attn_out)
    h = L.rms_norm(x, lp["norm"]["ln2"], cfg.norm_eps)
    y = gather_inner_grad(_ffn(cfg, lp["mlp"], h, is_moe, cfg.moe_groups,
                               rules, ep=True))
    # sequence-parallel residual handoff between blocks
    return constrain(x + y, rules, "batch", "act_seq", None), latents


def _train_block(x, lp, rope, cfg, is_moe, rules=None):
    return _block(cfg, x, lp, rope, is_moe, rules)[0]


def layers(params: dict, cfg: DeepSeekConfig
           ) -> Iterator[Tuple[dict, bool]]:
    """(layer params (views of the stacks), is_moe) in model order: the
    dense layers, then the MoE ones (the cache's layer order)."""
    for i in range(cfg.n_dense_layers):
        yield tree_map(lambda t: t[i], params["dense_layers"]), False
    for i in range(cfg.n_layers - cfg.n_dense_layers):
        yield tree_map(lambda t: t[i], params["moe_layers"]), True


def _embed(params, tokens, cfg):
    return L.gather_rows(params["embed"].to(cfg.dtype), tokens)


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None, :].expand(B, S)


def forward(params: dict, tokens: torch.Tensor, cfg: DeepSeekConfig,
            rules: Optional[ShardingRules] = None,
            return_hidden: bool = False):
    """Training forward: tokens (B, S) -> logits (B, S, V_pad), with
    ``return_hidden`` also the final-normed hidden states (B, S, d)."""
    with mesh_scope(rules):
        x = constrain(_embed(params, tokens, cfg), rules,
                      "batch", "act_seq", None)
        rope = _rope(cfg, _positions(tokens))
        remat = cfg.remat and torch.is_grad_enabled()
        for lp, is_moe in layers(params, cfg):
            if remat:
                x = checkpoint(_train_block, x, lp, rope, cfg, is_moe, rules,
                               use_reentrant=False)
            else:
                x = _train_block(x, lp, rope, cfg, is_moe, rules)
        h_final = L.rms_norm(gather_inner(x), params["final_norm"],
                             cfg.norm_eps)
        logits = L.mask_pad_vocab(h_final @ params["lm_head"],
                                  cfg.vocab_size)
        logits = constrain(logits, rules, "batch", "seq", "vocab")
        if return_hidden:
            return logits, h_final
        return logits


def mtp_logits(params: dict, hidden: torch.Tensor, next_tokens: torch.Tensor,
               cfg: DeepSeekConfig,
               rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """MTP module: predict token t+2 from (hidden_t, emb(token_{t+1})),
    through the model's ``embed`` and ``lm_head``."""
    with mesh_scope(rules):
        p = params["mtp"]
        emb = _embed(params, next_tokens, cfg)
        x = torch.cat([gather_inner(hidden), emb], dim=-1) @ p["proj"]
        rope = _rope(cfg, _positions(next_tokens))
        h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + _mla_train(cfg, p["attn"], h, rope, rules)[0]
        h = gather_inner(L.rms_norm(x, p["norm2"], cfg.norm_eps))
        x = x + (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]
        return L.mask_pad_vocab(x @ params["lm_head"], cfg.vocab_size)


def _nll(logits, targets):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, -1, targets.long()[..., None]))


def lm_loss(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: DeepSeekConfig,
            rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """The next-token loss, plus ``mtp_weight`` times the MTP head's loss
    on the targets rolled one further (the last position wraps, as
    JAX's ``roll``), each in float32 over the vocab-masked logits."""
    if not cfg.use_mtp:
        logits = forward(params, tokens, cfg, rules)
        with mesh_scope(rules):
            return _nll(logits, targets)
    logits, hidden = forward(params, tokens, cfg, rules, return_hidden=True)
    if cfg.remat and torch.is_grad_enabled():
        mtp = checkpoint(mtp_logits, params, hidden, targets, cfg, rules,
                         use_reentrant=False)
    else:
        mtp = mtp_logits(params, hidden, targets, cfg, rules)
    with mesh_scope(rules):
        loss = _nll(logits, targets)
        # rolled along the sequence on each rank's rows (no DTensor rule
        # for roll in every torch release)
        t2 = per_shard(lambda t: torch.roll(t, -1, dims=1), (targets,),
                       (_B,), _B)
        return loss + cfg.mtp_weight * _nll(mtp, t2)


@torch.no_grad()
def prefill(params: dict, tokens: torch.Tensor, cfg: DeepSeekConfig,
            rules: Optional[ShardingRules] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Prefill: tokens (B, S) -> (next-token logits (B, V_pad), the latent
    cache {'c': (L, B, S, kv_lora), 'kr': (L, B, S, rr)} in the compute
    dtype). The latents are those of each layer's normalised input, the
    ones its attention used. Under a mesh the cache is the layers'
    DTensors stacked."""
    with mesh_scope(rules):
        B, S = tokens.shape
        x = constrain(_embed(params, tokens, cfg), rules,
                      "batch", "act_seq", None)
        rope = _rope(cfg, _positions(tokens))
        sharded = is_dtensor(x)
        lats = []
        if not sharded:
            cache = {"c": x.new_empty((cfg.n_layers, B, S,
                                       cfg.kv_lora_rank)),
                     "kr": x.new_empty((cfg.n_layers, B, S,
                                        cfg.qk_rope_head_dim))}
        for i, (lp, is_moe) in enumerate(layers(params, cfg)):
            x, (c, kr) = _block(cfg, x, lp, rope, is_moe, rules)
            if sharded:
                lats.append((c, kr))
            else:
                cache["c"][i].copy_(c)
                cache["kr"][i].copy_(kr)
        if sharded:
            cache = {"c": torch.stack([c for c, _ in lats]),
                     "kr": torch.stack([kr for _, kr in lats])}
        x = L.rms_norm(x[:, -1, :], params["final_norm"], cfg.norm_eps)
        logits = L.mask_pad_vocab(x @ params["lm_head"], cfg.vocab_size)
        return constrain(logits, rules, "batch", "vocab"), cache


def init_cache(cfg: DeepSeekConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    dev = resolve_device(device)
    return {"c": torch.zeros((cfg.n_layers, batch, max_len,
                              cfg.kv_lora_rank), dtype=dtype, device=dev),
            "kr": torch.zeros((cfg.n_layers, batch, max_len,
                               cfg.qk_rope_head_dim), dtype=dtype,
                              device=dev)}


def cache_axes() -> dict:
    return {"c": ("layers", "batch", "kv_seq", None),
            "kr": ("layers", "batch", "kv_seq", None)}


@torch.no_grad()
def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos,
                cfg: DeepSeekConfig,
                rules: Optional[ShardingRules] = None
                ) -> Tuple[torch.Tensor, dict]:
    """One decode step (absorbed MLA). tokens: (B,) ids; pos: the current
    length, an int or a one-element integer tensor (on the cache's
    device, a loop never syncs the host). Writes each layer's latent and
    rope key into ``cache`` at ``pos`` in place and returns (logits (B,
    V_pad), cache). The MoE layers route the B tokens in one group."""
    with mesh_scope(rules):
        B = tokens.shape[0]
        dev = cache["c"].device
        slot = torch.as_tensor(pos, device=dev).reshape(1).to(torch.int64)
        x = _embed(params, tokens, cfg)[:, None, :]              # (B, 1, d)
        rope = _rope(cfg, slot.reshape(1, 1).expand(B, 1))
        T = cache["c"].shape[2]
        key_ok = torch.arange(T, device=dev)[None, :] <= slot[:, None]
        for i, (lp, is_moe) in enumerate(layers(params, cfg)):
            h = L.rms_norm(x, lp["norm"]["ln1"], cfg.norm_eps)
            x = x + _mla_decode(cfg, lp["attn"], h, cache["c"][i],
                                cache["kr"][i], slot, rope, key_ok, rules)
            h = L.rms_norm(x, lp["norm"]["ln2"], cfg.norm_eps)
            x = x + _ffn(cfg, lp["mlp"], h, is_moe, 1, rules)
        x = L.rms_norm(x[:, 0, :], params["final_norm"], cfg.norm_eps)
        return (L.mask_pad_vocab(x @ params["lm_head"], cfg.vocab_size),
                cache)
