"""Token-choice MoE FFN with capacity dropping, scatter-based dispatch: the
JAX package's ``models/moe.py`` in plain PyTorch (the JAX module calls no
kernel, and neither does this one).

  1. route: top-k over router logits (softmax or sigmoid affinities);
  2. each (token, slot) pair's position inside its expert by a
     hierarchical exclusive cumsum in int32 (exact on every device);
  3. the kept pairs written into an (E·C, d) buffer; a pair over its
     expert's capacity goes to one discard row past the end, so the kept
     slots, which are unique, are the only ones read;
  4. the expert FFNs as batched products over the expert axis;
  5. the results gathered back to token order and combined with the
     router weights.

Nothing syncs the host: the keep mask selects rows by index arithmetic,
never by a boolean index. ``moe_ffn_ep`` (expert parallelism by
all-to-all over a mesh) is not ported: on one device JAX's
``_mlp_block`` takes ``moe_ffn`` as well.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.utils import round_up

EXPERT_PAD = 16  # expert count padded to a multiple of the TP axis


def pad_experts(n: int) -> int:
    return round_up(n, EXPERT_PAD)


def init_moe(generator: torch.Generator, n_layers: int, d_model: int,
             d_ff: int, n_experts: int, dtype=torch.bfloat16,
             n_shared: int = 0, shared_d_ff: int = 0, device="cuda"):
    """Stacked-per-layer MoE params. Returns (params, axes), the JAX tree.

    Expert weights are padded to a multiple of EXPERT_PAD (granite: 40 ->
    48). Padding experts are never routed to: router logits beyond
    ``n_experts`` are masked at dispatch."""
    E = pad_experts(n_experts)

    def stack(*shape, fan_in):
        return L.stacked_normal(generator, n_layers, shape,
                                1.0 / math.sqrt(fan_in), dtype, device)

    params = {
        "router": stack(d_model, E, fan_in=d_model),
        "w_gate": stack(E, d_model, d_ff, fan_in=d_model),
        "w_up": stack(E, d_model, d_ff, fan_in=d_model),
        "w_down": stack(E, d_ff, d_model, fan_in=d_ff),
    }
    axes = {
        "router": ("layers", "embed", "experts"),
        "w_gate": ("layers", "experts", "embed", None),
        "w_up": ("layers", "experts", "embed", None),
        "w_down": ("layers", "experts", None, "embed"),
    }
    if n_shared > 0:
        params["shared_gate"] = stack(d_model, shared_d_ff, fan_in=d_model)
        params["shared_up"] = stack(d_model, shared_d_ff, fan_in=d_model)
        params["shared_down"] = stack(shared_d_ff, d_model,
                                      fan_in=shared_d_ff)
        axes["shared_gate"] = ("layers", "embed", "mlp")
        axes["shared_up"] = ("layers", "embed", "mlp")
        axes["shared_down"] = ("layers", "mlp", "embed")
    return params, axes


def _positions_in_expert(expert_idx: torch.Tensor, n_experts: int,
                         n_groups: int) -> torch.Tensor:
    """expert_idx: (Tk,) flat (token, slot) -> expert assignments.

    Returns (Tk,) int32: each assignment's arrival position within its
    expert, an exclusive cumsum over ``n_groups`` groups (one group when
    Tk does not divide) plus the earlier groups' counts, all in int32."""
    Tk = expert_idx.shape[0]
    G = n_groups if Tk % n_groups == 0 else 1
    eg = expert_idx.reshape(G, Tk // G).long()
    onehot = F.one_hot(eg, n_experts).to(torch.int32)          # (G, T/G, E)
    local_pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    group_counts = torch.sum(onehot, dim=1, dtype=torch.int32)   # (G, E)
    group_offsets = torch.cumsum(group_counts, dim=0,
                                 dtype=torch.int32) - group_counts
    pos = local_pos + group_offsets[:, None, :]
    return torch.gather(pos.reshape(Tk, n_experts), 1,
                        expert_idx.long()[:, None])[:, 0]


def mask_pad_experts(logits: torch.Tensor, n_experts: int) -> torch.Tensor:
    """-1e30 on the padded expert columns so routing never selects them."""
    if logits.shape[-1] == n_experts:
        return logits
    ok = torch.arange(logits.shape[-1], device=logits.device) < n_experts
    return torch.where(ok, logits, -1e30)


def route(router_logits: torch.Tensor, top_k: int,
          router_type: str = "softmax") -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) logits -> (weights (T, k) float32, expert_idx (T, k) int32),
    the k largest affinities in descending order, renormalised."""
    logits = router_logits.to(torch.float32)
    if router_type == "sigmoid":  # deepseek-v3 style: sigmoid affinity
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(scores, top_k, dim=-1)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-20)
    return w, idx.to(torch.int32)


def load_balance_loss(router_logits: torch.Tensor, expert_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * mean(frac_tokens_e * frac_prob_e)."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    frac_prob = torch.mean(probs, dim=0)
    onehot = F.one_hot(expert_idx[:, 0].long(), n_experts).to(torch.float32)
    frac_tokens = torch.mean(onehot, dim=0)
    return n_experts * torch.sum(frac_prob * frac_tokens)


def dispatch(p: dict, xt: torch.Tensor, *, n_experts: int, top_k: int,
             capacity_factor: float, n_groups: int,
             router_type: str = "softmax"):
    """The routing half of ``moe_ffn`` over tokens xt (T, d): (buf (E, C,
    d), slot (T·k,) into the flattened buffer, weights (T, k), keep (T·k,)
    bool, expert_idx (T, k))."""
    T, d = xt.shape
    K = top_k
    E = p["w_gate"].shape[-3]            # weights are EXPERT_PAD-padded
    # slots per expert: capacity_factor x T x k / E (at least k), padded to
    # a multiple of n_groups
    C = round_up(max(K, int(capacity_factor * T * K / E)), n_groups)
    router_logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    router_logits = mask_pad_experts(router_logits, n_experts)
    weights, expert_idx = route(router_logits, K, router_type)     # (T, K)
    flat_e = expert_idx.reshape(-1).long()                           # (T*K,)
    pos = _positions_in_expert(flat_e, E, n_groups).long()
    keep = pos < C
    slot = flat_e * C + torch.where(keep, pos, 0)
    # kept pairs to their unique slots, dropped ones to the discard row E*C
    dest = torch.where(keep, slot, E * C)
    xk = torch.repeat_interleave(xt, K, dim=0)                      # (T*K, d)
    buf = xt.new_zeros((E * C + 1, d)).index_put((dest,), xk)
    return buf[:E * C].reshape(E, C, d), slot, weights, keep, expert_idx


def expert_ffn(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its (C, d) slots: (E, C, d) -> (E, C,
    d), the weights cast to the buffer's dtype."""
    cd = buf.dtype
    h = F.silu(torch.bmm(buf, p["w_gate"].to(cd))) \
        * torch.bmm(buf, p["w_up"].to(cd))
    return torch.bmm(h, p["w_down"].to(cd))


def moe_ffn(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, n_groups: int = 16,
            router_type: str = "softmax") -> torch.Tensor:
    """x: (B, S, d) or (T, d). Returns the same shape."""
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    K = top_k
    buf, slot, weights, keep, _ = dispatch(
        p, xt, n_experts=n_experts, top_k=K, capacity_factor=capacity_factor,
        n_groups=n_groups, router_type=router_type)
    out = expert_ffn(p, buf)
    E, C = out.shape[0], out.shape[1]
    # combine: gather back to token order, weighted sum over the K slots
    y = out.reshape(E * C, d)[slot]                                  # (T*K, d)
    y = y * (weights.reshape(-1)[:, None] * keep[:, None]).to(y.dtype)
    y = y.reshape(T, K, d).sum(dim=1)
    if "shared_gate" in p:
        cd = xt.dtype
        hs = F.silu(xt @ p["shared_gate"].to(cd)) \
            * (xt @ p["shared_up"].to(cd))
        y = y + hs @ p["shared_down"].to(cd)
    return y.reshape(orig_shape)
