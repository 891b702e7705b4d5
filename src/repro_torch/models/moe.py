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
never by a boolean index.

Under a mesh (``rules=mesh_rules(mesh)``, DTensor tokens and weights)
``moe_ffn`` routes on the gathered tokens (GSPMD replicates the token
buffer the same way), constrains the (E, C, d) buffer and the expert
activations to ``("experts", "capacity", None)`` as JAX does, and runs the
expert products on DTensors. ``moe_ffn_ep`` is JAX's expert-parallel
dispatch: each rank routes its own tokens, and two all-to-alls over the
EP group (``dist.all_to_all_single``) carry the (D, E_local·Ce, d) send
and return buffers, as JAX's ``shard_map`` body does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import (P, ShardingRules, constrain, is_dtensor,
                                  mesh_axis_sizes, placements)
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


def expert_ffn(p: dict, buf: torch.Tensor,
               rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """SwiGLU of every expert over its (C, d) slots: (E, C, d) -> (E, C,
    d), the weights cast to the buffer's dtype."""
    cd = buf.dtype
    h = F.silu(torch.bmm(buf, p["w_gate"].to(cd))) \
        * torch.bmm(buf, p["w_up"].to(cd))
    h = constrain(h, rules, "experts", "capacity", None)
    return torch.bmm(h, p["w_down"].to(cd))


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """The whole of a DTensor on every rank (a plain tensor as it is)."""
    return t.full_tensor() if is_dtensor(t) else t


def moe_ffn(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, n_groups: int = 16,
            rules: Optional[ShardingRules] = None,
            router_type: str = "softmax") -> torch.Tensor:
    """x: (B, S, d) or (T, d). Returns the same shape. A DTensor ``x`` is
    routed on every rank over the gathered tokens, and the buffer and
    expert products run as DTensors under ``rules``."""
    orig_shape = x.shape
    d = x.shape[-1]
    sharded = is_dtensor(x)
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    K = top_k
    route_p = {"router": _replicated(p["router"]),
               "w_gate": p["w_gate"]}
    buf, slot, weights, keep, _ = dispatch(
        route_p, _replicated(xt), n_experts=n_experts, top_k=K,
        capacity_factor=capacity_factor, n_groups=n_groups,
        router_type=router_type)
    if sharded:
        from torch.distributed.tensor import DTensor, Replicate
        mesh = x.device_mesh
        buf = DTensor.from_local(buf, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    buf = constrain(buf, rules, "experts", "capacity", None)
    out = expert_ffn(p, buf, rules)
    out = constrain(out, rules, "experts", "capacity", None)
    E, C = out.shape[0], out.shape[1]
    # combine: gather back to token order, weighted sum over the K slots
    y = _replicated(out).reshape(E * C, d)[slot]                     # (T*K, d)
    y = y * (weights.reshape(-1)[:, None] * keep[:, None]).to(y.dtype)
    y = y.reshape(T, K, d).sum(dim=1)
    if sharded:
        y = DTensor.from_local(y, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if "shared_gate" in p:
        cd = xt.dtype
        hs = F.silu(xt @ p["shared_gate"].to(cd)) \
            * (xt @ p["shared_up"].to(cd))
        y = y + hs @ p["shared_down"].to(cd)
    return y.reshape(orig_shape)


class _AllToAll(torch.autograd.Function):
    """``dist.all_to_all_single`` of equal dim-0 splits over ``group``; its
    adjoint is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


def ep_layout(mesh, E_w: int):
    """JAX's EP layout: (ep_axes, D, E_pad, E_local). The EP group is
    ("data", "model") when the weights' E_w experts reach |data|·|model|,
    else ("model",); the pod axis stays pure data parallelism."""
    sizes = mesh_axis_sizes(mesh)
    dm, dd = sizes["model"], sizes["data"]
    ep_axes = ("data", "model") if E_w >= dm * dd else ("model",)
    D = math.prod(sizes[a] for a in ep_axes)
    E_pad = round_up(E_w, D)
    return ep_axes, D, E_pad, E_pad // D


def _ep_group(mesh, ep_axes):
    """The process group of this rank's EP group (ranks in the group's
    row-major order: data-major, as JAX orders a tuple of axes)."""
    if len(ep_axes) == 1:
        return mesh.get_group(ep_axes[0])
    return mesh[ep_axes]._flatten().get_group()


def _ep_rank(mesh, ep_axes) -> int:
    names = list(mesh.mesh_dim_names)
    sizes = mesh_axis_sizes(mesh)
    r = 0
    for a in ep_axes:
        r = r * sizes[a] + mesh.get_local_rank(names.index(a))
    return r


def _local_experts(w: torch.Tensor, mesh, ep_axes, E_pad: int,
                   E_local: int, r: int) -> torch.Tensor:
    """This rank's E_local experts of ``w`` (E_w, ...) padded with zero
    experts to E_pad and split over the EP group."""
    E_w = w.shape[0]
    if E_pad == E_w and is_dtensor(w):
        want = placements(P(ep_axes), mesh, w.ndim)
        return w.redistribute(mesh, want).to_local()
    full = _replicated(w)
    if E_pad > E_w:
        full = F.pad(full, (0, 0) * (full.ndim - 1) + (0, E_pad - E_w))
    return full[r * E_local:(r + 1) * E_local]


def moe_ffn_ep(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
               capacity_factor: float = 1.25,
               rules: Optional[ShardingRules] = None,
               router_type: str = "softmax") -> torch.Tensor:
    """Expert-parallel MoE with explicit all-to-all dispatch: JAX's
    ``moe_ffn_ep`` (its ``shard_map`` body on each rank's shards).

    Layout contract (the framework's default rules):
      x: (B, S, d) with B sharded over the batch axes (pod, data) and S
         over model when S > 1: every rank of the EP group holds distinct
         tokens;
      experts: padded to a multiple of the EP group size D and split over
         the group (padding experts' router logits are -1e30, then
         ``mask_pad_experts``);
      EP group = ("data", "model") when E >= |data|x|model| else
         ("model",); the pod axis stays pure data parallelism.
    Each rank routes its Tl tokens with Ce = max(1, int(capacity_factor
    · Tl · K / E_pad)) slots per expert, sends each expert's slots to the
    rank that holds it, runs its E_local experts over the D·Ce tokens it
    receives, sends the results back, and adds the shared experts of its
    own tokens. Returns a DTensor in x's layout."""
    from torch.distributed.tensor import DTensor, Replicate
    if rules is None or rules.mesh is None:
        raise ValueError("moe_ffn_ep needs rules with a mesh")
    mesh = rules.mesh
    B, S, d = x.shape
    E, K = n_experts, top_k
    E_w = p["w_gate"].shape[-3]          # weights are EXPERT_PAD-padded
    ep_axes, D, E_pad, E_local = ep_layout(mesh, E_w)
    bb = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    x_place = placements(P(bb, "model" if S > 1 else None, None), mesh, 3)
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    xb = x.redistribute(mesh, x_place).to_local()
    r = _ep_rank(mesh, ep_axes)
    w = {k: _local_experts(p[k], mesh, ep_axes, E_pad, E_local, r)
         for k in ("w_gate", "w_up", "w_down")}
    router = _replicated(p["router"])
    group = _ep_group(mesh, ep_axes)

    Bl, Sl, _ = xb.shape
    t = xb.reshape(-1, d)
    Tl = t.shape[0]
    logits = t.to(torch.float32) @ router.to(torch.float32)
    if E_pad > E_w:
        logits = F.pad(logits, (0, E_pad - E_w), value=-1e30)
    logits = mask_pad_experts(logits, E)
    weights, expert_idx = route(logits, K, router_type)
    Ce = max(1, int(capacity_factor * Tl * K / E_pad))

    flat_e = expert_idx.reshape(-1).long()
    pos = _positions_in_expert(flat_e, E_pad, 1).long()
    keep = pos < Ce
    slot = flat_e * Ce + torch.where(keep, pos, 0)
    # kept pairs to their unique slots, dropped ones to a discard row
    dest = torch.where(keep, slot, E_pad * Ce)
    xk = torch.repeat_interleave(t, K, dim=0)
    send = t.new_zeros((E_pad * Ce + 1, d)).index_put((dest,), xk)
    send = send[:E_pad * Ce].reshape(D, E_local * Ce, d)
    recv = _AllToAll.apply(send, group)

    toks = (recv.reshape(D, E_local, Ce, d).transpose(0, 1)
            .reshape(E_local, D * Ce, d))
    out = expert_ffn(w, toks)
    back = (out.reshape(E_local, D, Ce, d).transpose(0, 1)
            .reshape(D, E_local * Ce, d))
    ret = _AllToAll.apply(back, group)

    y = ret.reshape(E_pad * Ce, d)[slot]
    y = y * (weights.reshape(-1)[:, None] * keep[:, None]).to(y.dtype)
    y = y.reshape(Tl, K, d).sum(dim=1)
    if "shared_gate" in p:
        cd = t.dtype
        sg, su, sd = (_replicated(p[k]).to(cd) for k in
                      ("shared_gate", "shared_up", "shared_down"))
        y = y + (F.silu(t @ sg) * (t @ su)) @ sd
    return DTensor.from_local(y.reshape(Bl, Sl, d), mesh, x_place,
                              run_check=False, shape=x.shape,
                              stride=x.stride())
