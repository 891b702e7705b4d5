"""GIN (Graph Isomorphism Network) [arXiv:1810.00826]: the JAX package's
``models/gnn.py`` in plain PyTorch over the JAX parameter tree. 5 layers,
d_hidden 64, sum aggregator, learnable eps.

Message passing over an explicit edge list (src, dst): the messages are a
row gather of h at src and the aggregation a segment sum over dst. Both
go through ``layers.gather_rows`` / ``layers.segment_sum_rows`` (the ids
sorted, each segment summed in edge order, one write per node): the
forward and the backward are deterministic on the card, where
``index_add_`` adds by atomics in an order that changes from run to run;
on the CPU they give ``index_add_``'s sums. Supports full-graph node
classification, sampled-subgraph minibatches (``data/sampler.py``) and
batched small-graph classification with graph pooling (molecule).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin"
    n_layers: int = 5
    d_in: int = 1433
    d_hidden: int = 64
    n_classes: int = 40
    train_eps: bool = True   # learnable eps per layer
    graph_pool: bool = False  # molecule-style graph classification
    dtype: Any = torch.float32
    msg_bf16: bool = False   # reduced-precision message aggregation


def init_params(generator: torch.Generator, cfg: GINConfig,
                device="cuda") -> Tuple[dict, dict]:
    """(params, axes) in the JAX tree: per layer an MLP d -> h -> h and a
    zero eps, then an MLP head h -> n_classes (float32)."""
    dev = resolve_device(device)
    layers, layer_axes = [], []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else cfg.d_hidden
        mlp = L.init_mlp(generator, [d_in, cfg.d_hidden, cfg.d_hidden],
                         device=dev)
        layers.append({"mlp": mlp, "eps": torch.zeros((), device=dev)})
        layer_axes.append({"mlp": _mlp_axes(mlp), "eps": ()})
    head = L.init_mlp(generator, [cfg.d_hidden, cfg.n_classes], device=dev)
    return ({"layers": layers, "head": head},
            {"layers": layer_axes, "head": _mlp_axes(head)})


def _mlp_axes(mlp: dict) -> dict:
    return {"w": [(None, None) for _ in mlp["w"]],
            "b": [(None,) for _ in mlp["b"]]}


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` over rows: (num_segments, d), deterministic
    (``layers.segment_sum_rows``)."""
    return L.segment_sum_rows(data, segment_ids.long(), num_segments)


def gin_conv(layer: dict, h: torch.Tensor, src: torch.Tensor,
             dst: torch.Tensor, n_nodes: int,
             edge_mask: Optional[torch.Tensor] = None,
             msg_dtype=None) -> torch.Tensor:
    """One GIN layer: h_i' = MLP((1+eps)·h_i + Σ_{j∈N(i)} h_j).

    msg_dtype: optional reduced precision for the gathered messages."""
    msgs = L.gather_rows(h, src)                           # gather  (E, d)
    if msg_dtype is not None:
        msgs = msgs.to(msg_dtype)
    if edge_mask is not None:
        msgs = msgs * edge_mask[:, None].to(msgs.dtype)
    agg = segment_sum(msgs, dst, n_nodes)                  # scatter-sum
    out = (1.0 + layer["eps"]) * h + agg.to(h.dtype)
    return L.mlp_apply(layer["mlp"], out)


def forward(params: dict, feats: torch.Tensor, src: torch.Tensor,
            dst: torch.Tensor, cfg: GINConfig,
            edge_mask: Optional[torch.Tensor] = None,
            graph_ids: Optional[torch.Tensor] = None,
            n_graphs: int = 0) -> torch.Tensor:
    """feats: (N, d_in); src/dst: (E,) ids (padded edges point at node 0
    with edge_mask=0). Returns per-node logits, or per-graph logits if
    ``cfg.graph_pool`` (requires graph_ids, n_graphs)."""
    n_nodes = feats.shape[0]
    h = feats.to(cfg.dtype)
    msg_dtype = torch.bfloat16 if cfg.msg_bf16 else None
    for layer in params["layers"]:
        h = torch.relu(gin_conv(layer, h, src, dst, n_nodes, edge_mask,
                                msg_dtype=msg_dtype))
    if cfg.graph_pool:
        h = segment_sum(h, graph_ids, n_graphs)
    return L.mlp_apply(params["head"], h)


def node_classification_loss(params: dict, feats, src, dst, labels,
                             label_mask, cfg: GINConfig,
                             edge_mask=None) -> torch.Tensor:
    logits = forward(params, feats, src, dst, cfg, edge_mask=edge_mask)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    mask = label_mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def graph_classification_loss(params: dict, feats, src, dst, graph_ids,
                              n_graphs, labels, cfg: GINConfig,
                              edge_mask=None) -> torch.Tensor:
    logits = forward(params, feats, src, dst, cfg, edge_mask=edge_mask,
                     graph_ids=graph_ids, n_graphs=n_graphs)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))
