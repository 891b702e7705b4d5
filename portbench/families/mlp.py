"""The generic measure ``sigmoid(MLP([x, q]))``, item first, in plain
PyTorch float32. Rankings are by logit (the sigmoid is monotone)."""
from __future__ import annotations

import torch

from portbench import data as data_lib
from portbench.families import _mlp
from portbench.families._mlp import SCAN_BLOCKS, eval_bytes  # noqa: F401
from portbench.products import fp32_mm


def layer_dims(measure: dict) -> list:
    """The network's widths, input first."""
    return [measure["d_x"] + measure["d_q"], *measure["hidden"], 1]


def make_weights(measure: dict, seed: int, device) -> dict:
    return _mlp.make_network(layer_dims(measure), measure, seed, device)


def make_queries(config: dict, n: int, device) -> torch.Tensor:
    """(n, d_q) N(0, 1) rows from the configuration's ``data_seed``."""
    return data_lib.normal_rows(config["data_seed"], data_lib.QUERIES, n,
                                config["measure"]["d_q"], device)


def logits(measure: dict, weights: dict, x: torch.Tensor, q: torch.Tensor,
           mm=fp32_mm) -> torch.Tensor:
    lead = torch.broadcast_shapes(x.shape[:-1], q.shape[:-1])
    h = torch.cat([x.expand(*lead, x.shape[-1]),
                   q.expand(*lead, q.shape[-1])], dim=-1)
    return _mlp.apply(weights, h, mm)


def score(logit: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(logit)


def item_terms(measure: dict, weights: dict, rows: torch.Tensor,
               mm=fp32_mm) -> dict:
    """The items' share of the first layer, made once for a scan."""
    return {"h0": mm(rows, weights["w"][0][:measure["d_x"]])}


def block_logits(measure: dict, weights: dict, items: dict,
                 q: torch.Tensor, lo: int, hi: int,
                 mm=fp32_mm) -> torch.Tensor:
    """(Qb, hi - lo) logits of the queries ``q`` against items lo..hi."""
    w, b = weights["w"], weights["b"]
    hq = mm(q, w[0][measure["d_x"]:]) + b[0]
    return _mlp.apply_from_first(
        weights, hq[:, None, :] + items["h0"][None, lo:hi], mm)


def forward_flops(measure: dict) -> float:
    return _mlp.forward_flops(layer_dims(measure))


def grad_flops(measure: dict) -> float:
    """The forward and the backward to the item's inputs."""
    return (forward_flops(measure)
            + _mlp.backward_flops(layer_dims(measure), measure["d_x"]))


def grad_bytes(config: dict, row_bytes: int) -> int:
    return _mlp.grad_bytes(row_bytes, config["dim"], config["measure"]["d_q"])
