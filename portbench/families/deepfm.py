"""DeepFM (GUITAR section 4), the paper's measure:
``sigmoid(<x_fm, q_fm> + MLP([q_deep, x_deep]))``, item and query rows
laid out as [fm | deep], in plain PyTorch float32. Rankings are by logit
(the sigmoid is monotone), so near-ties of float32 scores never decide
one."""
from __future__ import annotations

import torch

from portbench import data as data_lib
from portbench.families import _mlp
from portbench.families._mlp import SCAN_BLOCKS, eval_bytes  # noqa: F401
from portbench.products import fp32_mm


def layer_dims(measure: dict) -> list:
    """The network's widths, input first: the deep parts of query and
    item, the hidden layers, the logit."""
    return [2 * measure["deep_dim"], *measure["hidden"], 1]


def make_weights(measure: dict, seed: int, device) -> dict:
    return _mlp.make_network(layer_dims(measure), measure, seed, device)


def make_queries(config: dict, n: int, device) -> torch.Tensor:
    """(n, dim) N(0, 1) rows from the configuration's ``data_seed``."""
    return data_lib.normal_rows(config["data_seed"], data_lib.QUERIES, n,
                                config["dim"], device)


def logits(measure: dict, weights: dict, x: torch.Tensor, q: torch.Tensor,
           mm=fp32_mm) -> torch.Tensor:
    x, q = torch.broadcast_tensors(x, q)
    fm = measure["fm_dim"]
    dot = mm(x[..., None, :fm], q[..., :fm, None])[..., 0, 0]
    return dot + _mlp.apply(weights, torch.cat([q[..., fm:], x[..., fm:]],
                                               dim=-1), mm)


def score(logit: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(logit)


def item_terms(measure: dict, weights: dict, rows: torch.Tensor,
               mm=fp32_mm) -> dict:
    """The items' share of the first layer and their FM columns, made once
    for a scan over the corpus."""
    fm, dd = measure["fm_dim"], measure["deep_dim"]
    return {"h0": mm(rows[:, fm:], weights["w"][0][dd:]),
            "fm_t": rows[:, :fm].T.contiguous()}


def block_logits(measure: dict, weights: dict, items: dict,
                 q: torch.Tensor, lo: int, hi: int,
                 mm=fp32_mm) -> torch.Tensor:
    """(Qb, hi - lo) logits of the queries ``q`` against items lo..hi."""
    w, b = weights["w"], weights["b"]
    fm, dd = measure["fm_dim"], measure["deep_dim"]
    hq = mm(q[:, fm:], w[0][:dd]) + b[0]
    dot = mm(q[:, :fm], items["fm_t"][:, lo:hi])
    out = _mlp.apply_from_first(
        weights, hq[:, None, :] + items["h0"][None, lo:hi], mm)
    return out + dot


def forward_flops(measure: dict) -> float:
    """The network's forward and the FM dot (2 fm)."""
    return _mlp.forward_flops(layer_dims(measure)) + 2.0 * measure["fm_dim"]


def grad_flops(measure: dict) -> float:
    """The forward, the backward to the item's deep part, and the FM dot's
    gradient (2 fm)."""
    return (forward_flops(measure)
            + _mlp.backward_flops(layer_dims(measure), measure["deep_dim"])
            + 2.0 * measure["fm_dim"])


def grad_bytes(config: dict, row_bytes: int) -> int:
    return _mlp.grad_bytes(row_bytes, config["dim"], config["dim"])
