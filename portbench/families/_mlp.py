"""What the two network families (``deepfm``, ``mlp``) share: the
network's draw, its forward in plain PyTorch, and its operation and byte
counts at any depth. Both run the kernels ``roofline/kernels.json`` names
(DeepFM's kernels share the MLP's cluster body), so neither names its own.

The network is ReLU between layers and none after the last, weights in
the (d_in, d_out) layout."""
from __future__ import annotations

import math

import torch

from portbench import data as data_lib
from portbench.products import fp32_mm

SCAN_BLOCKS = (128, 32768)


def make_network(dims: list, measure: dict, seed: int, device) -> dict:
    """The network ``{'w': [(d_in, d_out) ...], 'b': [...]}`` of widths
    ``dims`` (input first): one model, drawn on ``device`` in one call from
    the configuration's ``model_seed`` (weights of variance 1/fan_in,
    biases of standard deviation ``bias_std``, the output bias shifted by
    ``out_bias``), with its hidden units in an order drawn from the run's
    seed. Every seed serves the same function in another layout, so the
    seed does not change the work a query takes (with weights drawn whole
    from the seed, recall and p95 followed the draw)."""
    shapes = [(a, b) for a, b in zip(dims[:-1], dims[1:])]
    total = sum(a * b + b for a, b in shapes)
    flat = torch.randn((total,), generator=data_lib.generator(
        measure["model_seed"], data_lib.WEIGHTS, device),
        dtype=torch.float32, device=device)
    ws, bs, at = [], [], 0
    for i, (a, b) in enumerate(shapes):
        ws.append(flat[at:at + a * b].view(a, b) * (1.0 / math.sqrt(a)))
        at += a * b
        bias = flat[at:at + b] * measure["bias_std"]
        if i == len(shapes) - 1:
            bias = bias + measure["out_bias"]
        bs.append(bias)
        at += b
    g = data_lib.generator(seed, data_lib.WEIGHTS, device)
    for i in range(len(shapes) - 1):          # each hidden layer's units
        perm = torch.randperm(shapes[i][1], generator=g, device=device)
        ws[i], bs[i] = ws[i][:, perm], bs[i][perm]
        ws[i + 1] = ws[i + 1][perm, :]
    return {"w": [w.contiguous() for w in ws],
            "b": [b.contiguous() for b in bs]}


def apply(weights: dict, h: torch.Tensor, mm=fp32_mm) -> torch.Tensor:
    """The network's output for inputs ``h`` (..., d_in)."""
    n = len(weights["w"])
    for i in range(n):
        h = mm(h, weights["w"][i]) + weights["b"][i]
        if i < n - 1:
            h = torch.relu(h)
    return h[..., 0]


def apply_from_first(weights: dict, h0: torch.Tensor,
                     mm=fp32_mm) -> torch.Tensor:
    """The network's output from its first layer's pre-activation ``h0``
    (bias included)."""
    w, b = weights["w"], weights["b"]
    h = torch.relu(h0)
    for i in range(1, len(w)):
        h = mm(h, w[i]) + b[i]
        if i < len(w) - 1:
            h = torch.relu(h)
    return h[..., 0]


def forward_flops(dims: list) -> float:
    """2 sum(d_i d_i+1): the network's forward."""
    return 2.0 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def backward_flops(dims: list, d_x: int) -> float:
    """The backward to the item's ``d_x`` inputs of the first layer:
    2 (sum over the layers after the first of d_i d_i+1, + d_x d_1)."""
    return 2.0 * (sum(a * b for a, b in zip(dims[1:-1], dims[2:]))
                  + d_x * dims[1])


def eval_bytes(config: dict, row_bytes: int) -> int:
    """An evaluation: the row, its id (8), the score written (4)."""
    return row_bytes + 8 + 4


def grad_bytes(row_bytes: int, dim: int, d_q: int) -> int:
    """A gradient: the row, its id (8), the query (4 d_q), the value (4),
    the gradient and the row read back (4 D each, D the item's width)."""
    return row_bytes + 8 + 4 * d_q + 4 + 8 * dim
