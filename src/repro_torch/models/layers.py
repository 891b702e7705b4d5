"""Shared network building blocks: plain tensors, explicit generators.

Parameters are the JAX package's pytree layout as a dict of tensor lists,
``{'w': [W0, W1, ...], 'b': [b0, b1, ...]}`` with ``W_i`` of shape
(d_in, d_out), so ``params_from_jax`` carries weights across unchanged.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device


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
