"""Matching-measure abstraction for fast neural ranking.

A measure is ``(score_fn, params)`` where ``score_fn(params, x, q)`` scores
item rows ``x`` against user rows ``q`` over their last axis, with leading
dims broadcast (one pair gives a scalar, (M, D) against (M, D) gives (M,)).
No metric, convexity or symmetry is assumed (paper Eq. 1). The engine's
generic stages batch it directly and differentiate it with
``torch.func``; registered families route through kernels instead
(``core/bundles.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import deepfm as deepfm_lib
from repro_torch.models import layers as L

ScoreFn = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Measure:
    """``meta`` advertises a kernel-backed family as a tuple, e.g.
    ``('deepfm', fm_dim)`` routes the engine's score and grad stages through
    the DeepFM kernels."""
    name: str
    score_fn: ScoreFn
    params: Any
    meta: Optional[tuple] = None

    def score(self, x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return self.score_fn(self.params, x, q)

    def grad_x(self, x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """df/dx for one row x (paper Eq. 2)."""
        return torch.func.grad(lambda xx: self.score_fn(self.params, xx, q))(x)


def deepfm_measure(params: dict, cfg: deepfm_lib.DeepFMConfig) -> Measure:
    """The paper's measure. ``params`` must contain the 'mlp' subtree."""
    mlp_params = {"mlp": params["mlp"]}

    def fn(p, x, q):
        return deepfm_lib.score(p, x, q, cfg)

    return Measure("deepfm", fn, mlp_params, meta=("deepfm", cfg.fm_dim))


def mlp_measure(generator: torch.Generator, d_x: int, d_q: int,
                hidden=(128, 128), name: str = "mlp",
                device="cuda") -> Measure:
    """Generic MLP measure f(x, q) = sigmoid(MLP([x, q])), item first: the
    'heavier f' regime where gradient pruning pays off most.
    ``meta=('mlp',)`` routes the engine through the ``mlp_*`` kernels (any
    depth; the layer shapes are read off ``params``, the top-level
    ``{'w': [...], 'b': [...]}``)."""
    params = L.init_mlp(generator, [d_x + d_q, *hidden, 1], device=device)

    def fn(p, x, q):
        # a shared query row meets a block of items: expand the leading
        # dims only, since d_q may differ from d_x
        lead = torch.broadcast_shapes(x.shape[:-1], q.shape[:-1])
        h = torch.cat([x.expand(*lead, x.shape[-1]),
                       q.expand(*lead, q.shape[-1])], dim=-1)
        return torch.sigmoid(L.mlp_apply(p, h)[..., 0])

    return Measure(name, fn, params, meta=("mlp",))


def inner_product_measure() -> Measure:
    """MIPS as a degenerate matching function (sanity baseline)."""
    def fn(p, x, q):
        return torch.sum(x * q, dim=-1)
    return Measure("ip", fn, {})


def l2_measure() -> Measure:
    def fn(p, x, q):
        return -torch.sum(torch.square(x - q), dim=-1)
    return Measure("l2", fn, {})


MEASURE_FAMILIES = ("deepfm", "mlp")


def deepfm_config_for(dim: int, hidden=(64, 64)) -> deepfm_lib.DeepFMConfig:
    """The DeepFM split of ``dim`` the serving launcher uses: [fm(8) |
    deep(rest)], fm_dim shrunk for tiny vectors; a non-2-layer ``hidden``
    squares its first width (the kernels take 2 hidden layers)."""
    fm_dim = 8 if dim > 8 else max(1, dim // 2)
    if len(hidden) != 2:
        hidden = (hidden[0], hidden[0])
    return deepfm_lib.DeepFMConfig(fm_dim=fm_dim, deep_dim=dim - fm_dim,
                                   mlp_hidden=tuple(hidden))


def make_family_measure(family: str, generator: torch.Generator, dim: int,
                        hidden=(64, 64), device="cuda") -> Measure:
    """A fresh measure of a registered family over ``dim``-dimensional
    vectors, deterministic in ``generator`` (weights are drawn on the CPU,
    then moved, so one seed gives the same measure on every device)."""
    if family == "deepfm":
        cfg = deepfm_config_for(dim, hidden)
        params = deepfm_lib.init_measure(generator, cfg, device=device)
        return deepfm_measure(params, cfg)
    if family == "mlp":
        return mlp_measure(generator, dim, dim, hidden=tuple(hidden),
                           device=device)
    raise ValueError(f"unknown measure family {family!r}; known: "
                     f"{MEASURE_FAMILIES}")


def deepfm_numpy_fns(params: dict, cfg: deepfm_lib.DeepFMConfig):
    """(score_np, grad_np) closures over numpy arrays: the DeepFM measure's
    forward and its hand-written backward, for the faithful searcher
    (``core/faithful.py``). ``params`` holds the 'mlp' subtree (tensors or
    arrays, the (d_in, d_out) layout)."""
    def np32(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float32)

    Ws = [np32(w) for w in params["mlp"]["w"]]
    bs = [np32(b) for b in params["mlp"]["b"]]
    fd = cfg.fm_dim

    def _forward(x, q):
        h = np.concatenate([q[fd:], x[fd:]])
        acts = [h]
        for i, (W, b) in enumerate(zip(Ws, bs)):
            h = h @ W + b
            if i < len(Ws) - 1:
                h = np.maximum(h, 0.0)
            acts.append(h)
        logit = float(np.dot(x[:fd], q[:fd]) + h[0])
        return 1.0 / (1.0 + np.exp(-logit)), acts

    def score_np(x, q):
        return _forward(x, q)[0]

    def grad_np(x, q):
        f, acts = _forward(x, q)
        g_logit = f * (1.0 - f)                    # d sigmoid
        # backprop through the MLP to its input
        g = np.array([g_logit], np.float32)
        for i in range(len(Ws) - 1, -1, -1):
            g = Ws[i] @ g
            if i > 0:
                g = g * (acts[i] > 0)
        dd = cfg.deep_dim
        gx = np.zeros_like(x)
        gx[:fd] = g_logit * q[:fd]
        gx[fd:] = g[dd:]          # the deep input is [q_deep, x_deep]
        return f, gx

    return score_np, grad_np


def params_from_jax(mlp_params_numpy: dict, device="cuda") -> dict:
    """The JAX package's MLP pytree ``{'w': [...], 'b': [...]}`` (as numpy
    arrays) -> the port's parameters: the same (d_in, d_out) layout, as
    float32 tensors on ``device``."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return {"w": [t(w) for w in mlp_params_numpy["w"]],
            "b": [t(b) for b in mlp_params_numpy["b"]]}
