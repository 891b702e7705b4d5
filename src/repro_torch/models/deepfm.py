"""DeepFM matching measure (GUITAR §4): factorization dim 8, deep dim 32,
40-dimensional user and item vectors laid out as [fm(8) | deep(32)].

    f(x, q) = sigmoid( <x_fm, q_fm> + MLP([q_deep, x_deep]) )

The full trainable recommender is user table + item table + MLP, trained
with BCE on interactions (``init_model``, ``interaction_loss``); after
training, item rows become the index's base vectors and user rows the
queries, the paper's own label protocol.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.recsys import bce_loss


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    fm_dim: int = 8
    deep_dim: int = 32
    mlp_hidden: Tuple[int, ...] = (64, 64)
    n_users: int = 10_000
    n_items: int = 100_000

    @property
    def vec_dim(self) -> int:
        return self.fm_dim + self.deep_dim  # 40


def init_measure(generator: torch.Generator, cfg: DeepFMConfig,
                 device="cuda") -> dict:
    """The measure network only (no embedding tables): {'mlp': ...}."""
    return {"mlp": L.init_mlp(
        generator, [2 * cfg.deep_dim, *cfg.mlp_hidden, 1], device=device)}


def score(measure_params: dict, x: torch.Tensor, q: torch.Tensor,
          cfg: DeepFMConfig) -> torch.Tensor:
    """f(x, q) in [0, 1]. x: (..., 40) item vectors; q: (..., 40) user
    vectors; leading dims broadcast against each other."""
    x, q = torch.broadcast_tensors(x, q)
    fm = torch.sum(x[..., :cfg.fm_dim] * q[..., :cfg.fm_dim], dim=-1)
    deep_in = torch.cat([q[..., cfg.fm_dim:], x[..., cfg.fm_dim:]], dim=-1)
    deep = L.mlp_apply(measure_params["mlp"], deep_in)[..., 0]
    return torch.sigmoid(fm + deep)


def init_model(generator: torch.Generator, cfg: DeepFMConfig,
               device="cuda") -> dict:
    """Full trainable recommender: {'users', 'items', 'mlp'}, the tables
    N(0, 1) * 0.3."""
    measure = init_measure(generator, cfg, device=device)
    return {
        "users": L.embed_init(generator, cfg.n_users, cfg.vec_dim, scale=0.3,
                              device=device),
        "items": L.embed_init(generator, cfg.n_items, cfg.vec_dim, scale=0.3,
                              device=device),
        **measure,
    }


def interaction_loss(params: dict, user_ids: torch.Tensor,
                     item_ids: torch.Tensor, labels: torch.Tensor,
                     cfg: DeepFMConfig) -> torch.Tensor:
    """BCE training loss over (user, item, click) interactions: float32
    logits, the stable form max(l, 0) - l y + log1p(exp(-|l|))."""
    q = L.gather_rows(params["users"], user_ids)
    x = L.gather_rows(params["items"], item_ids)
    fm = torch.sum(x[..., :cfg.fm_dim] * q[..., :cfg.fm_dim], dim=-1)
    deep_in = torch.cat([q[..., cfg.fm_dim:], x[..., cfg.fm_dim:]], dim=-1)
    deep = L.mlp_apply(params["mlp"], deep_in)[..., 0]
    return bce_loss(fm + deep, labels)

