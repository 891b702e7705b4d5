"""DeepFM matching measure (GUITAR §4): factorization dim 8, deep dim 32,
40-dimensional user and item vectors laid out as [fm(8) | deep(32)].

    f(x, q) = sigmoid( <x_fm, q_fm> + MLP([q_deep, x_deep]) )
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.models import layers as L


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
