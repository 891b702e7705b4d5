"""The paper's own experiment config (GUITAR §4): DeepFM measure with FM dim
8 / deep dim 32 (40-dim user & item vectors) over Twitch- / Amazon-scale
corpora. Full scales match Table 1; `bench` scales are reduced stand-ins
drawn from the same generator."""
from __future__ import annotations

import dataclasses

from repro_torch.models.deepfm import DeepFMConfig


@dataclasses.dataclass(frozen=True)
class GuitarExperiment:
    name: str
    n_items: int            # index vectors (Table 1)
    n_queries: int
    n_test_queries: int = 1000
    m: int = 24             # graph degree (paper Table 2 uses M=24)
    k_construction: int = 100
    alpha: float = 1.01
    budget: int = 8


TWITCH = GuitarExperiment("twitch", n_items=739_991, n_queries=100_000)
AMAZON = GuitarExperiment("amazon", n_items=3_826_085, n_queries=182_032)

# reduced stand-ins (same generator, reduced scale)
TWITCH_BENCH = GuitarExperiment("twitch-bench", n_items=20_000,
                                n_queries=2_000, n_test_queries=200)
AMAZON_BENCH = GuitarExperiment("amazon-bench", n_items=40_000,
                                n_queries=4_000, n_test_queries=200)


def measure_config(n_users: int = 10_000, n_items: int = 100_000) -> DeepFMConfig:
    return DeepFMConfig(name="guitar-deepfm", fm_dim=8, deep_dim=32,
                        mlp_hidden=(64, 64), n_users=n_users, n_items=n_items)
