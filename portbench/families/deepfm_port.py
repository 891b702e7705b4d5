"""The port's DeepFM measure over the benchmark's weights."""
from __future__ import annotations

from repro_torch.core import Measure, deepfm_measure
from repro_torch.models.deepfm import DeepFMConfig


def make_measure(spec: dict, weights: dict, device) -> Measure:
    cfg = DeepFMConfig(fm_dim=spec["fm_dim"], deep_dim=spec["deep_dim"],
                       mlp_hidden=tuple(spec["hidden"]))
    return deepfm_measure({"mlp": weights}, cfg)
