"""The port's generic MLP measure over the benchmark's weights."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import Measure, mlp_measure


def make_measure(spec: dict, weights: dict, device) -> Measure:
    # the generic measure's score function, with the benchmark's weights
    # in place of the ones it draws
    shell = mlp_measure(torch.Generator().manual_seed(0), spec["d_x"],
                        spec["d_q"], hidden=tuple(spec["hidden"]),
                        device=device)
    return dataclasses.replace(shell, params=weights)
