"""The served score of the measures as plain PyTorch, float32: each
family's reference is ``families/<family>.py``, found by the
configuration's ``measure.family``. Every product goes through ``mm``
(``portbench/products.py``). Rankings are by logit, so near-ties of served
scores never decide one."""
from __future__ import annotations

import torch

from portbench import families
from portbench.products import fp32_mm


def scores(measure: dict, weights: dict, x: torch.Tensor, q: torch.Tensor,
           mm=fp32_mm) -> torch.Tensor:
    """The served score of item rows ``x`` against query rows ``q``
    (leading dims broadcast): the family's score of its logit."""
    family = families.reference(measure)
    return family.score(family.logits(measure, weights, x, q, mm))
