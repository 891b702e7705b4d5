"""The corpus as the configuration stores it, worked out again from the
float32 corpus: per-row symmetric integer codes, ``scale = max(max|x|,
1e-8) / qmax``, ``code = clamp(round(x / scale), -qmax, qmax)``, a row read
back as ``float(code) * scale``. int8 has qmax 127; int4 (qmax 7) is the
control one precision below it."""
from __future__ import annotations

import torch

QMAX = {"int8": 127, "int4": 7}


def stored_rows(corpus: torch.Tensor, dtype: str) -> torch.Tensor:
    """The (N, D) float32 rows a search over ``dtype`` residency reads."""
    if dtype == "float32":
        return corpus
    qmax = QMAX[dtype]
    amax = corpus.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, float(qmax))
    code = torch.clamp(torch.round(corpus / scale), -qmax, qmax)
    return code * scale
