"""Corpus residency for the expansion engine: whole-resident float32.

``CorpusStore`` holds the (N, D) corpus on the device and gathers rows by id
(``take``). Only float32 residency is ported; bf16 and int8 residency
(dequantize-on-gather inside the index-fused kernels) and tombstones come
with the fused slice (ROADMAP.md, queue 2).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch import resolve_device

CORPUS_DTYPES = ("float32", "bfloat16", "int8")


def _check_dtype(corpus_dtype: str) -> None:
    if corpus_dtype not in CORPUS_DTYPES:
        raise ValueError(f"corpus_dtype must be one of {CORPUS_DTYPES}, "
                         f"got {corpus_dtype!r}")
    if corpus_dtype != "float32":
        raise NotImplementedError(
            f"{corpus_dtype} residency is not ported yet: it arrives with "
            f"the index-fused kernels (ROADMAP.md, queue 2)")


class CorpusStore:
    """(N, D) float32 payload resident on one device."""

    def __init__(self, data: torch.Tensor, dtype: str = "float32"):
        _check_dtype(dtype)
        if data.dim() != 2 or data.dtype != torch.float32:
            raise ValueError(f"corpus must be (N, D) float32, got "
                             f"{tuple(data.shape)} {data.dtype}")
        self.data = data.contiguous()
        self.dtype = dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    def take(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows by id (any ids shape) -> (..., D) float32."""
        return self.data[ids]

    def dequantize(self) -> torch.Tensor:
        """The full (N, D) float32 corpus."""
        return self.data

    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    def __repr__(self) -> str:
        return (f"CorpusStore(n={self.n}, dim={self.dim}, dtype={self.dtype}"
                f", device={self.device})")


def make_corpus_store(base, corpus_dtype: str = "float32",
                      device="cuda") -> CorpusStore:
    """An (N, D) corpus (numpy or tensor) resident on ``device``."""
    _check_dtype(corpus_dtype)
    dev = resolve_device(device)
    if isinstance(base, torch.Tensor):
        data = base.to(device=dev, dtype=torch.float32)
    else:
        data = torch.as_tensor(np.asarray(base, np.float32), device=dev)
    return CorpusStore(data, corpus_dtype)


def as_corpus_store(base: Union[torch.Tensor, np.ndarray, CorpusStore],
                    corpus_dtype: str = "float32",
                    device="cuda") -> CorpusStore:
    """A store passes through when it is already in ``corpus_dtype``; an
    array becomes one on ``device`` (a tensor stays on its own device)."""
    if isinstance(base, CorpusStore):
        _check_dtype(corpus_dtype)
        return base
    if isinstance(base, torch.Tensor):
        device = base.device
    return make_corpus_store(base, corpus_dtype, device)
