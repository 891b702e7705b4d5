"""The products every reference computation goes through, as ``mm``:
``fp32_mm`` (float32 with TF32 off, the reference) or ``tf32_mm`` (the
operands rounded to TF32 first, float32 sums: the control one precision
below). A leaf: it imports nothing of the benchmark."""
from __future__ import annotations

import torch


def fp32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits, to nearest), as the tensor
    cores round a TF32 product's operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(tf32_round(a), tf32_round(b))


PRODUCTS = {"fp32": fp32_mm, "tf32": tf32_mm}
