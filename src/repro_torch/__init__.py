"""PyTorch/CUDA port of the GUITAR serving path (the JAX package ``repro``
stays the reference it is held against).

Device policy:

- Every entry point and constructor takes ``device=`` and defaults to
  ``"cuda"``. A missing card on that default is an error
  (``resolve_device`` raises), never a silent CPU run; callers that want
  the CPU say ``device="cpu"``, as the tests do.
- Everything is float32.
- TF32 is off for matrix products and convolutions, set here at import:
  the port is held against fp32 references, and TF32 keeps about three
  decimal digits.

The hand-written CUDA kernels live under ``kernels/``; each wrapper launches
its kernel for a CUDA tensor and uses its plain PyTorch version only for a
CPU tensor.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"
DTYPE = torch.float32


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' explicitly to run on the CPU")
    return dev
