"""Plain PyTorch version of the causal flash-attention forward kernel
(counterpart of the JAX package's ``kernels/flash_attn/ref.py``): softmax
in float32 over each query row's causal prefix."""
from __future__ import annotations

import math
from typing import Optional

import torch

# query rows per pass: bounds the transient (B, H, rows, S) logits
ROWS_PER_PASS = 1024


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_rows: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q/k/v: (B, S, H, hd), the same head count. Returns (B, S, H, hd)
    float32; with ``q_rows`` (1-D positions) only those query rows,
    (B, len(q_rows), H, hd). Rows are taken ``ROWS_PER_PASS`` at a time
    (each row's softmax is independent), so the logits never exceed
    (B, H, ROWS_PER_PASS, S)."""
    B, S, H, hd = q.shape
    if q_rows is None:
        q_rows = torch.arange(S, device=q.device)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(S, device=q.device)
    outs = []
    for i in range(0, q_rows.numel(), ROWS_PER_PASS):
        rows = q_rows[i:i + ROWS_PER_PASS].to(q.device)
        qb = q.index_select(1, rows).float()
        logits = torch.einsum("bshd,bthd->bhst", qb, kf) / math.sqrt(hd)
        mask = kpos[None, :] <= rows[:, None]
        logits = logits.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhst,bthd->bshd", probs, vf))
    return torch.cat(outs, dim=1)
