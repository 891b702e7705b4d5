"""The two measure families as plain PyTorch, float32:

- DeepFM (GUITAR section 4): ``sigmoid(<x_fm, q_fm> + MLP([q_deep,
  x_deep]))`` with vectors laid out as [fm | deep];
- MLP: ``sigmoid(MLP([x, q]))``, item first.

The MLP is ReLU between layers and none after the last, weights in the
(d_in, d_out) layout. Every product goes through ``mm``: ``fp32_mm``
(float32 with TF32 off, the reference) or ``tf32_mm`` (the operands
rounded to TF32 first, float32 sums: the control one precision below).
Rankings are by logit (the sigmoid is monotone), so near-ties of float32
scores never decide one."""
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


def mlp_apply(weights: dict, h: torch.Tensor, mm=fp32_mm) -> torch.Tensor:
    n = len(weights["w"])
    for i in range(n):
        h = mm(h, weights["w"][i]) + weights["b"][i]
        if i < n - 1:
            h = torch.relu(h)
    return h[..., 0]


def logits(measure: dict, weights: dict, x: torch.Tensor, q: torch.Tensor,
           mm=fp32_mm) -> torch.Tensor:
    """The measure's logit of item rows ``x`` against query rows ``q``
    (leading dims broadcast)."""
    x, q = torch.broadcast_tensors(x, q)
    if measure["family"] == "deepfm":
        fm = measure["fm_dim"]
        dot = mm(x[..., None, :fm], q[..., :fm, None])[..., 0, 0]
        return dot + mlp_apply(weights, torch.cat([q[..., fm:],
                                                   x[..., fm:]], dim=-1), mm)
    return mlp_apply(weights, torch.cat([x, q], dim=-1), mm)


def scores(measure: dict, weights: dict, x: torch.Tensor, q: torch.Tensor,
           mm=fp32_mm) -> torch.Tensor:
    return torch.sigmoid(logits(measure, weights, x, q, mm))


def item_terms(measure: dict, weights: dict, rows: torch.Tensor,
               mm=fp32_mm) -> dict:
    """The items' share of the first layer (and the FM columns), made once
    for a scan over the corpus."""
    w0 = weights["w"][0]
    if measure["family"] == "deepfm":
        fm, dd = measure["fm_dim"], measure["deep_dim"]
        return {"h0": mm(rows[:, fm:], w0[dd:]),
                "fm_t": rows[:, :fm].T.contiguous()}
    return {"h0": mm(rows, w0[:measure["d_x"]])}


def block_logits(measure: dict, weights: dict, items: dict,
                 q: torch.Tensor, lo: int, hi: int,
                 mm=fp32_mm) -> torch.Tensor:
    """(Qb, hi - lo) logits of the queries ``q`` against items lo..hi."""
    w, b = weights["w"], weights["b"]
    if measure["family"] == "deepfm":
        fm, dd = measure["fm_dim"], measure["deep_dim"]
        hq = mm(q[:, fm:], w[0][:dd]) + b[0]
        dot = mm(q[:, :fm], items["fm_t"][:, lo:hi])
    else:
        hq = mm(q, w[0][measure["d_x"]:]) + b[0]
        dot = None
    h = torch.relu(hq[:, None, :] + items["h0"][None, lo:hi])
    for i in range(1, len(w)):
        h = mm(h, w[i]) + b[i]
        if i < len(w) - 1:
            h = torch.relu(h)
    out = h[..., 0]
    return out if dot is None else out + dot
