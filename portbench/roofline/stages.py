"""The work of the search's stages, counted from what the program counts
(evaluations, gradients, expansions) and the measure's widths, and the
least time it takes on the card's peaks. Frozen: later changes to the
program cannot move it.

Per unit of work (D the vector width, R the bytes of a stored row):

- measure, per evaluation: the network's forward, 2 (d_in h0 + h0 h1 +
  h1) operations (and 2 fm for DeepFM's dot); bytes: the row, its id
  (8) and the score written (4).
- grad, per gradient: the forward and the backward to the item's inputs,
  2 (h1 + h0 h1 + d_x h0) more (d_x the item's share of the first layer;
  DeepFM's dot adds 2 fm); bytes: the row, its id, the query (4 D), the
  value (4), the gradient and the row read back (4 D each).
- rank, per expansion: for each of the graph's neighbours (its mean
  degree) the neighbour's row and id, the dot with the gradient and the
  norm (6 D operations), the key and mask written (5 bytes); the frontier
  row and its gradient (4 D each).

The counts are of the work these inputs need: a converged lane, a padded
neighbour slot or a row the adaptive mask skips is not counted. The
network's weights (about 50 KB a launch) are left out, so the bound is a
shade low: a share of it never reads high."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent
                    / "peaks.json").read_text())


def row_bytes(dtype: str, dim: int) -> int:
    return {"float32": 4 * dim, "int8": dim + 4}[dtype]


def widths(measure: dict) -> tuple:
    """(d_in, h0, h1, d_x, fm) of a measure configuration."""
    h0, h1 = measure["hidden"]
    if measure["family"] == "deepfm":
        return (2 * measure["deep_dim"], h0, h1, measure["deep_dim"],
                measure["fm_dim"])
    return (measure["d_x"] + measure["d_q"], h0, h1, measure["d_x"], 0)


def forward_flops(measure: dict) -> float:
    d_in, h0, h1, _, fm = widths(measure)
    return 2.0 * (d_in * h0 + h0 * h1 + h1) + 2.0 * fm


def grad_flops(measure: dict) -> float:
    _, h0, h1, d_x, fm = widths(measure)
    return forward_flops(measure) + 2.0 * (h1 + h0 * h1 + d_x * h0) \
        + 2.0 * fm


def stage_work(config: dict, n_eval: float, n_grad: float,
               n_iters: float, mean_degree: float) -> dict:
    """{stage: (operations, bytes)} of the counted work."""
    m, dim = config["measure"], config["dim"]
    r = row_bytes(config["engine"]["corpus_dtype"], dim)
    return {
        "measure": (n_eval * forward_flops(m), n_eval * (r + 8 + 4)),
        "grad": (n_grad * grad_flops(m),
                 n_grad * (r + 8 + 4 * dim + 4 + 8 * dim)),
        "rank": (n_iters * mean_degree * 6.0 * dim,
                 n_iters * (mean_degree * (r + 8 + 5) + 8 * dim)),
    }


def least_seconds(work: dict) -> float:
    """The least time of the stages' work on the card: for each stage the
    larger of its operations over the float32 peak and its bytes over the
    memory's, summed over the stages."""
    return sum(max(f / PEAKS["fp32_flops"], b / PEAKS["hbm_bytes_per_s"])
               for f, b in work.values())


def search_flops(config: dict, n_eval: float, n_grad: float) -> float:
    """The measure's operations of the counted evaluations and
    gradients."""
    m = config["measure"]
    return n_eval * forward_flops(m) + n_grad * grad_flops(m)
