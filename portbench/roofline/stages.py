"""The work of the search's stages, counted from what the program counts
(evaluations, gradients, expansions) and the measure's widths, and the
least time it takes on the card's peaks. Frozen: later changes to the
program cannot move it.

Per unit of work (D the item's width, R the bytes of a stored row):

- measure, per evaluation, and grad, per gradient: the family's count
  (``families/<family>.py``: ``forward_flops``, ``grad_flops``,
  ``eval_bytes``, ``grad_bytes``); the network families count the
  forward, 2 sum(d_i d_i+1) operations, and for a gradient the backward
  to the item's inputs besides, DeepFM's dot 2 fm more in each; bytes: the
  row, its id (8) and the score written (4), and for a gradient the query
  (4 D), the value (4), the gradient and the row read back (4 D each).
- rank, per expansion, for every family: for each of the graph's
  neighbours (its mean degree) the neighbour's row and id, the dot with the
  gradient and the norm (6 D operations), the key and mask written (5
  bytes); the frontier row and its gradient (4 D each).

The counts are of the work these inputs need: a converged lane, a padded
neighbour slot or a row the adaptive mask skips is not counted. The
network's weights (about 50 KB a launch) are left out, so the bound is a
shade low: a share of it never reads high.

The kernels that do each stage's work, and the port's whole list, are
``kernels.json``'s; a family that runs other kernels names its own
(``stage_kernels``, ``port_kernels``)."""
from __future__ import annotations

import json
from pathlib import Path

from portbench import families

HERE = Path(__file__).resolve().parent
PEAKS = json.loads((HERE / "peaks.json").read_text())


def kernel_lists() -> dict:
    """``kernels.json``: the stages' kernels and the port's."""
    return json.loads((HERE / "kernels.json").read_text())


def stage_kernels(config: dict) -> dict:
    """{stage: [kernel name substrings]} of the configuration's search:
    ``kernels.json``'s, with the grad and measure stages' from the family
    where it names its own (``stage_kernels()``)."""
    lists = kernel_lists()["stages"]
    own = getattr(families.reference(config["measure"]), "stage_kernels",
                  None)
    return {**lists, **own()} if own else lists


def port_kernels(config: dict) -> list:
    """Every kernel of the port: ``kernels.json``'s list and those the
    configuration's family adds (``port_kernels()``, where it has one)."""
    own = getattr(families.reference(config["measure"]), "port_kernels",
                  None)
    return kernel_lists()["port"] + (own() if own else [])


def row_bytes(dtype: str, dim: int) -> int:
    return {"float32": 4 * dim, "int8": dim + 4}[dtype]


def stage_work(config: dict, n_eval: float, n_grad: float,
               n_iters: float, mean_degree: float) -> dict:
    """{stage: (operations, bytes)} of the counted work."""
    m, dim = config["measure"], config["dim"]
    family = families.reference(m)
    r = row_bytes(config["engine"]["corpus_dtype"], dim)
    return {
        "measure": (n_eval * family.forward_flops(m),
                    n_eval * family.eval_bytes(config, r)),
        "grad": (n_grad * family.grad_flops(m),
                 n_grad * family.grad_bytes(config, r)),
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
    family = families.reference(m)
    return n_eval * family.forward_flops(m) + n_grad * family.grad_flops(m)
