"""The control: the reference put in the program's place, one precision
below what the configuration states, has to come out as not correct.

- ``tf32``: the measure's products on TF32 operands (the configuration
  states float32 with TF32 off);
- ``int4``: the corpus stored as int4 codes (for a configuration that
  states an int8 store).

``fp32`` puts the reference itself in the program's place: it has to
come out correct.

The control answers each query with its exact top-k, computed at its own
precision, and reports its own scores of them; ``judge`` then holds those
answers to the float32 reference like the program's."""
from __future__ import annotations

import torch

from portbench.products import PRODUCTS
from portbench.reference import exact, judge, measures, store


def controls_for(config: dict) -> list:
    """The controls that apply to a configuration."""
    out = ["tf32"]
    if config["engine"]["corpus_dtype"] == "int8":
        out.append("int4")
    return out


def control_answers(config: dict, weights: dict, corpus: torch.Tensor,
                    queries: torch.Tensor, mode: str):
    """(ids, scores) of the control ``mode`` for ``queries``."""
    measure, k = config["measure"], config["search"]["k"]
    dtype = "int4" if mode == "int4" else config["engine"]["corpus_dtype"]
    mm = PRODUCTS["tf32" if mode == "tf32" else "fp32"]
    rows = store.stored_rows(corpus, dtype)
    with torch.no_grad():
        ids, _ = exact.exact_topk(measure, weights, rows, queries, k, mm)
        got = measures.scores(measure, weights, rows[ids],
                              queries[:, None, :], mm)
        # best first by the control's own scores
        got, order = got.sort(dim=1, descending=True)
        ids = ids.gather(1, order)
    return ids, got


def run_control(config: dict, weights: dict, corpus: torch.Tensor,
                queries: torch.Tensor, mode: str) -> dict:
    ids, got = control_answers(config, weights, corpus, queries, mode)
    return judge.judge(config, weights, corpus, queries, ids, got)
