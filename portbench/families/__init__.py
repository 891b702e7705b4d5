"""Measure families, one plug-in each, found by the configuration's
``measure.family`` as the metric readers are found by their name:

- ``<family>.py``, the reference side: plain PyTorch, nothing of the
  program. It defines
  - ``make_weights(measure, seed, device)``: the measure's weights, one
    model from the configuration's ``model_seed``, laid out by the run's
    seed (the draws' streams are ``data.py``'s);
  - ``make_queries(config, n, device)``: the (n, d_q) float32 queries
    before the seed's permutation;
  - ``logits(measure, weights, x, q, mm)`` of item rows against query
    rows (leading dims broadcast), ``item_terms(measure, weights, rows,
    mm)`` and ``block_logits(measure, weights, items, q, lo, hi, mm)`` for
    the exact scan, and ``score(logit)``, the served score;
  - ``SCAN_BLOCKS``: the exact scan's (queries, items) a block;
  - ``forward_flops(measure)``, ``grad_flops(measure)``, and
    ``eval_bytes(config, row_bytes)``, ``grad_bytes(config, row_bytes)``:
    the work of one evaluation and one gradient;
  - where it runs kernels that ``roofline/kernels.json`` does not name:
    ``stage_kernels()``, {'grad': [...], 'measure': [...]}, substrings of
    the names of the device kernels that do those stages' work, and
    ``port_kernels()``, the kernels it adds to ``kernel_share``'s list.
- ``<family>_port.py``: ``make_measure(spec, weights, device)``, the port's
  ``Measure`` over the benchmark's weights. It imports the program; the
  reference and the roofline never load it.

A module ``_<name>.py`` holds what several families share."""
from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _load(module: str):
    if not (HERE / f"{module}.py").is_file():
        raise FileNotFoundError(
            f"measure family: no {HERE / (module + '.py')}")
    return importlib.import_module(f"{__name__}.{module}")


def reference(measure: dict):
    """The reference module of a measure configuration's family."""
    return _load(measure["family"])


def port(measure: dict):
    """The module that makes the port's measure of that family."""
    return _load(measure["family"] + "_port")
