"""The general traffic generator. A mix file holds parameters only:

- ``kind: "bulk"``: a closed loop over a pool of ``pool`` queries, in
  one-shot batches of ``batch``, back to back, cycling through the pool;
  ``trace_batches`` more batches are profiled after the window.
- ``kind: "online"``: open-loop arrivals at ``rate_qps`` from independent
  users, each request a fresh query, the Poisson gaps one set (from
  ``gap_seed``) in an order drawn from the run's seed; ``runtime`` holds
  the serving runtime's settings (lanes, steps a tick, queue bound);
  ``trace_s`` more seconds of the same arrivals are profiled after the
  window.

Every run of a mix offers the same amount of work: the window holds
exactly round(rate_qps x seconds) requests."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"traffic mix {name!r}: no {path}")
    mix = json.loads(path.read_text())
    if mix.get("kind") not in ("bulk", "online"):
        raise ValueError(f"traffic mix {name!r}: kind must be bulk or "
                         f"online, got {mix.get('kind')!r}")
    return mix


def poisson_arrivals(n: int, qps: float, seed: int = 0) -> np.ndarray:
    """Open-loop Poisson arrival offsets (seconds): cumsum of Exp(1/qps).
    A copy of the program's ``serving/runtime.py::poisson_arrivals``."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=n))


def arrivals(mix: dict, seconds: float,
             rng: np.random.Generator) -> np.ndarray:
    """Offsets (s) of the round(rate_qps x seconds) requests of a window
    of ``seconds``: one set of Poisson gaps (``poisson_arrivals`` with the
    mix's ``gap_seed``) in an order drawn from ``rng``, so that every seed
    offers the same gaps in another order; scaled so that the last one
    falls at the window's end."""
    rate = float(mix["rate_qps"])
    n = max(1, int(round(rate * seconds)))
    gaps = np.diff(poisson_arrivals(n, rate, seed=mix["gap_seed"]),
                   prepend=0.0)
    t = np.cumsum(rng.permutation(gaps))
    return t * (seconds / t[-1])
