"""A run's inputs, made on the run's device: the corpus, the queries and
the measure's weights, each from its own stream so that one size never
shifts another's numbers. Each is drawn once from a seed of the
configuration (``data_seed``, the measure's ``model_seed``); the weights
and the queries by the measure's family (``families/<family>.py``). The
corpus keeps that one order, so every seed builds the same index; the
queries and the measure's hidden units are laid out in an order drawn
from ``--seed``. Every seed serves the same data, index and function, so
the seed does not change the work. (With the corpus drawn from the run's
seed, the MLP cells' recall moved 14-16% from seed to seed; with only its
order drawn from the seed, still 4%: the index's reverse edges are kept
in id order, so each order built another graph.) The same seed gives the
same inputs; the program and the reference are handed the same
tensors."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from portbench import families

# stream ids: one generator per input
CORPUS, WEIGHTS, QUERIES, ARRIVALS, SAMPLE = range(5)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one input's generator, mixed from the run's seed
    (any whole number, also beyond 32 bits) and the stream id."""
    state = np.random.SeedSequence([int(seed) % 2**64, stream])
    return int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def normal_rows(seed: int, stream: int, n: int, dim: int,
                device) -> torch.Tensor:
    """(n, dim) float32 N(0, 1) rows, drawn on ``device`` in one call."""
    return torch.randn((n, dim), generator=generator(seed, stream, device),
                       dtype=torch.float32, device=device)


@dataclasses.dataclass
class Inputs:
    corpus: torch.Tensor      # (N, D) float32 on the device
    weights: dict             # the measure's weights on the device
    queries: torch.Tensor     # (P, d_q) float32 on the device: the pool or
    #                           the request stream's queries
    order: torch.Tensor       # (P,) int64: each query row's index in the
    #                           draw's own order


def seeded_order(n: int, head: int, seed: int, device) -> torch.Tensor:
    """A permutation of ``range(n)`` drawn from ``seed`` that keeps the
    first ``head`` indices in the first ``head`` places."""
    g = generator(seed, QUERIES, device)
    return torch.cat([
        torch.randperm(head, generator=g, device=device),
        head + torch.randperm(n - head, generator=g, device=device)])


def make_inputs(config: dict, n_queries: int, seed: int, device,
                head: Optional[int] = None) -> Inputs:
    """One corpus and one set of queries from the configuration's
    ``data_seed``: the corpus in that draw's order, the queries' rows in
    an order drawn from ``seed`` that keeps the draw's first ``head``
    rows (default all) in the first ``head`` places: an online run's
    window serves the same users for every seed, at other times."""
    family = families.reference(config["measure"])
    order = seeded_order(n_queries, n_queries if head is None else head,
                         seed, device)
    return Inputs(
        corpus=normal_rows(config["data_seed"], CORPUS, config["n_items"],
                           config["dim"], device),
        weights=family.make_weights(config["measure"], seed, device),
        queries=family.make_queries(config, n_queries, device)[order],
        order=order)
