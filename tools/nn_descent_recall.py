#!/usr/bin/env python3
"""NN-descent's kNN recall against the exact kNN, by corpus size: the
port's ``nn_descent`` (and, with ``--jax``, the JAX package's, from the same
seed) over N N(0,1) items of D dimensions at ``build_l2_graph``'s settings
(k = k_construction, 8 iterations, 10 samples), scored on 1,000 sampled
rows (``repro_torch.graph.knn_recall``): recall@k of the whole list, and
the share of each row's exact 10 nearest found in its list's first 10.

    PYTHONPATH=src python tools/nn_descent_recall.py --n 13000 61000 \
        [--k 100] [--dim 40] [--jax] [--device cuda|cpu]

The port runs on the card by default; ``--device cpu`` runs it on the CPU,
which is where the comparison with the JAX package (``--jax``, CPU only)
is made. Prints one JSON line per N and package; "seconds" is the
function's wall time on the device named.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, nargs="+", required=True)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--dim", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jax", action="store_true",
                    help="also run the JAX package's nn_descent")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the port's run and of the exact "
                         "kNN; the default needs a CUDA card")
    args = ap.parse_args()
    from repro_torch.graph import knn_recall, nn_descent
    for n in args.n:
        base = np.random.default_rng(args.seed).normal(
            size=(n, args.dim)).astype(np.float32)
        rows = np.sort(np.random.default_rng(1).choice(n, 1000,
                                                       replace=False))
        runs = [("port", lambda: nn_descent(base, args.k, seed=args.seed,
                                            device=args.device))]
        if args.jax:
            from repro.graph.build import nn_descent as jax_nn_descent
            runs.append(("jax", lambda: jax_nn_descent(base, args.k,
                                                       seed=args.seed)))
        lists = {}
        for name, fn in runs:
            t0 = time.perf_counter()
            lists[name] = fn()
            secs = time.perf_counter() - t0
            rk, r10 = knn_recall(base, lists[name], rows, device=args.device)
            print(json.dumps({"package": name, "n": n, "dim": args.dim,
                              "k": args.k, "device": args.device,
                              "recall_at_k": rk, "recall_10nn": r10,
                              "seconds": secs}), flush=True)
        if len(lists) == 2:
            same = float((lists["port"] == lists["jax"]).all(1).mean())
            print(json.dumps({"n": n, "rows_identical": same}), flush=True)


if __name__ == "__main__":
    main()
