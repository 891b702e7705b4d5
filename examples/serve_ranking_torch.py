"""End-to-end driver of the PyTorch port: train a DeepFM measure on synthetic
interactions, build the SL2G index over the learned item rows, then serve
batched ranking requests with GUITAR on the captured search programs and
spot-check recall against the exact top-k. The counterpart of
``examples/serve_ranking.py``, importing only ``repro_torch``.

    PYTHONPATH=src python examples/serve_ranking_torch.py --device cpu \
        [--items 20000 --users 2000 --steps 100 --ckpt /tmp/ckpt]

The measure is learned as the paper's protocol learns it (the JAX
package's ``benchmarks/common.build_system``): the user and item tables
start from ``make_interactions``' latent rows, batches of 1,024
interactions are drawn by ``np.random.default_rng(step)``, lr 3e-3 over a
cosine of twice the steps; the learned items are the base and the first
``n_test`` learned users the queries. Each step is a function that other
drivers call (``make_trainer`` / ``train_measure``, ``learned_system``,
``build_index``, ``label``, ``serve``).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.guitar_deepfm import measure_config
from repro_torch.core import (EngineOptions, SearchConfig, brute_force_topk,
                              deepfm_measure, make_corpus_store, recall,
                              search_measure)
from repro_torch.data import make_interactions
from repro_torch.graph import build_l2_graph
from repro_torch.models import deepfm as F
from repro_torch.serving import bucket_pad, latency_summary
from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

TRAIN_BATCH = 1024


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_trainer(n_users: int, n_items: int, steps: int, device="cuda",
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 10**9,
                 seed: int = 0, lr: float = 3e-3, data: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
    """The DeepFM recommender's trainer over ``make_interactions(n_users,
    n_items, 20 * n_items, seed)`` (or ``data``), restored from
    ``ckpt_dir``'s LATEST when there is one. Returns (trainer, cfg, data,
    batch_fn); ``trainer.run(batch_fn)`` trains."""
    dev = resolve_device(device)
    cfg = measure_config(n_users=n_users, n_items=n_items)
    gen = generator or torch.Generator().manual_seed(seed)
    params = F.init_model(gen, cfg, device=dev)
    if data is None:
        data = make_interactions(n_users, n_items, n_inter=20 * n_items,
                                 seed=seed)
    # copies (torch.tensor): the update runs in place, and must not write
    # into the caller's arrays
    params["users"] = torch.tensor(data["user_init"][:, :cfg.vec_dim],
                                   device=dev)
    params["items"] = torch.tensor(data["item_init"][:, :cfg.vec_dim],
                                   device=dev)

    def loss_fn(p, b):
        return F.interaction_loss(p, b["u"], b["i"], b["y"], cfg)

    def batch_fn(step):
        idx = np.random.default_rng(step).integers(
            0, data["user_ids"].shape[0], TRAIN_BATCH)
        return {k: torch.as_tensor(data[v][idx], device=dev) for k, v in (
            ("u", "user_ids"), ("i", "item_ids"), ("y", "labels"))}

    tr = Trainer(loss_fn, params, OptimizerConfig(lr=lr,
                                                  total_steps=2 * steps),
                 TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                               ckpt_dir=ckpt_dir))
    tr.maybe_restore()
    return tr, cfg, data, batch_fn


def train_measure(n_users: int, n_items: int, steps: int, device="cuda",
                  **kw):
    """``make_trainer`` (``kw`` goes to it), then its run."""
    tr, cfg, data, batch_fn = make_trainer(n_users, n_items, steps,
                                           device=device, **kw)
    tr.run(batch_fn)
    return tr, cfg, data, batch_fn


def learned_system(tr: Trainer, cfg, n_test: int):
    """(measure, base (N, D) float32 numpy, queries (n_test, D) numpy):
    the learned items and the first ``n_test`` learned users."""
    base = tr.params["items"].detach().cpu().numpy().astype(np.float32)
    queries = tr.params["users"][:n_test].detach().cpu().numpy().astype(
        np.float32)
    measure = deepfm_measure({"mlp": {k: [t.detach() for t in v] for k, v in
                                      tr.params["mlp"].items()}}, cfg)
    return measure, base, queries


def build_index(base: np.ndarray, m: int = 24, k_construction: int = 100,
                device="cuda", **kw):
    """The SL2G graph over ``base`` (exact kNN up to ``exact_threshold``
    items, NN-descent above; ``kw`` goes to ``build_l2_graph``)."""
    return build_l2_graph(base, m=m, k_construction=k_construction,
                          device=device, **kw)


def label(measure, base: np.ndarray, queries: np.ndarray, k: int = 10,
          device="cuda") -> np.ndarray:
    """Exact top-k ids of ``queries`` under the measure (brute force)."""
    dev = resolve_device(device)
    ids, _ = brute_force_topk(measure, torch.as_tensor(base, device=dev),
                              torch.as_tensor(queries, device=dev), k)
    return ids.cpu().numpy()


def serve(measure, graph, queries: np.ndarray, cfg: SearchConfig,
          options: Optional[EngineOptions] = None, store=None,
          batch: int = 32, device="cuda") -> dict:
    """Serve ``queries`` in batches of ``batch`` through ``search_measure``
    (captured programs on the card), one untimed warm-up batch first.
    Returns ids (Q, k), the mean #NN and #Grad per query, Total = #NN +
    2 #Grad, QPS and per-batch latency."""
    dev = resolve_device(device)
    options = options or EngineOptions()
    if store is None:
        store = make_corpus_store(graph.base, options.corpus_dtype,
                                  device=dev)
    nbrs = torch.as_tensor(graph.neighbors, device=dev)

    def run(q):
        qt, entries, n = bucket_pad(q, graph.entry, dev)
        res = search_measure(measure, store, nbrs, qt, entries, cfg, options)
        return type(res)(*(t[:n] for t in res))

    run(queries[:batch])
    _sync(dev)
    outs, lat = [], []
    for s in range(0, queries.shape[0], batch):
        t0 = time.perf_counter()
        outs.append(run(queries[s:s + batch]))
        _sync(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
    cat = {f: torch.cat([getattr(o, f) for o in outs]) for f in
           ("ids", "n_eval", "n_grad")}
    n_eval = float(cat["n_eval"].float().mean())
    n_grad = float(cat["n_grad"].float().mean())
    return {"ids": cat["ids"].cpu().numpy(), "n_eval": n_eval,
            "n_grad": n_grad, "total": n_eval + 2 * n_grad,
            "qps": queries.shape[0] / (sum(lat) / 1e3),
            **latency_summary(lat)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--items", type=int, default=20000)
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--serve-batches", type=int, default=4)
    ap.add_argument("--batch-queries", type=int, default=64)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: resume from it, save to it")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- 1. train the measure (DeepFM, paper Fig. 3 dims) -----------------
    tr, cfg, _, _ = train_measure(args.users, args.items, args.steps,
                                  device=dev, ckpt_dir=args.ckpt,
                                  ckpt_every=50)
    if tr.start_step:
        print(f"resumed training from checkpoint step {tr.start_step}")
    if tr.history:
        print(f"trained DeepFM on {dev}: loss {tr.history[0]['loss']:.3f} -> "
              f"{tr.history[-1]['loss']:.3f}")
    n_test = args.serve_batches * args.batch_queries
    measure, base, users = learned_system(tr, cfg, args.users)

    # ---- 2. index the learned item space -----------------------------------
    t0 = time.time()
    graph = build_index(base, m=24, k_construction=64, device=dev)
    print(f"SL2G index built in {time.time() - t0:.1f}s "
          f"(n={graph.n}, avg degree {graph.avg_degree:.1f})")

    # ---- 3. serve batched ranking requests ---------------------------------
    scfg = SearchConfig(k=10, ef=96, mode="guitar", budget=8, alpha=1.01)
    qidx = np.random.default_rng(100).integers(0, args.users, n_test)
    out = serve(measure, graph, users[qidx], scfg,
                batch=args.batch_queries, device=dev)
    # ---- 4. spot-check quality against the exact top-10 --------------------
    spot = min(64, n_test)
    true_ids = label(measure, base, users[qidx[:spot]], 10, device=dev)
    print(f"served {n_test} queries at {out['qps']:.0f} QPS (p50 "
          f"{out['p50_ms']:.1f} ms per batch of {args.batch_queries}), "
          f"recall@10 on {spot} = {recall(out['ids'][:spot], true_ids):.3f}, "
          f"Total = #NN + 2 #Grad = {out['total']:.0f} per query")


if __name__ == "__main__":
    main()
