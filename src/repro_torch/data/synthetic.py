"""Synthetic data generators: numpy copies of the JAX package's
``data/synthetic.py`` (the container is offline; scales and distributions
stand in for the public datasets). The same arguments give byte-identical
arrays in both packages.

- interactions: clustered user/item latent spaces with logistic click
  labels (stands in for Twitch / Amazon Movies&TV);
- token streams for LM training; recsys CTR batches (Criteo-like);
- graphs with power-law degree for GNN shapes, and batches of small
  graphs (molecules).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def make_interactions(n_users: int, n_items: int, n_inter: int,
                      n_clusters: int = 16, dim: int = 40, seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    """Cluster-structured synthetic recommendation data. Users/items share a
    latent cluster space; click probability rises for matching clusters.
    Returns dict(user_ids, item_ids, labels, user_init, item_init)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    u_cl = rng.integers(0, n_clusters, n_users)
    i_cl = rng.integers(0, n_clusters, n_items)
    user_init = (0.5 * centers[u_cl]
                 + 0.5 * rng.normal(size=(n_users, dim))).astype(np.float32)
    item_init = (0.5 * centers[i_cl]
                 + 0.5 * rng.normal(size=(n_items, dim))).astype(np.float32)
    uid = rng.integers(0, n_users, n_inter).astype(np.int32)
    iid = rng.integers(0, n_items, n_inter).astype(np.int32)
    match = (u_cl[uid] == i_cl[iid]).astype(np.float32)
    p = 0.15 + 0.7 * match
    labels = (rng.random(n_inter) < p).astype(np.float32)
    return {"user_ids": uid, "item_ids": iid, "labels": labels,
            "user_init": user_init, "item_init": item_init}


def make_token_batch(batch: int, seq: int, vocab: int, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def make_recsys_batch(batch: int, n_dense: int, cardinalities, seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
    sparse = np.stack([rng.integers(0, c, batch) for c in cardinalities],
                      axis=1).astype(np.int32)
    labels = (rng.random(batch) < 0.25).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "labels": labels}


def make_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int = 40,
               seed: int = 0, power_law: bool = True
               ) -> Dict[str, np.ndarray]:
    """Random graph with (optionally) power-law degree distribution.
    Edge list is directed (src, dst); callers symmetrize if needed."""
    rng = np.random.default_rng(seed)
    if power_law:
        w = 1.0 / (np.arange(1, n_nodes + 1) ** 0.75)
        w /= w.sum()
        src = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int32)
    else:
        src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    train_mask = (rng.random(n_nodes) < 0.1)
    return {"src": src, "dst": dst, "feats": feats, "labels": labels,
            "train_mask": train_mask}


def make_batched_molecules(n_graphs: int, n_nodes: int, n_edges: int,
                           d_feat: int = 16, n_classes: int = 2, seed: int = 0
                           ) -> Dict[str, np.ndarray]:
    """Batch of small graphs as one block-diagonal edge list."""
    rng = np.random.default_rng(seed)
    srcs, dsts, gids = [], [], []
    for g in range(n_graphs):
        off = g * n_nodes
        srcs.append(rng.integers(0, n_nodes, n_edges) + off)
        dsts.append(rng.integers(0, n_nodes, n_edges) + off)
        gids.append(np.full(n_nodes, g))
    feats = rng.normal(size=(n_graphs * n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_graphs).astype(np.int32)
    return {
        "src": np.concatenate(srcs).astype(np.int32),
        "dst": np.concatenate(dsts).astype(np.int32),
        "graph_ids": np.concatenate(gids).astype(np.int32),
        "feats": feats, "labels": labels,
    }
