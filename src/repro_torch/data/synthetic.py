"""Synthetic data generators: numpy copies of the JAX package's
``data/synthetic.py`` (the container is offline; scales and distributions
stand in for the public datasets). The same arguments give byte-identical
arrays in both packages.

- interactions: clustered user/item latent spaces with logistic click
  labels (stands in for Twitch / Amazon Movies&TV);
- recsys CTR batches (Criteo-like).

The token, graph and molecule generators wait for the LM and GNN families
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

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


def make_recsys_batch(batch: int, n_dense: int, cardinalities, seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
    sparse = np.stack([rng.integers(0, c, batch) for c in cardinalities],
                      axis=1).astype(np.int32)
    labels = (rng.random(batch) < 0.25).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "labels": labels}
