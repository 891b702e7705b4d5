"""GraphSAGE-style fanout neighbor sampler (minibatch_lg shape).

Host-side (numpy) — samplers are data pipeline, not accelerator work. A
copy of the JAX package's ``data/sampler.py``: the same seed gives the same
arrays, element for element. Builds a CSR view of the graph once, then
yields padded static-shape subgraph batches: seed nodes + fanout-sampled
k-hop neighborhood, remapped to local ids, with edge masks for padding
(static shapes keep the train step's tensors one size from batch to
batch).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SampledBatch:
    feats: np.ndarray       # (max_nodes, d)
    src: np.ndarray         # (max_edges,) local ids (0 when padded)
    dst: np.ndarray         # (max_edges,)
    edge_mask: np.ndarray   # (max_edges,) float32 0/1
    seed_local: np.ndarray  # (batch_nodes,) local indices of seed nodes
    labels: np.ndarray      # (batch_nodes,)
    n_nodes: int


class NeighborSampler:
    def __init__(self, src: np.ndarray, dst: np.ndarray, n_nodes: int,
                 fanouts: Sequence[int] = (15, 10), seed: int = 0):
        order = np.argsort(dst, kind="stable")
        self.nbr_src = src[order]
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        counts = np.bincount(dst, minlength=n_nodes)
        self.indptr[1:] = np.cumsum(counts)
        self.fanouts = tuple(fanouts)
        self.n_nodes = n_nodes
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (src, dst) edges: sampled in-neighbors -> node."""
        srcs, dsts = [], []
        for v in nodes:
            lo, hi = self.indptr[v], self.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(fanout, deg)
            sel = self.rng.choice(deg, size=take, replace=False)
            srcs.append(self.nbr_src[lo + sel])
            dsts.append(np.full(take, v, np.int32))
        if not srcs:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        return (np.concatenate(srcs).astype(np.int32),
                np.concatenate(dsts).astype(np.int32))

    def sample(self, seeds: np.ndarray, feats: np.ndarray, labels: np.ndarray,
               max_nodes: int, max_edges: int) -> SampledBatch:
        """k-hop fanout sampling from `seeds`, padded to static shapes."""
        frontier = np.asarray(seeds, np.int32)
        all_src, all_dst = [], []
        nodes = set(map(int, frontier))
        for f in self.fanouts:
            s, d = self._sample_neighbors(frontier, f)
            all_src.append(s)
            all_dst.append(d)
            new = set(map(int, s)) - nodes
            nodes |= new
            frontier = np.fromiter(new, np.int32) if new else np.empty(0, np.int32)
            if frontier.size == 0:
                break
        src = np.concatenate(all_src) if all_src else np.empty(0, np.int32)
        dst = np.concatenate(all_dst) if all_dst else np.empty(0, np.int32)

        node_list = np.fromiter(nodes, np.int32)
        node_list = np.concatenate([np.asarray(seeds, np.int32),
                                    np.setdiff1d(node_list, seeds)])
        node_list = node_list[:max_nodes]
        remap = -np.ones(self.n_nodes, np.int64)
        remap[node_list] = np.arange(node_list.size)

        keep = (remap[src] >= 0) & (remap[dst] >= 0)
        src, dst = remap[src[keep]], remap[dst[keep]]
        src, dst = src[:max_edges], dst[:max_edges]
        ne = src.size

        pf = np.zeros((max_nodes, feats.shape[1]), feats.dtype)
        pf[: node_list.size] = feats[node_list]
        ps = np.zeros(max_edges, np.int32)
        pd = np.zeros(max_edges, np.int32)
        ps[:ne], pd[:ne] = src, dst
        em = np.zeros(max_edges, np.float32)
        em[:ne] = 1.0
        return SampledBatch(
            feats=pf, src=ps, dst=pd, edge_mask=em,
            seed_local=remap[np.asarray(seeds)].astype(np.int32),
            labels=labels[np.asarray(seeds)].astype(np.int32),
            n_nodes=node_list.size)
