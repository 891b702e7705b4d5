"""l2 proximity-graph construction (the SL2G indexing step).

The index is query-independent (pure l2 over base vectors): kNN
candidates (exact for small N: a blocked ``torch.matmul`` plus a top-k on
the device; NN-descent above ``exact_threshold``) -> occlusion pruning to
M -> symmetrize to 2M -> a padded int32 neighbor table (N, 2M), -1 padded.

NN-descent keeps its k-NN lists on the device and runs each iteration's
reverse sampling, candidate pools and join there as torch ops; only the
random stream is drawn on the host, consumed exactly as the JAX package's
``nn_descent`` consumes it (the initial ``integers``, the re-roll loop,
then one ``permutation`` per iteration), so both join the same candidate
pools from the same seed. The seed's per-node Python loops stay as
``occlusion_prune_ref`` / ``symmetrize_ref``, the parity oracles.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.graph.prune import occlusion_prune, symmetrize


@dataclasses.dataclass
class GraphIndex:
    neighbors: np.ndarray        # (N, M) int32, -1 padded
    entry: int                   # medoid entry point
    base: np.ndarray             # (N, D) float32 base vectors
    # (N,) bool delete flags (streaming deletes); None = nothing deleted.
    # The engine scores tombstoned rows -inf.
    tombstones: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return self.base.shape[0]

    @property
    def n_alive(self) -> int:
        if self.tombstones is None:
            return self.n
        return int(self.n - np.asarray(self.tombstones, bool).sum())

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def avg_degree(self) -> float:
        return float((self.neighbors >= 0).sum(1).mean())


def medoid(base: np.ndarray) -> int:
    mean = base.mean(axis=0)
    return int(np.argmin(((base - mean) ** 2).sum(axis=1)))


def brute_force_knn(base: np.ndarray, k: int, block: int = 2048,
                    queries: Optional[np.ndarray] = None,
                    device=DEFAULT_DEVICE) -> np.ndarray:
    """Exact kNN by blocked distance computation on ``device``. Returns
    (Nq, k) int32 ids nearest first, self excluded when queries is None."""
    dev = resolve_device(device)
    self_mode = queries is None
    queries = base if self_mode else queries
    base_t = torch.as_tensor(np.asarray(base, np.float32), device=dev)
    base_sq = torch.sum(base_t * base_t, dim=1)
    out = np.empty((queries.shape[0], k), np.int32)
    for s in range(0, queries.shape[0], block):
        e = min(s + block, queries.shape[0])
        qb = torch.as_tensor(np.asarray(queries[s:e], np.float32),
                             device=dev)
        d = (torch.sum(qb * qb, dim=1, keepdim=True)
             - (2.0 * qb) @ base_t.T + base_sq[None, :])
        if self_mode:
            r = torch.arange(e - s, device=dev)
            d[r, r + s] = float("inf")
        idx = torch.topk(d, k, dim=1, largest=False, sorted=True).indices
        out[s:e] = idx.cpu().numpy()
    return out


def knn_recall(base: np.ndarray, knn: np.ndarray, rows: np.ndarray,
               device=DEFAULT_DEVICE) -> tuple:
    """How near an approximate kNN table ``knn`` (N, k) comes to the exact
    kNN on the sampled ``rows``, the exact lists made on ``device``:
    (recall@k of the whole lists, the share of each row's exact 10 nearest
    among its list's first 10)."""
    k = knn.shape[1]
    exact = brute_force_knn(base, k + 1, queries=base[rows], device=device)
    hits_k = hits_10 = 0
    for r, ex, got in zip(rows, exact, knn[rows]):
        ex = ex[ex != r]
        hits_k += len(set(ex[:k].tolist()) & set(got.tolist()))
        hits_10 += len(set(ex[:10].tolist()) & set(got[:10].tolist()))
    return hits_k / (len(rows) * k), hits_10 / (len(rows) * 10)


# ---------------------------------------------------------------------------
# NN-descent (Dong et al.)
# ---------------------------------------------------------------------------

def _reverse_sample(fwd: torch.Tensor, n: int, sample: int,
                    rng: np.random.Generator) -> torch.Tensor:
    """Up to ``sample`` reverse neighbors per node, chosen uniformly among a
    node's in-edges: permute the edge list (the permutation drawn from
    ``rng`` on the host), stable counting sort by destination, keep each
    destination's first ``sample`` arrivals. fwd: (n, sf) ids on the
    device. Returns (n, sample) int64 on fwd's device, -1 padded."""
    return _reverse_sample_perm(fwd, rng.permutation(fwd.numel()), n,
                                sample)


def _reverse_sample_perm(fwd: torch.Tensor, perm: np.ndarray, n: int,
                         sample: int) -> torch.Tensor:
    """``_reverse_sample`` given the edge permutation, on fwd's device."""
    dev = fwd.device
    sf = fwd.shape[1]
    perm = torch.as_tensor(perm, device=dev)
    src = torch.div(perm, sf, rounding_mode="floor")   # row of edge perm[i]
    dst = fwd.reshape(-1).long()[perm]
    order = torch.sort(dst, stable=True).indices
    src, dst = src[order], dst[order]
    counts = torch.bincount(dst, minlength=n)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(dst.numel(), device=dev) - offsets[dst]
    keep = pos < sample
    out = torch.full((n, sample), -1, dtype=torch.int64, device=dev)
    out[dst[keep], pos[keep]] = src[keep]
    return out


def _join_block(base: torch.Tensor, rows: torch.Tensor, nbrs: torch.Tensor,
                dists: torch.Tensor, cand: torch.Tensor, k: int):
    """One NN-descent join/update over a node block: score the candidate
    pool against the block's points, merge with the current k-NN lists,
    keep the k closest unique ids ((Nb, k+C) working set). Ties keep the
    lower position first, as the JAX join's stable argsort and ``top_k``
    do. Returns (ids (Nb, k) int64, dists (Nb, k) float32)."""
    x = base[rows]                                        # (Nb, D)
    cvec = base[cand.clamp_min(0)]                        # (Nb, C, D)
    diff = cvec - x[:, None, :]
    cd = torch.sqrt(torch.sum(diff * diff, dim=-1))
    cd = cd.masked_fill((cand < 0) | (cand == rows[:, None]), float("inf"))
    ids = torch.cat([nbrs, cand], dim=1)                  # (Nb, k+C)
    d = torch.cat([dists, cd], dim=1)
    # dedup by id: stable sort by id, repeats after the first go to +inf;
    # the current neighbor entry (listed first) survives candidate repeats
    sid, order = torch.sort(ids, dim=1, stable=True)
    rep = torch.zeros_like(sid, dtype=torch.bool)
    rep[:, 1:] = (sid[:, 1:] == sid[:, :-1]) & (sid[:, 1:] >= 0)
    rep = torch.zeros_like(rep).scatter_(1, order, rep)  # back to ids' order
    d = d.masked_fill(rep, float("inf"))
    sd, sel = torch.sort(d, dim=1, stable=True)
    return ids.gather(1, sel[:, :k]), sd[:, :k]


def _row_dists(base: torch.Tensor, nbrs: torch.Tensor,
               block: int = 4096) -> torch.Tensor:
    """(N, k) l2 distance of each row to each of its listed neighbors."""
    out = torch.empty(nbrs.shape, dtype=torch.float32, device=base.device)
    for s in range(0, base.shape[0], block):
        e = min(s + block, base.shape[0])
        diff = base[s:e, None, :] - base[nbrs[s:e]]
        out[s:e] = torch.sqrt(torch.sum(diff * diff, dim=2))
    return out


def _candidates(fwd: torch.Tensor, rev: torch.Tensor, s: int, e: int,
                sample: int) -> torch.Tensor:
    """Rows s:e of the candidate pool: the forward neighbors of each
    sampled forward and reverse neighbor, then their reverse samples; a -1
    pool slot contributes -1 candidates. (e - s, (sf + sample) *
    (sf + sample)) int64."""
    sf = fwd.shape[1]
    pool = torch.cat([fwd[s:e], rev[s:e]], dim=1)         # (nb, sf+s)
    safe = pool.clamp_min(0)
    nb = e - s
    cand = torch.cat([fwd[safe].reshape(nb, -1), rev[safe].reshape(nb, -1)],
                     dim=1)
    bad = pool < 0
    mask = torch.cat([bad.repeat_interleave(sf, dim=1),
                      bad.repeat_interleave(sample, dim=1)], dim=1)
    return cand.masked_fill(mask, -1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def nn_descent(base: np.ndarray, k: int, n_iters: int = 8,
               sample: int = 10, seed: int = 0, block: int = 2048,
               device=DEFAULT_DEVICE,
               stats: Optional[dict] = None) -> np.ndarray:
    """NN-descent approximate kNN for large N. Per iteration: reverse-edge
    sampling builds each node's candidate pool (neighbors of its sampled
    forward + reverse neighbors), then the join merges the pool into the
    k-NN lists in node blocks, all on ``device``. Stops after ``n_iters``
    or when fewer than max(1, N/1000) entries changed. Returns (N, k)
    int32. ``stats`` (a dict), if given, receives the host and device
    seconds of the start (``init_host_s``: the random lists;
    ``init_device_s``: their distances) and of each iteration (``iters``:
    [{'host_s': the edge permutation, 'device_s': the reverse sample and
    the join, 'changed'}]); timing synchronizes the device at each stage
    boundary."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    base = np.asarray(base, np.float32)
    n = base.shape[0]
    t0 = time.perf_counter()
    rows = np.arange(n, dtype=np.int32)[:, None]
    nbrs_np = rng.integers(0, n, size=(n, k)).astype(np.int32)
    while True:                         # re-roll self references
        bad = nbrs_np == rows
        if not bad.any():
            break
        nbrs_np[bad] = rng.integers(0, n, size=int(bad.sum()))
    t1 = time.perf_counter()
    base_t = torch.as_tensor(base, device=dev)
    nbrs = torch.as_tensor(nbrs_np, device=dev).long()
    del nbrs_np
    d = _row_dists(base_t, nbrs)
    if stats is not None:
        _sync(dev)
        stats.update(init_host_s=t1 - t0,
                     init_device_s=time.perf_counter() - t1, iters=[])
    row_ids = torch.arange(n, device=dev)
    for _ in range(n_iters):
        t0 = time.perf_counter()
        fwd = nbrs[:, :sample].contiguous()               # (n, sf), sf<=s
        perm = rng.permutation(fwd.numel())               # host draw
        t1 = time.perf_counter()
        rev = _reverse_sample_perm(fwd, perm, n, sample)  # (n, s)
        new_nbrs = torch.empty_like(nbrs)
        new_d = torch.empty_like(d)
        for s in range(0, n, block):
            e = min(s + block, n)
            new_nbrs[s:e], new_d[s:e] = _join_block(
                base_t, row_ids[s:e], nbrs[s:e], d[s:e],
                _candidates(fwd, rev, s, e, sample), k)
        changed = int((new_nbrs != nbrs).sum())
        nbrs, d = new_nbrs, new_d
        if stats is not None:
            stats["iters"].append({"host_s": t1 - t0,
                                   "device_s": time.perf_counter() - t1,
                                   "changed": changed})
        if changed < max(1, n // 1000):
            break
    return nbrs.int().cpu().numpy()


# ---------------------------------------------------------------------------
# Python references (the seed implementations): parity oracles for the
# blocked kernels in graph/prune.py. Keep these loop-exact.
# ---------------------------------------------------------------------------

def occlusion_prune_ref(base: np.ndarray, knn: np.ndarray, m: int
                        ) -> np.ndarray:
    """HNSW 'select neighbors heuristic': keep candidate c only if it is
    closer to the node than to every already-kept neighbor (diversification).
    Returns (N, m) int32, -1 padded."""
    n = base.shape[0]
    out = np.full((n, m), -1, np.int32)
    for i in range(n):
        cand = knn[i]
        cd = np.linalg.norm(base[cand] - base[i], axis=1)
        order = np.argsort(cd)
        kept: list[int] = []
        for oi in order:
            c = int(cand[oi])
            if c < 0 or c == i:
                continue
            ok = True
            for kc in kept:
                if np.linalg.norm(base[c] - base[kc]) < cd[oi]:
                    ok = False
                    break
            if ok:
                kept.append(c)
                if len(kept) == m:
                    break
        # backfill with nearest unkept to reach m (keeps degree high)
        if len(kept) < m:
            for oi in order:
                c = int(cand[oi])
                if c >= 0 and c != i and c not in kept:
                    kept.append(c)
                    if len(kept) == m:
                        break
        out[i, : len(kept)] = kept
    return out


def symmetrize_ref(neighbors: np.ndarray, m_max: int) -> np.ndarray:
    """Add reverse edges up to m_max per node (improves navigability)."""
    n, m = neighbors.shape
    adj = [list(row[row >= 0]) for row in neighbors]
    for i in range(n):
        for j in neighbors[i]:
            if j >= 0 and len(adj[j]) < m_max and i not in adj[j]:
                adj[j].append(i)
    out = np.full((n, m_max), -1, np.int32)
    for i in range(n):
        row = adj[i][:m_max]
        out[i, : len(row)] = row
    return out


def build_l2_graph(base: np.ndarray, m: int = 24, k_construction: int = 100,
                   exact_threshold: int = 60_000, seed: int = 0,
                   impl: str = "blocked", device=DEFAULT_DEVICE,
                   stats: Optional[dict] = None) -> GraphIndex:
    """SL2G index build: l2 kNN (exact up to ``exact_threshold`` items,
    NN-descent above) -> occlusion prune to M -> symmetrize to 2M.

    ``impl``: 'blocked' (the device kernels) | 'ref' (the seed Python
    loops, kept for parity tests). ``stats`` (a dict), if given, receives
    the kNN table (``knn``), each stage's seconds (``knn_s``, ``prune_s``,
    ``symmetrize_s``) and, through NN-descent, its per-iteration times
    (``nn_descent``)."""
    if impl not in ("blocked", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    dev = resolve_device(device)
    base = np.asarray(base, np.float32)
    n = base.shape[0]
    kc = min(k_construction, n - 1)
    t0 = time.perf_counter()
    if n <= exact_threshold:
        knn = brute_force_knn(base, kc, device=dev)
    else:
        nd = {} if stats is not None else None
        knn = nn_descent(base, kc, seed=seed, device=dev, stats=nd)
        if stats is not None:
            stats["nn_descent"] = nd
    t1 = time.perf_counter()
    if impl == "blocked":
        # both kNN front-ends emit duplicate-free rows (exact top-k; the
        # NN-descent join dedups before its top-k)
        pruned = occlusion_prune(base, knn, m, assume_unique=True,
                                 device=dev)
        t2 = time.perf_counter()
        nbrs = symmetrize(pruned, 2 * m)
    else:
        pruned = occlusion_prune_ref(base, knn, m)
        t2 = time.perf_counter()
        nbrs = symmetrize_ref(pruned, 2 * m)
    if stats is not None:
        stats.update(knn=knn, knn_s=t1 - t0, prune_s=t2 - t1,
                     symmetrize_s=time.perf_counter() - t2)
    return GraphIndex(neighbors=nbrs, entry=medoid(base), base=base)
