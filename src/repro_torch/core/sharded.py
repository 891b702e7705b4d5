"""Corpus-sharded search: the corpus (base vectors + subgraph) is split
into S random partitions, each searched on its own by the same batched
GUITAR search for the whole query block, and the per-shard top-k are
merged. Partition-local graphs lose cross-partition edges; with random
partitioning each shard's subcorpus stays uniformly distributed, the
standard sharded-ANN design.

The JAX package runs the shards under ``shard_map`` over a mesh's
``model`` axis; the port takes a list of torch devices instead: shard s
lives on ``devices[s % len(devices)]`` and the merge runs on
``devices[0]``. The per-shard searches run one after another from the
host (each as its engine's captured programs on a card), so shards on
different cards do not overlap in time.

Each shard's search is cached on its engine by the identity of its
store, neighbor table and params (``ExpansionEngine.search_program``), so
the placed per-shard tensors are cached on the ``ShardedIndex``: a batch
shape costs S programs, and ``PROGRAM_CACHE`` must hold S per shape in
use or batches recapture. For the same reason no params are copied here:
a shard searches with ``measure.params``, which must live on its device,
or with the copy the caller placed there once (``params_by_device``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.corpus import (AnyCorpusStore, CorpusStore,
                                     make_corpus_store)
from repro_torch.core.engine import (EngineOptions, SearchConfig,
                                     SearchResult, build_engine_from_fn)
from repro_torch.core.measures import Measure
from repro_torch.graph.build import build_l2_graph


@dataclasses.dataclass
class ShardedIndex:
    """Host-side container: per-partition padded arrays stacked on axis 0.
    Padded rows repeat their shard's row 0 and have global id -1."""
    base: np.ndarray        # (S, Np, D)
    neighbors: np.ndarray   # (S, Np, B)
    entries: np.ndarray     # (S,)
    global_ids: np.ndarray  # (S, Np) partition row -> corpus id
    n_shards: int
    # device copies, made once: the same objects on every call keep the
    # engines' cached programs valid. _graphs by (shard, device), _stores
    # by (corpus dtype, device list)
    _graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)
    _stores: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    def placed(self, s: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shard ``s``'s neighbor table and global ids on ``device``
        (int64 tensors, made once)."""
        dev = torch.device(device)
        key = (s, str(dev))
        if key not in self._graphs:
            self._graphs[key] = (
                torch.as_tensor(self.neighbors[s], device=dev).long(),
                torch.as_tensor(self.global_ids[s], device=dev).long())
        return self._graphs[key]

    def stores(self, corpus_dtype: str = "float32",
               devices: Optional[Sequence] = None) -> List[CorpusStore]:
        """The per-shard stores (``shard_stores``) on ``devices``, made
        once per dtype and device list."""
        devs = _devices(devices)
        key = (corpus_dtype, tuple(str(d) for d in devs))
        if key not in self._stores:
            self._stores[key] = shard_stores(self, corpus_dtype,
                                             devices=devs)
        return self._stores[key]


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    if devices is None:
        devices = [DEFAULT_DEVICE]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("devices must name at least one device")
    return devs


def build_sharded_index(base: np.ndarray, n_shards: int, m: int = 24,
                        k_construction: int = 64, seed: int = 0,
                        impl: str = "blocked",
                        device=DEFAULT_DEVICE) -> ShardedIndex:
    """S random partitions of ``ceil(N / S)`` rows (the JAX package's
    permutation from ``seed``), each with its own l2 graph (built on
    ``device``, shard s from ``seed + s``); neighbor tables padded to the
    widest shard's degree."""
    rng = np.random.default_rng(seed)
    n = base.shape[0]
    perm = rng.permutation(n)
    per = -(-n // n_shards)
    bases, nbrs, entries, gids = [], [], [], []
    for s in range(n_shards):
        ids = perm[s * per: (s + 1) * per]
        pad = per - ids.size
        if pad:  # pad vectors by repeating row 0 of the shard...
            ids = np.concatenate([ids, np.repeat(ids[:1], pad)])
        sub = base[ids]
        if pad:  # ...but padded rows get global id -1, never row 0's id,
            # or the merge could return one corpus id twice
            ids = ids.copy()
            ids[per - pad:] = -1
        g = build_l2_graph(sub, m=m, k_construction=k_construction,
                           seed=seed + s, impl=impl, device=device)
        bases.append(g.base)
        nbrs.append(g.neighbors)
        entries.append(g.entry)
        gids.append(ids.astype(np.int32))
    B = max(x.shape[1] for x in nbrs)
    nbrs = [np.pad(x, ((0, 0), (0, B - x.shape[1])), constant_values=-1)
            for x in nbrs]
    return ShardedIndex(
        base=np.stack(bases), neighbors=np.stack(nbrs),
        entries=np.array(entries, np.int32), global_ids=np.stack(gids),
        n_shards=n_shards)


def merge_topk(all_ids: torch.Tensor, all_scores: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k: (Q, S, k) ids / scores -> (Q, k).

    Invalid candidates (id < 0: pool padding or partition-padding rows)
    score -inf so they never displace a real result; slots still -inf
    after the merge report id -1. Ties keep the lower flat position first,
    as ``lax.top_k`` does (a stable descending sort). Real ids appear at
    most once across shards, so the output is duplicate-free."""
    Q = all_ids.shape[0]
    flat_i = all_ids.reshape(Q, -1)
    flat_s = all_scores.reshape(Q, -1).masked_fill(flat_i < 0,
                                                   float("-inf"))
    v, ix = torch.sort(flat_s, dim=1, descending=True, stable=True)
    v, ix = v[:, :k], ix[:, :k]
    ids = flat_i.gather(1, ix)
    return torch.where(torch.isfinite(v), ids, torch.full_like(ids, -1)), v


def empty_topk(k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The canonical no-result top-k (ids -1, scores -inf): what
    ``merge_topk`` reports when every candidate is invalid."""
    return (np.full((k,), -1, np.int32),
            np.full((k,), -np.inf, np.float32))


def shard_stores(index: ShardedIndex, corpus_dtype: str = "float32",
                 residency=None,
                 devices: Optional[Sequence] = None) -> List[AnyCorpusStore]:
    """Per-shard corpus stores, shard s on ``devices[s % len(devices)]``
    (default: the card): each partition quantizes its own rows. Under a
    ``paged`` policy each partition pages its rows from host memory on its
    own pager: S pagers, each with its own LRU budget."""
    devs = _devices(devices)
    return [make_corpus_store(index.base[s], corpus_dtype,
                              device=devs[s % len(devs)],
                              residency=residency)
            for s in range(index.n_shards)]


def _tree_device(tree) -> Optional[torch.device]:
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        dev = _tree_device(v)
        if dev is not None:
            return dev
    return None


def _device_key(device) -> str:
    """``device`` by name, a card without an index as the current one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def shard_params(params, device: torch.device,
                 params_by_device: Optional[Mapping]) -> Any:
    """The params the shards on ``device`` search with:
    ``params_by_device[device]`` where the caller gave it, else
    ``params``, which must live on ``device``."""
    if params_by_device is not None:
        placed = {_device_key(d): p for d, p in params_by_device.items()}
        if _device_key(device) not in placed:
            raise ValueError(f"params_by_device has no params for "
                             f"{str(device)!r} (it has {sorted(placed)})")
        return placed[_device_key(device)]
    have = _tree_device(params)
    if have is not None and have != device:
        raise ValueError(
            f"the params live on {str(have)!r} and a shard's store on "
            f"{str(device)!r}: place a copy of the params on each device "
            f"once and pass them as params_by_device={{device: params}}")
    return params


def _search_shards(engine, shards, queries: torch.Tensor, k: int,
                   out_dev, iter_caps=None, taus=None) -> SearchResult:
    """The body shared by the sharded searches. ``shards`` yields, shard
    by shard, (params, store, neighbors, global ids, entries (Q,)), each
    on its store's device; every shard is searched in turn by ``engine``,
    its local ids mapped through the global ids (padded rows -> -1), and
    the per-shard top-k merged (``merge_topk``) on ``out_dev``: n_eval and
    n_grad summed (the work billed to a query), n_iters maxed (shards
    expand in parallel)."""
    Q = queries.shape[0]
    per_ids, per_scores = [], []
    n_eval = torch.zeros((Q,), dtype=torch.int32, device=out_dev)
    n_grad = torch.zeros_like(n_eval)
    n_iters = torch.zeros_like(n_eval)
    for params, store, nbrs, gids, entries in shards:
        dev = store.device
        res = engine.search(params, store, nbrs, queries.to(dev), entries,
                            iter_caps=None if iter_caps is None
                            else torch.as_tensor(iter_caps).to(dev),
                            taus=None if taus is None
                            else torch.as_tensor(taus).to(dev))
        local = res.ids.clamp_min(0)
        per_ids.append(torch.where(res.ids >= 0, gids[local],
                                   torch.full_like(res.ids, -1)).to(out_dev))
        per_scores.append(res.scores.to(out_dev))
        n_eval += res.n_eval.to(out_dev)
        n_grad += res.n_grad.to(out_dev)
        n_iters = torch.maximum(n_iters, res.n_iters.to(out_dev))
    ids, scores = merge_topk(torch.stack(per_ids, dim=1),
                             torch.stack(per_scores, dim=1), k)
    return SearchResult(ids, scores, n_eval, n_grad, n_iters)


def sharded_search_stores(measure: Measure,
                          stores: List[AnyCorpusStore],
                          index: ShardedIndex, queries, cfg: SearchConfig,
                          options: EngineOptions = EngineOptions(),
                          iter_caps=None, taus=None,
                          params_by_device: Optional[Mapping] = None
                          ) -> SearchResult:
    """Sharded search against per-shard stores, each searched on its own
    store's device: per-shard ``engine.search``, local ids mapped to
    global ids (padded rows -> -1), ``merge_topk`` on the first store's
    device; counters summed (n_eval, n_grad: the work billed to a query)
    and maxed (n_iters: shards expand in parallel). ``iter_caps`` /
    ``taus`` (Q,) apply to every shard. Each shard searches with the
    params on its device (``measure.params``, or ``params_by_device``
    where stores lie on other devices than the params)."""
    meta = getattr(measure, "meta", None)
    engine = build_engine_from_fn(measure.score_fn, cfg, options,
                                  meta=tuple(meta) if meta is not None
                                  else None)
    queries = torch.as_tensor(queries, dtype=torch.float32)
    Q = queries.shape[0]

    def shards():
        for s, store in enumerate(stores):
            dev = store.device
            nbrs, gids = index.placed(s, dev)
            yield (shard_params(measure.params, dev, params_by_device),
                   store, nbrs, gids,
                   torch.full((Q,), int(index.entries[s]),
                              dtype=torch.int64, device=dev))

    return _search_shards(engine, shards(), queries, cfg.k,
                          stores[0].device, iter_caps, taus)


def make_sharded_search(score_fn, cfg: SearchConfig,
                        options: EngineOptions = EngineOptions(),
                        meta=None):
    """The JAX package's ``make_sharded_search`` without the mesh: returns
    ``fn(measure_params, base (S, Np, D), nbrs (S, Np, deg), entries (S,),
    gids (S, Np), queries (Q, D)) -> SearchResult``. The S shards are
    searched one after another on the queries' device by one engine
    (``meta``, the measure's ``(family, *args)``, resolves its kernel
    bundle; None = the generic stages), local ids mapped through ``gids``
    (-1 for padded rows), the per-shard top-k merged with ``merge_topk``;
    n_eval and n_grad summed over shards, n_iters maxed, as
    ``sharded_search_stores`` does (the same body).

    Each shard's store (in ``options.corpus_dtype``) and neighbor table
    are made on the first call with given ``base``, ``nbrs`` and ``gids``
    and kept while the same tensors come back, so the engine's captured
    programs stay valid from batch to batch."""
    engine = build_engine_from_fn(score_fn, cfg, options, meta=meta)
    placed: dict = {}

    def shard_tensors(base, nbrs, gids, dev):
        key = (id(base), id(nbrs), id(gids), base.data_ptr(),
               nbrs.data_ptr(), gids.data_ptr(), str(dev))
        if key not in placed:
            placed.clear()
            placed[key] = ((base, nbrs, gids), [
                (make_corpus_store(base[s], options.corpus_dtype,
                                   device=dev),
                 nbrs[s].to(dev, torch.int64), gids[s].to(dev, torch.int64))
                for s in range(base.shape[0])])
        return placed[key][1]

    def fn(measure_params, base, nbrs, entries, gids, queries):
        dev = queries.device
        Q = queries.shape[0]
        shards = [(measure_params, store, nb, gid,
                   entries[s].to(dev, torch.int64).expand(Q).contiguous())
                  for s, (store, nb, gid) in enumerate(
                      shard_tensors(base, nbrs, gids, dev))]
        return _search_shards(engine, shards, queries.to(torch.float32),
                              cfg.k, dev)

    return fn


def sharded_search_host(measure: Measure, index: ShardedIndex, queries,
                        cfg: SearchConfig, devices: Optional[Sequence] = None,
                        options: EngineOptions = EngineOptions(),
                        params_by_device: Optional[Mapping] = None
                        ) -> SearchResult:
    """Place the shards (shard s on ``devices[s % len(devices)]``, default
    the card; stores quantized per partition in ``options.corpus_dtype``
    and cached on the index), search each, merge on ``devices[0]``: the
    counterpart of the JAX ``shard_map`` path. Shards on a device other
    than the params' search with ``params_by_device[device]``. Returns the
    merged ids and scores and the per-query counters as tensors on
    ``devices[0]``."""
    stores = index.stores(options.corpus_dtype, devices)
    return sharded_search_stores(measure, stores, index, queries, cfg,
                                 options, params_by_device=params_by_device)
