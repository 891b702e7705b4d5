"""Search API for fast neural ranking, the JAX package's
``core/search.py``:

- ``search`` / ``search_measure``: the batched search on the expansion
  engine (``core/engine.py``), for a bare ``score_fn`` or a ``Measure``;
- ``search_legacy``: the original lane-major searcher (per query: pop the
  best unexpanded node, rank its fresh neighbors by ``rank_and_prune``,
  score the top C, insert), kept as the A/B baseline of the engine. It
  calls ``score_fn`` directly and launches none of the port's kernels;
- ``rank_and_prune``: the single-lane Eq. 3/4 ranking primitive;
- ``brute_force_topk``: the exact ground-truth labeler, and ``recall``.
"""
from __future__ import annotations

import collections
import functools
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.corpus import CorpusStore, PagedCorpusStore
from repro_torch.core.engine import (PROGRAM_CACHE, SYNC_EVERY,
                                     EngineOptions, EngineState,
                                     SearchConfig, SearchResult, bit_set_rows,
                                     bit_test_rows, build_engine,
                                     build_engine_from_fn,
                                     default_insert_stage, _tensor_ptrs)
from repro_torch.core.measures import Measure
from repro_torch.core.program import StateProgram

_NEG_INF = float("-inf")


def search(score_fn, params, base, neighbors, queries, entries,
           cfg: SearchConfig,
           options: Optional[EngineOptions] = None) -> SearchResult:
    """Batched GUITAR/SL2G search of a bare ``score_fn`` on the engine
    (``build_engine_from_fn``: the generic stages, or the kernels of
    ``options``' bundle when none is given a ``meta``). score_fn: (params,
    x (..., D), q (..., Dq)) -> scores over the leading dims; base: (N, D)
    or a store; neighbors: (N, B) -1-padded; queries: (Q, Dq) on the
    search device; entries: (Q,)."""
    eng = build_engine_from_fn(score_fn, cfg, options or EngineOptions())
    return eng.search(params, base, neighbors, queries, entries)


def search_measure(measure: Measure, base, neighbors, queries, entries,
                   cfg: SearchConfig,
                   options: Optional[EngineOptions] = None,
                   capture: bool = True) -> SearchResult:
    """Batched GUITAR/SL2G search with the measure's registered kernels;
    ``options`` selects the fused stages and the corpus residency. On the
    card the search runs as captured programs (``capture=False``: the
    eager host loop)."""
    eng = build_engine(measure, cfg, options or EngineOptions())
    return eng.search(measure.params, base, neighbors, queries, entries,
                      capture=capture)


# ---------------------------------------------------------------------------
# the legacy lane-major searcher
# ---------------------------------------------------------------------------

def _rank_and_prune_rows(diffs, grad, valid, budget: int, alpha: float,
                         rank_by: str, adaptive: bool):
    """``rank_and_prune`` over a leading lane dim: diffs (Q, B, D), grad
    (Q, D), valid (Q, B) -> (sel_idx (Q, C), sel_mask (Q, C))."""
    eps = 1e-12
    inf = float("inf")
    gnorm = torch.linalg.vector_norm(grad, dim=-1, keepdim=True) + eps
    dot = torch.matmul(diffs, grad[..., None])[..., 0]          # (Q, B)
    dnorm = torch.linalg.vector_norm(diffs, dim=-1) + eps
    if rank_by == "angle":
        cosv = torch.clamp(dot / (dnorm * gnorm), -1.0, 1.0)
        key = torch.arccos(cosv).masked_fill(~valid, inf)   # smaller = better
        theta = key.min(dim=-1, keepdim=True).values
        in_range = key <= alpha * theta + eps
        neg_key = -key
    else:  # projection (Eq. 4): larger is better
        key = (dot / gnorm).masked_fill(~valid, -inf)
        theta = key.max(dim=-1, keepdim=True).values
        # the bound relaxes (flips) when theta < 0
        bound = torch.where(theta >= 0, theta / alpha, theta * alpha)
        in_range = key >= bound - eps
        neg_key = key
    C = min(budget, diffs.shape[-2])
    # top-C, the lower slot first on ties (lax.top_k's order)
    sel_idx = torch.sort(neg_key, dim=-1, descending=True,
                         stable=True).indices[..., :C]
    sel_mask = valid.gather(-1, sel_idx)
    if adaptive:
        sel_mask = sel_mask & in_range.gather(-1, sel_idx)
    return sel_idx, sel_mask


def rank_and_prune(diffs: torch.Tensor, grad: torch.Tensor,
                   valid: torch.Tensor, budget: int, alpha: float,
                   rank_by: str, adaptive: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """diffs: (B, D) = x' - x; grad: (D,) = df/dx; valid: (B,) bool.

    Returns (sel_idx (C,), sel_mask (C,)): the top-C neighbor slots by the
    ranking criterion (the smallest angle, Eq. 3, or the largest
    projection, Eq. 4; ties to the lower slot) and the adaptive alpha*theta
    mask over them (``adaptive``; else validity alone)."""
    sel_idx, sel_mask = _rank_and_prune_rows(diffs[None], grad[None],
                                             valid[None], budget, alpha,
                                             rank_by, adaptive)
    return sel_idx[0], sel_mask[0]


class LegacySearcher:
    """``search_legacy`` for one ``(score_fn, cfg)``: the lane-major loop
    of the JAX ``_search_one`` over every lane at once, each update gated
    by the lane's ``done`` as the vmapped ``while_loop`` gates it. It runs
    as a program (``core/program.py``) of two routines over an
    ``EngineState``: ``init`` (the pools seeded with the entries) and
    ``chunk`` (``SYNC_EVERY`` gated iterations), ``done`` read once per
    chunk; on the card each is a captured CUDA graph (``capture=False``:
    the same chunks eagerly). Programs are cached per batch shape and by
    the identity of params, base and graph, as the engine's are."""

    def __init__(self, score_fn, cfg: SearchConfig):
        self.score_fn = score_fn
        self.cfg = cfg
        self.programs: collections.OrderedDict = collections.OrderedDict()
        # totals over ``search`` calls, the engine's ``stats`` keys: steps
        # (iterations run), program runs, host seconds issuing them
        self.stats = {"searches": 0, "steps": 0, "runs": 0, "issue_s": 0.0,
                      "programs": 0}

    def _score(self, params, x, q):
        return self.score_fn(params, x, q).float()

    def init_state(self, params, base, queries, entries) -> EngineState:
        """Each pool seeded with its entry (one score), as ``_search_one``
        seeds one lane."""
        cfg, dev = self.cfg, queries.device
        Q, ef = queries.shape[0], cfg.ef
        entries = entries.long()
        e_scores = self._score(params, base[entries], queries)
        pool_scores = torch.full((Q, ef), _NEG_INF, dtype=torch.float32,
                                 device=dev)
        pool_scores[:, 0] = e_scores
        pool_ids = torch.full((Q, ef), -1, dtype=torch.int64, device=dev)
        pool_ids[:, 0] = entries
        pool_expanded = torch.ones((Q, ef), dtype=torch.bool, device=dev)
        pool_expanded[:, 0] = False
        nwords = (base.shape[0] + 31) // 32
        visited = bit_set_rows(
            torch.zeros((Q, nwords), dtype=torch.int64, device=dev),
            entries[:, None], torch.ones((Q, 1), dtype=torch.bool,
                                         device=dev))
        zeros = torch.zeros((Q,), dtype=torch.int32, device=dev)
        return EngineState(
            pool_scores, pool_ids, pool_expanded, visited, zeros + 1,
            zeros.clone(), zeros.clone(),
            torch.zeros((Q,), dtype=torch.bool, device=dev),
            torch.full((Q,), cfg.iters(), dtype=torch.int32, device=dev),
            torch.zeros((Q,), dtype=torch.float32, device=dev))

    def iteration(self, params, base, neighbors, queries,
                  s: EngineState) -> EngineState:
        """One gated body of ``_search_one``'s ``while_loop`` on every
        lane: lanes already done keep their whole state."""
        cfg = self.cfg
        cand = s.pool_scores.masked_fill(s.pool_expanded, _NEG_INF)
        slot = torch.argmax(cand, dim=1)              # first maximum
        has_frontier = torch.isfinite(cand.gather(1, slot[:, None])[:, 0])
        fid = s.pool_ids.gather(1, slot[:, None])[:, 0].clamp_min(0)
        expanded = s.pool_expanded.scatter(1, slot[:, None], True)
        x = base[fid]                                    # (Q, D)
        nbr = neighbors[fid].long()                      # (Q, B)
        valid = (nbr >= 0) & ~bit_test_rows(s.visited, nbr) \
            & has_frontier[:, None]
        nvecs = base[nbr.clamp_min(0)]                   # (Q, B, D)
        if cfg.mode == "guitar":
            grad = torch.func.vmap(torch.func.grad(
                lambda xx, qq: self._score(params, xx, qq)))(x, queries)
            sel_idx, sel_mask = _rank_and_prune_rows(
                nvecs - x[:, None, :], grad, valid, cfg.budget, cfg.alpha,
                cfg.rank_by, cfg.adaptive)
            sel_ids = nbr.gather(1, sel_idx)
            D = nvecs.shape[2]
            sel_vecs = nvecs.gather(1, sel_idx[..., None].expand(
                -1, -1, D))
            n_grad = s.n_grad + has_frontier.int()
        else:  # sl2g: every neighbor
            sel_ids, sel_mask, sel_vecs = nbr, valid, nvecs
            n_grad = s.n_grad
        scores = self._score(params, sel_vecs, queries[:, None, :])
        scores = scores.masked_fill(~sel_mask, _NEG_INF)
        new = s._replace(
            pool_expanded=expanded,
            visited=bit_set_rows(s.visited, sel_ids, sel_mask),
            n_grad=n_grad,
            n_eval=s.n_eval + sel_mask.sum(dim=1).int(),
            n_iters=s.n_iters + has_frontier.int())
        new = default_insert_stage(new, sel_ids, scores, sel_mask)
        exhausted = ~torch.any(~new.pool_expanded & torch.isfinite(
            new.pool_scores), dim=1)
        new = new._replace(done=exhausted | (new.n_iters >= cfg.iters())
                           | ~has_frontier)

        def gate(n, o):
            return torch.where(s.done.view((-1,) + (1,) * (n.dim() - 1)),
                               o, n)
        return EngineState(*(gate(n, o) for n, o in zip(new, s)))

    def program(self, params, base, neighbors, queries,
                capture: bool = True) -> StateProgram:
        """The cached program for this batch shape, params, base and graph
        (by identity; the params' tensors by pointer)."""
        dev = queries.device
        Q, Dq = queries.shape
        key = (Q, Dq, str(dev), bool(capture), id(params), id(base),
               id(neighbors), _tensor_ptrs(params))
        if key in self.programs:
            self.programs.move_to_end(key)
            return self.programs[key]
        base_t = torch.as_tensor(base, dtype=torch.float32, device=dev)
        nbrs = torch.as_tensor(neighbors, device=dev)
        idle = self.init_state(params, base_t,
                               torch.zeros((Q, Dq), device=dev),
                               torch.zeros((Q,), dtype=torch.int64,
                                           device=dev))
        bufs = {"queries": torch.zeros((Q, Dq), dtype=torch.float32,
                                       device=dev),
                "entries": torch.zeros((Q,), dtype=torch.int64, device=dev)}
        prog = StateProgram(idle, bufs, capture)
        prog.held = (params, base, neighbors, base_t, nbrs)
        prog.add("init", lambda b, s: (self.init_state(
            params, base_t, b["queries"], b["entries"]), {}))

        def chunk(b, s):
            for _ in range(SYNC_EVERY):
                s = self.iteration(params, base_t, nbrs, b["queries"], s)
            return s, {}
        prog.add("chunk", chunk)
        self.programs[key] = prog
        self.stats["programs"] += 1
        while len(self.programs) > PROGRAM_CACHE:
            self.programs.popitem(last=False)
        return prog

    def search(self, params, base, neighbors, queries, entries,
               capture: bool = True) -> SearchResult:
        prog = self.program(params, base, neighbors, queries, capture)
        t0 = time.perf_counter()
        prog.load(queries=queries, entries=entries)
        prog.run("init")
        issue = time.perf_counter() - t0
        # every live lane expands or finishes each iteration, so all lanes
        # are done after iters() + 1 of them; the check is a guard
        limit = self.cfg.iters() + 1 + SYNC_EVERY
        steps = 0
        while True:
            t0 = time.perf_counter()
            prog.run("chunk")
            issue += time.perf_counter() - t0
            steps += SYNC_EVERY
            if bool(prog.state.done.all()):
                break
            if steps >= limit:
                raise RuntimeError(f"legacy search did not converge in "
                                   f"{steps} iterations")
        st = self.stats
        st["searches"] += 1
        st["steps"] += steps
        st["runs"] += steps // SYNC_EVERY + 1
        st["issue_s"] += issue
        k, st = self.cfg.k, prog.state
        return SearchResult(ids=st.pool_ids[:, :k].clone(),
                            scores=st.pool_scores[:, :k].clone(),
                            n_eval=st.n_eval.clone(),
                            n_grad=st.n_grad.clone(),
                            n_iters=st.n_iters.clone())


@functools.lru_cache(maxsize=32)
def legacy_searcher(score_fn, cfg: SearchConfig) -> LegacySearcher:
    """The ``LegacySearcher`` of ``(score_fn, cfg)``, cached (with its
    programs) as ``build_engine_from_fn`` caches engines."""
    return LegacySearcher(score_fn, cfg)


def search_legacy(score_fn, params, base, neighbors, queries, entries,
                  cfg: SearchConfig, capture: bool = True) -> SearchResult:
    """The original lane-major searcher (the JAX package's per-query
    ``while_loop``, vmapped), for A/B against the engine. ``base`` is the
    float32 (N, D) corpus: legacy has no fused or quantized path, so a
    store is refused. Runs on ``queries.device``; on the card as captured
    programs (``capture=False``: the same chunks eagerly, bit for bit)."""
    if isinstance(base, (CorpusStore, PagedCorpusStore)):
        raise TypeError("search_legacy searches the float32 (N, D) base "
                        "(no fused or quantized path): pass the array, not "
                        "a CorpusStore")
    return legacy_searcher(score_fn, cfg).search(
        params, base, neighbors, queries, torch.as_tensor(entries),
        capture)


def brute_force_topk(measure: Measure, base: torch.Tensor,
                     queries: torch.Tensor, k: int, batch: int = 8192,
                     q_block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by exhaustive evaluation of the measure's plain
    ``score_fn`` (the ground-truth labels), blocked over queries and corpus
    with a running top-k merge. Ties keep the lower id first, as
    ``lax.top_k`` does. ``base`` is always the float32 (N, D) corpus, never
    a (possibly quantized) ``CorpusStore``: labels are taken at full
    precision. Runs on ``queries.device``; returns (ids (Q, k) int64,
    scores (Q, k) f32)."""
    if isinstance(base, CorpusStore):
        raise TypeError("brute_force_topk labels against the float32 base; "
                        "pass the (N, D) array, not a CorpusStore")
    dev = queries.device
    base = torch.as_tensor(base, device=dev, dtype=torch.float32)
    outs_i, outs_s = [], []
    for q0 in range(0, queries.shape[0], q_block):
        qb = queries[q0: q0 + q_block]
        best_s = torch.full((qb.shape[0], k), float("-inf"),
                            dtype=torch.float32, device=dev)
        best_i = torch.full((qb.shape[0], k), -1, dtype=torch.int64,
                            device=dev)
        for s in range(0, base.shape[0], batch):
            xs = base[s: s + batch]
            scores = measure.score_fn(measure.params, xs[None, :, :],
                                      qb[:, None, :]).float()
            ids = torch.arange(s, s + xs.shape[0], device=dev)
            cs = torch.cat([best_s, scores], dim=1)
            ci = torch.cat([best_i, ids[None, :].expand_as(scores)], dim=1)
            order = torch.sort(cs, dim=1, descending=True,
                               stable=True).indices[:, :k]
            best_s, best_i = cs.gather(1, order), ci.gather(1, order)
        outs_i.append(best_i)
        outs_s.append(best_s)
    return torch.cat(outs_i), torch.cat(outs_s)


def recall(found_ids, true_ids) -> float:
    """Mean |A ∩ B| / |B| over queries."""
    fi, ti = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
              for a in (found_ids, true_ids))
    Q, k = ti.shape
    hits = sum(len(set(map(int, fi[i])) & set(map(int, ti[i])))
               for i in range(Q))
    return hits / (Q * k)
