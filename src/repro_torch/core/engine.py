"""Batch-major staged expansion engine (the GUITAR search that serving runs).

One iteration-major loop over the whole query batch, each phase a
swappable stage:

    pop      batched frontier pop over the (Q, ef) pools
    grad     one batched value+gradient over the (Q, D) frontier (GUITAR):
             the ``deepfm_grad`` kernel for DeepFM measures, the generic
             ``torch.func`` stage otherwise
    rank     Eq. 3/4 neighbor ranking: the ``neighbor_rank`` kernel, then a
             static top-C and the adaptive alpha*theta mask
    measure  one flattened (Q*C, D) evaluation per step: the
             ``deepfm_score`` kernel for DeepFM measures
    insert   batched pool insert + packed visited-bitmap update

SL2G = no grad stage + select-all rank; GUITAR = grad stage + angle or
projection rank. Stages resolve through the bundle registry
(``core/bundles.py``).

Index-fused residency: with ``EngineOptions(fused=True)`` the rank,
measure and grad stages take row ids into the resident ``CorpusStore``
(float32, bfloat16 or int8, ``corpus_dtype``) and gather and dequantize the
rows inside the kernels (``neighbor_rank_fused``, ``deepfm_score_fused``,
``deepfm_grad_fused``), so the (Q, B, D) neighbor, (Q*C, D) candidate and
(Q, D) frontier blocks never exist in device memory; the fused grad stage
hands back the dequantized frontier rows for the rank stage. At float32
residency the fused search equals the unfused one bit for bit, ids and
scores. The unfused stages run on a quantized store as well
(``store.take`` dequantizes). A store with tombstones scores deleted
entries and candidates -inf.

The fused step's dataflow plan (``kernels/autotune.py``): ``rowwise``
hands ``(store, ids)`` to the fused stages above; ``tile`` gathers ONE
(Q, 1+B) block of rows per step, ``[frontier | neighbors]`` of every lane
(inactive ones included), with ``store.take`` inside the step, and runs
the pre-gathered grad, rank and measure stages on slices of it. The plan
comes from ``EngineOptions.tile`` or the tuning cache at the step's (Q, B,
D, dtype) shape and device type, resolved once per program
(``ExpansionEngine._use_tile_plan``); both plans give the unfused search's
results bit for bit at float32. Unlike JAX, which keeps its Pallas fused
stages rowwise, the port's tile plan feeds the pre-gathered CUDA kernels.

Paged residency (``core.corpus.PagedCorpusStore``) always runs the tile
plan, fused or not, its block gathered through the host pager (the fused
kernels read ``store.data``, which a paged store does not hold).

Two execution paths share the same stage code, as in the JAX package:

- ``ExpansionEngine.search`` runs the search as device programs (the
  counterpart of the JAX ``_run_jit`` while loop): one CUDA graph of
  ``init_state`` and one of ``SYNC_EVERY`` consecutive ``step`` +
  ``_freeze_done`` calls, over static buffers (``core/program.py``),
  cached on the engine per batch shape and per params, corpus and graph
  (``PROGRAM_CACHE`` programs at most). The host replays the chunk and
  reads ``done.all()`` once per replay; the steps a chunk runs after a
  lane is done are no-ops for it, because ``_freeze_done`` keeps its state
  and its pop is inactive. ``capture=False``, and every CPU run, runs the
  same chunks eagerly (the host loop the port had before).
- ``ExpansionEngine.search_debug``: one eager ``step`` per Python call,
  with ``max_steps``, ``on_step``, ``iter_caps`` and ``taus`` (JAX's
  ``jit_steps=False``), the yardstick the captured search is held
  against; both return the same ids, scores and counters bit for bit.

A captured graph cannot call back into the host, so a paged search runs
each step as two captured halves with the pager between them (the JAX
package calls the pager inside its jitted step, ``jax.pure_callback``):
``pre`` replays the pop and writes the step's (Q, 1+B) ids and the lanes'
``done`` flags into a buffer; the host copies it into pinned memory,
synchronizes, stops if every lane is done (the JAX ``while_loop``'s check,
so the pager sees exactly the JAX search's gathers), gathers the rows
through the pager into a pinned (Q, 1+B, D) tile and copies it into a
static device buffer; ``post`` replays the step (the pop again, so its
arithmetic is exactly ``step``'s) on that buffer, and ``_freeze_done``
(``PagedFeed``). ``init`` reads the entries' rows from a buffer the host
fills.

Timed programs (``set_tracer``): while the engine holds a live tracer,
``search`` keeps a second program beside each untimed one of a whole
store, under its own cache key, whose chunks (two, replayed in turns, so
that one's marks are read while the other runs) mark the stages of
``STAGES`` (pop, grad, rank, measure, visit, insert; copy_back once a
chunk) with ``obs.Marks``: timing events that the capture records as graph
nodes on the card, host stamps on the CPU. It runs while the tracer is on,
and ``stats`` gathers its device seconds per stage after each chunk's
``done`` read. Both programs are captured while the tracer is live, so
switching it captures nothing; without a tracer the untimed capture holds
no event node and nothing is marked. Paged programs have no timed twin.

The continuous runtime's lane lifecycle is ``reset_lanes`` (a lane-masked
``init_state``) and ``idle_state`` (every lane parked, ``done``).

Counters follow the paper's Table-2 accounting: ``n_eval`` counts effective
(mask-surviving) measure evaluations, ``n_grad`` gradients, ``n_iters``
expansions. Ids are int64 (torch's index type); the visited bitmap holds
32-bit words in int64 lanes.

The visited bitmap, (Q, ceil(N/32)) words (758 MB at Q = 4,096 over
739,991 items), is written in place (``bit_set_rows_``): ``step`` sets the
step's bits in the input state's own tensor and returns that tensor,
``reset_lanes`` clears and seeds the masked lanes' rows in it, and a
program's init zeroes and seeds its own (``init_state(visited=)``). A
program's routines so hand back the bitmap they were given, and the program
copies nothing of it back (``StateProgram.copied``); once ``idle_state``
has allocated it no (Q, N/32) tensor is made again. A caller that needs a
state's bitmap as it was before a ``step`` or ``reset_lanes`` clones it
first.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.bundles import resolve_stages
from repro_torch.core.corpus import (CORPUS_DTYPES, AnyCorpusStore,
                                     CorpusStore, PagedCorpusStore,
                                     as_corpus_store, bit_test_global)
from repro_torch.core.program import StateProgram
from repro_torch.kernels import autotune
from repro_torch.kernels.neighbor_rank import neighbor_rank
from repro_torch.kernels.neighbor_rank.ref import neighbor_rank_ref
from repro_torch.kernels.neighbor_rank_fused import neighbor_rank_fused
from repro_torch.kernels.neighbor_rank_fused.ref import \
    neighbor_rank_fused_ref
from repro_torch.obs.phases import Marks
from repro_torch.obs.trace import NULL_TRACER, NullTracer

SYNC_EVERY = 8       # steps per chunk: between host checks of done.all()
PROGRAM_CACHE = 8    # search programs an engine keeps (least recent out)
# the stages a timed chunk marks, in step order (``copy_back``: once per
# chunk, the program's copies of the new state)
STAGES = ("pop", "grad", "rank", "measure", "visit", "insert", "copy_back")
# a timed program's two chunks, replayed in turns, each with its own
# events: one chunk's are read while the next runs
TIMED_CHUNKS = ("chunk", "chunk.alt")
# the routines of a search program that run its steps
STEP_ROUTINES = TIMED_CHUNKS + ("pre", "post")
_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    k: int = 10                 # results to return
    ef: int = 64                # pool (beam) size; >= k
    budget: int = 8             # C: measure evals per expansion (guitar)
    alpha: float = 1.01         # adaptive tolerance (>= 1)
    mode: str = "guitar"        # guitar | sl2g
    rank_by: str = "angle"      # angle | projection
    adaptive: bool = True       # apply the alpha*theta mask
    max_iters: int = 0          # 0 -> 4 * ef

    def iters(self) -> int:
        return self.max_iters if self.max_iters > 0 else 4 * self.ef


class SearchResult(NamedTuple):
    ids: torch.Tensor       # (Q, k) int64
    scores: torch.Tensor    # (Q, k) float32
    n_eval: torch.Tensor    # (Q,) effective measure evaluations
    n_grad: torch.Tensor    # (Q,) gradient computations
    n_iters: torch.Tensor   # (Q,) expansions


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Backend knobs.

    rank_impl:    'auto' (the neighbor_rank kernel for CUDA tensors, its
                  plain version for CPU tensors) | 'ref' (the plain version
                  everywhere)
    measure_impl: 'auto' resolves the measure's registered bundle, 'vmap'
                  forces the generic batched-score_fn stage
    grad_impl:    'auto' | 'vmap', the same for the grad stage
    fused:        index-fused rank/measure/grad stages: row ids into the
                  resident corpus, gathered and dequantized in the kernels
    corpus_dtype: 'float32' | 'bfloat16' | 'int8' corpus residency
                  (non-fp32 dequantizes on gather, see core/corpus.py)
    adaptive:     'off' | 'angle' — angle-based adaptive candidate-set
                  sizing: a static ``c_max`` block with a per-lane prefix
                  mask from the alpha*theta band and the cutoff ``angle_tau``
                  (guitar mode with rank_by='angle' only)
    c_max:        adaptive block width (0 -> cfg.budget)
    angle_tau:    default absolute angle cutoff in radians (<= 0: band
                  only); ``search(taus=)`` overrides it per lane
    tile:         fused-step plan override (kernels/autotune.py spec:
                  'tile' | 'rowwise', ':<bt>', or 'plan:<bt>'; bt is
                  inert on the card); None resolves the tuning cache /
                  shipped defaults per (Q, B, D, dtype) shape
    """
    rank_impl: str = "auto"
    measure_impl: str = "auto"
    grad_impl: str = "auto"
    fused: bool = False
    corpus_dtype: str = "float32"
    adaptive: str = "off"
    c_max: int = 0
    angle_tau: float = 0.0
    tile: Optional[str] = None


# ---------------------------------------------------------------------------
# batched state + packed visited bitmap
# ---------------------------------------------------------------------------

class EngineState(NamedTuple):
    pool_scores: torch.Tensor    # (Q, ef) f32 desc-sorted
    pool_ids: torch.Tensor       # (Q, ef) int64, -1 = empty
    pool_expanded: torch.Tensor  # (Q, ef) bool
    visited: torch.Tensor        # (Q, ceil(N/32)) int64 holding uint32 words
    n_eval: torch.Tensor         # (Q,) int32
    n_grad: torch.Tensor         # (Q,) int32
    n_iters: torch.Tensor        # (Q,) int32
    done: torch.Tensor           # (Q,) bool
    iter_cap: torch.Tensor       # (Q,) int32 per-lane expansion budget
    angle_tau: torch.Tensor      # (Q,) f32 per-lane adaptive angle cutoff


class PopOut(NamedTuple):
    slot: torch.Tensor      # (Q,) pool slot popped
    fid: torch.Tensor       # (Q,) frontier node id, clamped >= 0
    active: torch.Tensor    # (Q,) lane expands this step


def bit_test_rows(bitmap: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """bitmap: (Q, W) words; ids: (Q, B) -> (Q, B) bool. Negative ids test
    bit 0 of word 0 (callers mask them)."""
    safe = ids.clamp_min(0).long()
    w = torch.gather(bitmap, 1, safe >> 5)
    return ((w >> (safe & 31)) & 1).bool()


def bit_set_rows_(bitmap: torch.Tensor, ids: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Set bits rowwise in ``bitmap``'s own storage (contiguous) and return
    it. Within a row the masked-in ids are distinct and unset (neighbor
    lists are duplicate-free and only fresh ids are set), so a scatter-add
    over the flattened words acts as OR (integer adds: the order does not
    matter)."""
    safe = ids.clamp_min(0).long()
    updates = torch.where(mask, torch.ones_like(safe) << (safe & 31),
                          torch.zeros_like(safe))
    Q, W = bitmap.shape
    rows = torch.arange(Q, device=bitmap.device)[:, None] * W
    bitmap.view(-1).scatter_add_(0, (rows + (safe >> 5)).reshape(-1),
                                 updates.reshape(-1))
    return bitmap


def bit_set_rows(bitmap: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """``bit_set_rows_`` on a copy: returns a new bitmap."""
    return bit_set_rows_(bitmap.clone(memory_format=torch.contiguous_format),
                         ids, mask)


def _repeat_rows(x: torch.Tensor, C: int) -> torch.Tensor:
    """Each row of x C times in a row, as ``repeat_interleave(C, 0)``,
    through a view (no repeat count goes to the device)."""
    Q, D = x.shape
    return x[:, None, :].expand(Q, C, D).contiguous().view(Q * C, D)


def _tensor_ptrs(tree) -> tuple:
    """The data pointers of the tensors in a pytree of dicts, lists and
    tuples: part of a program's key, so that a params dict whose tensors
    were rebound does not replay a graph over the old ones."""
    if isinstance(tree, torch.Tensor):
        return (tree.data_ptr(),)
    if isinstance(tree, dict):
        return tuple(p for k in sorted(tree) for p in _tensor_ptrs(tree[k]))
    if isinstance(tree, (list, tuple)):
        return tuple(p for v in tree for p in _tensor_ptrs(v))
    return ()


def _freeze_done(done: torch.Tensor, new: EngineState,
                 old: EngineState) -> EngineState:
    """Keep converged lanes' state frozen (lane-granular early exit).

    ``visited`` is exempt: ``step`` sets its bits in place, so the new
    state's bitmap is the old state's tensor, and a done lane pops with
    ``active=False``, so its bit updates are masked to no-ops. The bitmap
    passes through as it is: no (Q, N/32) select, and the programs copy
    nothing of it back."""
    def pick(n, o):
        d = done.view((-1,) + (1,) * (n.dim() - 1))
        return torch.where(d, o, n)
    return EngineState(*(n if f == "visited" else pick(n, o)
                         for f, n, o in zip(EngineState._fields, new, old)))


# ---------------------------------------------------------------------------
# default stage implementations
# ---------------------------------------------------------------------------

def default_pop_stage(state: EngineState) -> Tuple[EngineState, PopOut]:
    cand = state.pool_scores.masked_fill(state.pool_expanded, _NEG_INF)
    slot = torch.argmax(cand, dim=1)       # first maximum, as jnp.argmax
    best = cand.gather(1, slot[:, None])[:, 0]
    active = torch.isfinite(best) & ~state.done
    fid = state.pool_ids.gather(1, slot[:, None])[:, 0].clamp_min(0)
    marked = state.pool_expanded.scatter(1, slot[:, None], True)
    expanded = torch.where(active[:, None], marked, state.pool_expanded)
    return state._replace(pool_expanded=expanded), PopOut(slot, fid, active)


def _select_top_c(key, in_range, valid, cfg: SearchConfig,
                  c_max: Optional[int] = None, tau=None):
    """Static top-C over the ranking keys (ascending key, lower slot first
    on ties, as ``lax.top_k``) + the adaptive alpha*theta mask. With
    ``c_max``/``tau`` set, the block widens to ``c_max`` and the mask adds a
    per-lane cutoff ``key <= tau`` (tau <= 0 disables it); the mask stays a
    prefix of the block."""
    C = min(c_max if c_max else cfg.budget, key.shape[1])
    neg_key = torch.where(torch.isfinite(key), -key,
                          torch.full_like(key, _NEG_INF))
    sel_idx = torch.sort(neg_key, dim=1, descending=True,
                         stable=True).indices[:, :C]
    base_mask = in_range if cfg.adaptive else valid
    sel_mask = base_mask.gather(1, sel_idx)
    if tau is not None:
        tau = tau[:, None]
        sel_key = key.gather(1, sel_idx)
        sel_mask = sel_mask & ((tau <= 0) | (sel_key <= tau))
    return sel_idx, sel_mask


def _adaptive_c_max(cfg: SearchConfig, options) -> Optional[int]:
    if options.adaptive != "angle":
        return None
    return options.c_max if options.c_max else cfg.budget


def make_guitar_rank_stage(cfg: SearchConfig,
                           options: EngineOptions = EngineOptions()):
    """Eq. 3 (angle) / Eq. 4 (projection) + static top-C + adaptive mask.
    The trailing ``tau`` ((Q,) f32) is passed only when adaptive='angle'."""
    c_max = _adaptive_c_max(cfg, options)
    rank = neighbor_rank_ref if options.rank_impl == "ref" else neighbor_rank

    def stage(x, grad, nvecs, valid, tau=None):
        key, in_range = rank(x, grad, nvecs, valid, alpha=cfg.alpha,
                             rank_by=cfg.rank_by)
        return _select_top_c(key, in_range, valid, cfg, c_max, tau)
    return stage


def make_guitar_rank_fused_stage(cfg: SearchConfig,
                                 options: EngineOptions = EngineOptions()):
    """Index-fused Eq. 3/4: keys and mask straight off the resident corpus
    (the ``neighbor_rank_fused`` kernel), then the same top-C and mask."""
    c_max = _adaptive_c_max(cfg, options)
    rank = neighbor_rank_fused_ref if options.rank_impl == "ref" \
        else neighbor_rank_fused

    def stage(x, grad, store, idx, valid, tau=None):
        key, in_range = rank(x, grad, store, idx, valid, alpha=cfg.alpha,
                             rank_by=cfg.rank_by)
        return _select_top_c(key, in_range, valid, cfg, c_max, tau)
    return stage


def select_all_rank_stage(x, grad, nvecs, valid):
    """SL2G: no pruning, every fresh neighbor is a candidate (C = B)."""
    Q, B, _ = nvecs.shape
    sel_idx = torch.arange(B, device=nvecs.device)[None, :].expand(Q, B)
    return sel_idx, valid


def select_all_rank_fused_stage(x, grad, store, idx, valid):
    """SL2G, index-fused: no pruning and no gather; the measure stage
    scores every fresh neighbor by id."""
    Q, B = idx.shape
    sel_idx = torch.arange(B, device=idx.device)[None, :].expand(Q, B)
    return sel_idx, valid


def default_insert_stage(state: EngineState, ids: torch.Tensor,
                         scores: torch.Tensor,
                         mask: torch.Tensor) -> EngineState:
    """Merge (Q, C) candidates into the desc-sorted (Q, ef) pools: a stable
    descending sort of [pool | candidates], truncated to ef. Ties go pool
    first, then candidate order — the JAX merge-path insert's rule."""
    ef = state.pool_scores.shape[1]
    all_s = torch.cat([state.pool_scores,
                       scores.masked_fill(~mask, _NEG_INF)], dim=1)
    all_i = torch.cat([state.pool_ids, ids.masked_fill(~mask, -1)], dim=1)
    all_e = torch.cat([state.pool_expanded, ~mask], dim=1)
    order = torch.sort(all_s, dim=1, descending=True,
                       stable=True).indices[:, :ef]
    return state._replace(pool_scores=all_s.gather(1, order),
                          pool_ids=all_i.gather(1, order),
                          pool_expanded=all_e.gather(1, order))


# ---------------------------------------------------------------------------
# the host side of a paged step
# ---------------------------------------------------------------------------

def paged_buffers(Q: int, B: int, D: int, device) -> dict:
    """A paged program's device buffers: ``ids`` ((Q, 2+B) int64, written
    by ``pre``), ``tile`` ((Q, 1+B, D) float32, read by ``post``) and
    ``entry_rows`` ((Q, D) float32, read by init / reset)."""
    return {"ids": torch.zeros((Q, 2 + B), dtype=torch.int64,
                               device=device),
            "tile": torch.zeros((Q, 1 + B, D), dtype=torch.float32,
                                device=device),
            "entry_rows": torch.zeros((Q, D), dtype=torch.float32,
                                      device=device)}


class PagedFeed:
    """Runs a paged program's steps (``pre``, the pager, ``post``) and
    fills its entry rows, through pinned host buffers on a card.

    Ordering: every copy goes on the current stream, the one the graphs
    replay on. The host rewrites ``tile_host`` only after the next step's
    ids copy has been synchronized, which stream order puts after the
    previous tile's host-to-device copy, so that copy has finished; the
    entries' copy is fenced by an event. A pageable source would make the
    copies synchronous. ``times`` sums each step's host seconds by part:
    the two replays, the ids sync (which waits for the card), the pager
    gather and issuing the tile copy."""

    def __init__(self, store: PagedCorpusStore, buffers: dict):
        self.store = store
        self.bufs = buffers
        self.device = buffers["tile"].device
        pin = self.device.type == "cuda"

        def host(t):
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        self.ids_host = host(buffers["ids"])
        self.tile_host = host(buffers["tile"])
        self.entry_host = host(buffers["entry_rows"])
        self._entry_done = None
        self.times = {"replay_s": 0.0, "sync_s": 0.0, "gather_s": 0.0,
                      "h2d_s": 0.0}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def load_entries(self, entries) -> None:
        """Gather the (Q,) entries' rows through the pager into the
        ``entry_rows`` buffer (for the next init or reset)."""
        if self._entry_done is not None:
            self._entry_done.synchronize()
        self.store.cache.gather(np.asarray(entries),
                                out=self.entry_host.numpy())
        self.bufs["entry_rows"].copy_(self.entry_host, non_blocking=True)
        if self.device.type == "cuda":
            self._entry_done = torch.cuda.Event()
            self._entry_done.record(torch.cuda.current_stream(self.device))

    def step(self, prog: StateProgram, stop_when_done: bool) -> bool:
        """One paged step. With ``stop_when_done``, returns True without
        gathering when every lane was already done (nothing ran but
        ``pre``)."""
        t0 = time.perf_counter()
        prog.run("pre")
        t1 = time.perf_counter()
        self.ids_host.copy_(self.bufs["ids"], non_blocking=True)
        self._sync()
        t2 = time.perf_counter()
        ids = self.ids_host.numpy()
        tm = self.times
        if stop_when_done and ids[:, -1].all():
            tm["replay_s"] += t1 - t0
            tm["sync_s"] += t2 - t1
            return True
        self.store.cache.gather(ids[:, :-1], out=self.tile_host.numpy())
        t3 = time.perf_counter()
        self.bufs["tile"].copy_(self.tile_host, non_blocking=True)
        t4 = time.perf_counter()
        prog.run("post")
        t5 = time.perf_counter()
        tm["replay_s"] += (t1 - t0) + (t5 - t4)
        tm["sync_s"] += t2 - t1
        tm["gather_s"] += t3 - t2
        tm["h2d_s"] += t4 - t3
        return False


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ExpansionEngine:
    """A staged, batch-major graph searcher. ``grad=None`` skips the
    gradient phase (SL2G). When ``rank_fused`` / ``measure_fused`` /
    ``grad_fused`` are set (``EngineOptions(fused=True)``) the engine hands
    those stages ``(store, ids)`` instead of gathered rows."""
    cfg: SearchConfig
    pop: Callable
    rank: Callable
    measure: Callable
    insert: Callable
    grad: Optional[Callable] = None
    rank_fused: Optional[Callable] = None
    measure_fused: Optional[Callable] = None
    grad_fused: Optional[Callable] = None
    corpus_dtype: str = "float32"
    adaptive: str = "off"
    c_max: int = 0
    angle_tau: float = 0.0
    tile: Optional[str] = None      # EngineOptions.tile override spec
    tracer: object = NULL_TRACER    # set_tracer; not a search option

    def set_tracer(self, tracer) -> None:
        """Give the engine a tracer (``obs.Tracer``; ``NULL_TRACER`` takes
        it away). While it holds a live one, on or off, ``search`` builds
        and captures a timed program beside each untimed one, and replays
        the timed one while the tracer is on (``stats``). Engines are
        shared through ``build_engine``'s cache: the tracer is the
        engine's, not one caller's."""
        object.__setattr__(self, "tracer", tracer)

    def n_candidates(self, max_degree: int) -> int:
        if self.grad is None:
            return max_degree
        c = self.cfg.budget
        if self.adaptive == "angle" and self.c_max:
            c = self.c_max
        return min(c, max_degree)

    def init_state(self, params, store: AnyCorpusStore, neighbors, queries,
                   entries, iter_caps=None, taus=None, entry_rows=None,
                   use_tile: bool = False, visited=None) -> EngineState:
        """Seed each pool with its entry point (one measure call). A paged
        store seeds from ``entry_rows`` ((Q, D) float32, the entries' rows
        the host gathered) or, without them, one ``store.take``; the tile
        plan (``use_tile``) through ``store.take`` and the pre-gathered
        measure too, so that it launches no fused kernel. ``visited``: a
        (Q, ceil(N/32)) int64 bitmap that the state takes as its own,
        zeroed and seeded in place (a program's init passes its state's);
        None allocates one."""
        Q = queries.shape[0]
        dev = queries.device
        entries = entries.long()
        if visited is None:
            visited = torch.zeros((Q, (store.n + 31) // 32),
                                  dtype=torch.int64, device=dev)
        else:
            visited.zero_()
        bit_set_rows_(visited, entries[:, None],
                      torch.ones((Q, 1), dtype=torch.bool, device=dev))
        return self._seed(params, store, queries, entries, iter_caps, taus,
                          entry_rows, use_tile, visited)

    def _seed(self, params, store: AnyCorpusStore, queries, entries,
              iter_caps, taus, entry_rows, use_tile: bool,
              visited: torch.Tensor) -> EngineState:
        """``init_state``'s fields around a bitmap the caller has seeded
        (held as it is)."""
        Q = queries.shape[0]
        ef = self.cfg.ef
        dev = queries.device
        if store.is_paged:
            rows = entry_rows if entry_rows is not None \
                else store.take(entries)
            e_scores = self.measure(params, rows, queries)
        elif self.measure_fused is not None and not use_tile:
            e_scores = self.measure_fused(params, store, entries, queries)
        else:
            e_scores = self.measure(params, store.take(entries), queries)
        if store.tombstones is not None:
            # a deleted entry never surfaces: the lane simply exhausts
            e_scores = e_scores.masked_fill(
                bit_test_global(store.tombstones, entries), _NEG_INF)
        pool_scores = torch.full((Q, ef), _NEG_INF, dtype=torch.float32,
                                 device=dev)
        pool_scores[:, 0] = e_scores
        pool_ids = torch.full((Q, ef), -1, dtype=torch.int64, device=dev)
        pool_ids[:, 0] = entries
        pool_expanded = torch.ones((Q, ef), dtype=torch.bool, device=dev)
        pool_expanded[:, 0] = False
        zeros = torch.zeros((Q,), dtype=torch.int32, device=dev)
        if iter_caps is None:
            iter_caps = torch.full((Q,), self.cfg.iters(),
                                   dtype=torch.int32, device=dev)
        else:
            iter_caps = torch.as_tensor(iter_caps, device=dev).int()
        if taus is None:
            taus = torch.full((Q,), self.angle_tau, dtype=torch.float32,
                              device=dev)
        else:
            taus = torch.as_tensor(taus, device=dev).float()
        return EngineState(pool_scores, pool_ids, pool_expanded, visited,
                           zeros + 1, zeros.clone(), zeros.clone(),
                           torch.zeros((Q,), dtype=torch.bool, device=dev),
                           iter_caps, taus)

    def _use_tile_plan(self, store: AnyCorpusStore, n_degree: int,
                       Q: int) -> bool:
        """Does a step over ``store`` at this shape run the tile plan?
        (``plan_for`` at the store's width, device type and residency.)"""
        return self.plan_for(Q, n_degree, store.dim, store.device.type,
                             store.is_paged)

    @functools.cached_property
    def _plans(self) -> dict:
        return {}

    def plan_for(self, Q: int, n_degree: int, dim: int, device_type: str,
                 paged: bool) -> bool:
        """The step plan at this shape, resolved once on this engine and
        kept (a lookup reads the cache files, so it is never made per
        step). A paged store always tiles, fused or not (its rows come
        through the pager); a whole store tiles only with a fused stage on
        (and, with a grad phase, the pre-gathered grad stage present), when
        ``self.tile`` or the tuning cache (``kernels/autotune.py``, keyed on
        the device type) says ``tile``."""
        key = (int(Q), int(n_degree), int(dim), device_type, bool(paged))
        if key not in self._plans:
            if paged:
                plan = True
            elif ((self.rank_fused is None and self.measure_fused is None
                   and self.grad_fused is None)
                  or (self.grad_fused is not None and self.grad is None)):
                plan = False
            else:
                plan = autotune.resolve(
                    "engine_step", q=Q, m=n_degree, d=dim,
                    dtype=self.corpus_dtype, backend=device_type,
                    override=autotune.parse_tile(self.tile)).plan == "tile"
            self._plans[key] = plan
        return self._plans[key]

    def step(self, params, store: AnyCorpusStore, neighbors, queries,
             qs_flat, state: EngineState, tile=None,
             use_tile: Optional[bool] = None, marks=None) -> EngineState:
        """One iteration over the whole batch: pop, grad, rank, measure,
        insert. ``qs_flat`` is the (Q*C, Dq) repeated query block.
        ``use_tile`` is the step's plan (None: ``plan_for`` resolves it).
        The tile plan reads its rows from ``tile``, the (Q, 1+B, D) rows of
        [frontier | neighbors] (gathered here by ``store.take`` when None,
        through the pager for a paged store). ``marks`` (an ``obs.Marks``,
        a timed chunk's) is entered at each stage boundary of ``STAGES``
        after ``pop``; the caller enters ``pop``. The step sets its visited
        bits in ``state.visited`` in place, and the returned state holds
        that same tensor: clone it first to keep the bitmap as it was."""
        Q = queries.shape[0]
        if use_tile is None:
            use_tile = self._use_tile_plan(store, neighbors.shape[1], Q)
        s, pop = self.pop(state)
        nbr = neighbors[pop.fid].long()                    # (Q, B)
        valid = (nbr >= 0) & ~bit_test_rows(s.visited, nbr) \
            & pop.active[:, None]
        if use_tile and tile is None:
            tile = store.take(torch.cat([pop.fid[:, None],
                                         nbr.clamp_min(0)], dim=1))

        if marks is not None:
            marks.enter("grad")
        if self.grad_fused is not None and not use_tile:
            # the frontier rows come back from the kernel, dequantized
            _, g, x = self.grad_fused(params, store, pop.fid, queries)
            n_grad = s.n_grad + pop.active.int()
        else:
            x = tile[:, 0].contiguous() if use_tile \
                else store.take(pop.fid)                   # (Q, D)
            if self.grad is not None:
                _, g = self.grad(params, x, queries)
                n_grad = s.n_grad + pop.active.int()
            else:
                g, n_grad = None, s.n_grad

        if marks is not None:
            marks.enter("rank")
        targs = (state.angle_tau,) if self.adaptive == "angle" else ()
        if self.rank_fused is not None and not use_tile:
            # the kernels clamp -1 ids themselves
            sel_idx, sel_mask = self.rank_fused(x, g, store, nbr, valid,
                                                *targs)
        else:
            nvecs = tile[:, 1:].contiguous() if use_tile \
                else store.take(nbr.clamp_min(0))          # (Q, B, D)
            sel_idx, sel_mask = self.rank(x, g, nvecs, valid, *targs)
        sel_ids = nbr.gather(1, sel_idx)

        if marks is not None:
            marks.enter("measure")
        C = sel_idx.shape[1]
        if self.measure_fused is not None and not use_tile:
            # adaptive: the prefix mask rides into the kernel, whose masked
            # rows skip their MLP
            mkw = ({"mask": sel_mask.reshape(Q * C)}
                   if self.adaptive == "angle" else {})
            flat_scores = self.measure_fused(params, store,
                                             sel_ids.reshape(Q * C), qs_flat,
                                             **mkw)
        else:
            D = nvecs.shape[2]
            sel_vecs = nvecs.gather(1, sel_idx[..., None].expand(Q, C, D))
            flat_scores = self.measure(params, sel_vecs.reshape(Q * C, D),
                                       qs_flat)
        scores = flat_scores.reshape(Q, C).masked_fill(~sel_mask, _NEG_INF)
        if store.tombstones is not None:
            # deleted rows score -inf: never returned, never expanded
            scores = scores.masked_fill(
                bit_test_global(store.tombstones, sel_ids), _NEG_INF)

        if marks is not None:
            marks.enter("visit")
        bit_set_rows_(s.visited, sel_ids, sel_mask)
        if marks is not None:
            marks.enter("insert")
        s = s._replace(
            n_grad=n_grad,
            n_eval=s.n_eval + sel_mask.sum(dim=1).int(),
            n_iters=s.n_iters + pop.active.int())
        s = self.insert(s, sel_ids, scores, sel_mask)
        exhausted = ~torch.any(~s.pool_expanded & torch.isfinite(
            s.pool_scores), dim=1)
        done = state.done | exhausted | (s.n_iters >= s.iter_cap) \
            | ~pop.active
        return s._replace(done=done)

    # -- lane-scoped lifecycle (the continuous runtime's lanes are slots):
    #    the masked lanes get exactly the state ``init_state`` would give
    #    them, every other lane passes through; parked lanes are done, so
    #    their pop is inactive and a step leaves them as they are
    def reset_lanes(self, params, store: AnyCorpusStore, queries, entries,
                    state: EngineState, mask: torch.Tensor, iter_caps=None,
                    taus=None, entry_rows=None,
                    use_tile: bool = False) -> EngineState:
        """queries (Q, Dq) / entries (Q,) (and optional per-lane
        ``iter_caps`` / ``taus``, and a paged store's ``entry_rows``) hold
        the NEW values in the masked rows; mask: (Q,) bool, True lanes are
        re-initialized. Lane for lane equal to ``init_state`` (in the plan
        ``use_tile``) on the masked rows. The masked lanes' rows of
        ``state.visited`` are cleared and seeded in place, the other rows
        left untouched, and the returned state holds that same tensor:
        clone it first to keep the bitmap as it was."""
        entries = entries.long()
        visited = state.visited.masked_fill_(mask[:, None], 0)
        bit_set_rows_(visited, entries[:, None], mask[:, None])
        fresh = self._seed(params, store, queries, entries, iter_caps, taus,
                           entry_rows, use_tile, visited)

        def pick(n, o):
            return torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)), n, o)
        return EngineState(*(n if f == "visited" else pick(n, o) for f, n, o
                             in zip(EngineState._fields, fresh, state)))

    def idle_state(self, n_lanes: int, n_corpus: int,
                   device=DEFAULT_DEVICE) -> EngineState:
        """Every lane parked (``done``): ``init_state``'s shapes and dtypes,
        each field its own tensor (the programs copy into them in place),
        on ``device`` (the card unless the caller says otherwise)."""
        device = resolve_device(device)
        ef = self.cfg.ef
        nwords = (n_corpus + 31) // 32

        def zeros(dtype=torch.int32):
            return torch.zeros((n_lanes,), dtype=dtype, device=device)
        return EngineState(
            pool_scores=torch.full((n_lanes, ef), _NEG_INF,
                                   dtype=torch.float32, device=device),
            pool_ids=torch.full((n_lanes, ef), -1, dtype=torch.int64,
                                device=device),
            pool_expanded=torch.ones((n_lanes, ef), dtype=torch.bool,
                                     device=device),
            visited=torch.zeros((n_lanes, nwords), dtype=torch.int64,
                                device=device),
            n_eval=zeros(), n_grad=zeros(), n_iters=zeros(),
            done=torch.ones((n_lanes,), dtype=torch.bool, device=device),
            iter_cap=zeros(), angle_tau=zeros(torch.float32))

    def _result(self, final: EngineState) -> SearchResult:
        """The result, copied out of ``final`` (a program's state buffers
        are overwritten by its next run)."""
        k = self.cfg.k
        return SearchResult(ids=final.pool_ids[:, :k].clone(),
                            scores=final.pool_scores[:, :k].clone(),
                            n_eval=final.n_eval.clone(),
                            n_grad=final.n_grad.clone(),
                            n_iters=final.n_iters.clone())

    def step_routine(self, params, store, neighbors, steps: int,
                     use_tile: bool, marks=None):
        """A program routine of ``steps`` consecutive step + freeze calls
        over the state in the plan ``use_tile``, the queries read from the
        ``queries`` buffer. With ``marks`` it is the timed routine: each
        step enters ``pop`` first, and the freeze belongs to ``insert``."""
        C = self.n_candidates(neighbors.shape[1])

        def run(bufs, s):
            if marks is not None:
                marks.begin("pop")
            q = bufs["queries"]
            qs_flat = _repeat_rows(q, C)
            for i in range(steps):
                if marks is not None and i:
                    marks.enter("pop")
                s = _freeze_done(s.done, self.step(
                    params, store, neighbors, q, qs_flat, s,
                    use_tile=use_tile, marks=marks), s)
            return s, {}
        return run

    def pre_routine(self, neighbors):
        """A paged step's first half: the pop, and the (Q, 2+B) int64
        ``ids`` buffer of [frontier | neighbors clamped >= 0 | done] (the
        state is left as it was)."""
        def run(bufs, s):
            _, pop = self.pop(s)
            nbr = neighbors[pop.fid].long()
            return s, {"ids": torch.cat([pop.fid[:, None], nbr.clamp_min(0),
                                         s.done.long()[:, None]], dim=1)}
        return run

    def post_routine(self, params, store, neighbors):
        """A paged step's second half: ``step`` + freeze over the rows in
        the ``tile`` buffer, the queries read from ``queries``."""
        C = self.n_candidates(neighbors.shape[1])

        def run(bufs, s):
            q = bufs["queries"]
            return _freeze_done(s.done, self.step(
                params, store, neighbors, q, _repeat_rows(q, C), s,
                tile=bufs["tile"], use_tile=True), s), {}
        return run

    @functools.cached_property
    def _programs(self) -> collections.OrderedDict:
        return collections.OrderedDict()

    @functools.cached_property
    def stats(self) -> dict:
        """Totals over this engine's ``search`` calls, all flat numbers:

        - ``searches``, ``steps``, ``runs`` (program runs: graph replays on
          the card, one init + the chunks per search, or a paged search's
          pre and post halves), ``programs`` (search programs built, each
          a new capture on the card);
        - host seconds: ``load_s`` (writing the inputs into the buffers,
          a paged search's tile copies too), ``launch_s`` (inside the
          program runs), ``sync_s`` (the blocking ``done`` reads), and
          ``issue_s`` = ``load_s`` + ``launch_s``;
        - a paged search's host seconds by part (``PagedFeed.times``):
          ``paged_replay_s``, ``paged_sync_s`` (the ids sync),
          ``paged_gather_s`` (the pager), ``paged_h2d_s`` (the tile copy);
        - while the tracer is on (timed chunks, whole stores only):
          ``stage_s.<stage>`` and ``stage_calls.<stage>`` for each of
          ``STAGES`` (device seconds on the card, host seconds on the CPU;
          a call per step, per chunk for ``copy_back``), and
          ``chunk_gap_s`` over ``chunk_gaps``: the device idle before each
          chunk's replay, from the end of the run before it (the init or
          the last chunk) to the chunk's first node;
        - ``copy_back_bytes``: the bytes the search's step runs (the chunks,
          a paged search's pre and post halves; not the init) copied back
          into the state and the output buffers, ``StateProgram.copied``
          per run (always)."""
        st = {"searches": 0, "steps": 0, "runs": 0, "issue_s": 0.0,
              "load_s": 0.0, "launch_s": 0.0, "sync_s": 0.0,
              "programs": 0, "paged_replay_s": 0.0, "paged_sync_s": 0.0,
              "paged_gather_s": 0.0, "paged_h2d_s": 0.0,
              "chunk_gap_s": 0.0, "chunk_gaps": 0, "copy_back_bytes": 0}
        for name in STAGES:
            st["stage_s." + name] = 0.0
            st["stage_calls." + name] = 0
        return st

    def search_program(self, params, base, neighbors, queries,
                       capture: bool = True,
                       timed: bool = False) -> StateProgram:
        """The cached program for this batch shape and these params, corpus
        and graph (by identity, and the params' tensors by pointer: pass
        the same objects unchanged between calls; a changed corpus or graph
        is a new object), and the step plan (``plan_for``) at its shape.
        The program holds them, so their ids stay theirs while it is
        cached. ``timed``: the timed program (its chunk marks ``STAGES``),
        under a key of its own; a paged store has none (its program is the
        untimed one)."""
        dev = queries.device
        Q, Dq = queries.shape
        key = (Q, Dq, str(dev), bool(capture), id(params), id(base),
               id(neighbors), _tensor_ptrs(params))
        paged = isinstance(base, PagedCorpusStore)
        dim = base.dim if paged or isinstance(base, CorpusStore) \
            else base.shape[1]
        use_tile = self.plan_for(Q, neighbors.shape[1], dim, dev.type, paged)
        timed = bool(timed) and not paged
        key = key + (timed, use_tile)
        progs = self._programs
        if key in progs:
            progs.move_to_end(key)
            return progs[key]
        store = as_corpus_store(base, self.corpus_dtype, device=dev)
        if store.device != dev:
            raise ValueError(f"corpus on {store.device}, queries on {dev}")
        nbrs = torch.as_tensor(neighbors, device=dev)
        bufs = {"queries": torch.zeros((Q, Dq), dtype=torch.float32,
                                       device=dev),
                "entries": torch.zeros((Q,), dtype=torch.int64, device=dev),
                "caps": torch.zeros((Q,), dtype=torch.int32, device=dev),
                "taus": torch.zeros((Q,), dtype=torch.float32, device=dev)}
        if store.is_paged:
            bufs.update(paged_buffers(Q, nbrs.shape[1], store.dim, dev))
        prog = StateProgram(self.idle_state(Q, store.n, dev), bufs, capture)
        prog.held = (params, base, neighbors, store, nbrs)

        def init(b, s):
            return self.init_state(params, store, nbrs, b["queries"],
                                   b["entries"], b["caps"], b["taus"],
                                   b.get("entry_rows"), use_tile,
                                   visited=s.visited), {}
        prog.add("init", init)
        if store.is_paged:
            prog.add("pre", self.pre_routine(nbrs))
            prog.add("post", self.post_routine(params, store, nbrs))
            prog.feed = PagedFeed(store, prog.buffers)
        elif timed:
            for name in TIMED_CHUNKS:
                marks = Marks(dev)
                prog.add(name, self.step_routine(params, store, nbrs,
                                                 SYNC_EVERY, use_tile, marks),
                         marks=marks)
        else:
            prog.add("chunk", self.step_routine(params, store, nbrs,
                                                SYNC_EVERY, use_tile))
        progs[key] = prog
        self.stats["programs"] += 1
        while len(progs) > PROGRAM_CACHE:
            progs.popitem(last=False)
        return prog

    def search(self, params, base, neighbors, queries: torch.Tensor,
               entries, iter_caps=None, taus=None,
               capture: bool = True) -> SearchResult:
        """base: (N, D) tensor/array or a store (``CorpusStore`` or
        ``PagedCorpusStore``); neighbors: (N, B) int -1-padded; queries:
        (Q, Dq) tensor on the search device; entries: (Q,) entry ids;
        iter_caps: optional (Q,) per-query expansion budgets; taus:
        optional (Q,) adaptive angle cutoffs. Everything runs on
        ``queries.device``: on the card as captured programs
        (``capture=False``: the same chunks, or a paged store's halves,
        eagerly). While the engine's tracer is on, the timed program runs
        (``set_tracer``, ``stats``) and the search's host phases (``load``,
        ``launch``, ``sync``) are spans of the tracer (site ``engine``)."""
        tr = self.tracer
        timed = tr.enabled
        prog = self.search_program(params, base, neighbors, queries,
                                   capture, timed)
        if not isinstance(tr, NullTracer):
            # a live tracer, on or off: both programs are captured, so that
            # switching it captures nothing
            self.search_program(params, base, neighbors, queries, capture,
                                not timed).prepare("init", *TIMED_CHUNKS)
        phases = Marks(tracer=tr, site="engine") if timed else None
        if phases is not None:
            phases.begin("load")
        t0 = time.perf_counter()
        prog.load(queries=queries, entries=entries)
        if iter_caps is None:
            prog.fill(caps=self.cfg.iters())
            cap_max = self.cfg.iters()
        else:
            caps = torch.as_tensor(iter_caps)
            prog.load(caps=caps)
            cap_max = int(caps.max())
        if taus is None:
            prog.fill(taus=self.angle_tau)
        else:
            prog.load(taus=taus)
        if prog.feed is not None:
            prog.feed.load_entries(torch.as_tensor(entries).cpu())
        runs0 = dict(prog.runs)
        t1 = time.perf_counter()
        if phases is not None:
            phases.enter("launch")
        prog.run("init")
        t2 = time.perf_counter()
        st = self.stats
        load, launch, sync = t1 - t0, t2 - t1, 0.0
        # every live lane expands or finishes each step, so all lanes are
        # done after max(iter_cap) + 1 steps; the check is a guard
        limit = cap_max + 1 + SYNC_EVERY
        if prog.feed is not None:
            steps, runs, d = self._paged_steps(prog, limit)
            load += d["h2d_s"]
            launch += d["replay_s"]
            sync += d["sync_s"]
        elif "chunk" in prog.marks:
            steps, runs, dl, sync = self._timed_chunks(prog, limit, phases)
            launch += dl
        else:
            steps = runs = 0
            t = t2
            while True:
                prog.run("chunk")
                t1 = time.perf_counter()
                launch += t1 - t
                steps += SYNC_EVERY
                runs += 1
                finished = bool(prog.state.done.all())
                t = time.perf_counter()
                sync += t - t1
                if finished:
                    break
                if steps >= limit:
                    raise RuntimeError(
                        f"search did not converge in {steps} steps "
                        f"(iter cap {limit - 1})")
        if phases is not None:
            phases.stop()
        st["searches"] += 1
        st["steps"] += steps
        st["runs"] += runs + 1
        st["load_s"] += load
        st["launch_s"] += launch
        st["sync_s"] += sync
        st["issue_s"] += load + launch
        st["copy_back_bytes"] += sum(
            (prog.runs[name] - runs0.get(name, 0)) * prog.copied.get(name, 0)
            for name in STEP_ROUTINES)
        return self._result(prog.state)

    def _timed_chunks(self, prog: StateProgram, limit: int,
                      phases) -> Tuple[int, int, float, float]:
        """The chunk loop of the timed program, its two chunks in turns:
        a chunk's stage marks, and the device idle before its replay, are
        read into ``stats`` while the next chunk runs (the ``done`` read
        after a chunk, the sync the loop makes anyway, has passed them),
        the last chunk's after its ``done`` read. Returns (steps, runs,
        launch seconds, sync seconds)."""
        st = self.stats

        def read(marks, before) -> None:
            phases.enter("read")
            for name, sec in marks.read():
                st["stage_s." + name] += sec
                st["stage_calls." + name] += 1
            st["chunk_gap_s"] += marks.between(before, marks.first)
            st["chunk_gaps"] += 1

        steps = runs = 0
        launch = sync = 0.0
        prev = prog.marks["chunk"].point()     # the end of the init's run
        pending = None
        while True:
            name = TIMED_CHUNKS[runs % 2]
            marks = prog.marks[name]
            phases.enter("launch")
            t0 = time.perf_counter()
            prog.run(name)
            launch += time.perf_counter() - t0
            end = marks.point()
            if pending is not None:
                read(*pending)
            phases.enter("sync")
            t0 = time.perf_counter()
            finished = bool(prog.state.done.all())
            sync += time.perf_counter() - t0
            pending, prev = (marks, prev), end
            steps += SYNC_EVERY
            runs += 1
            if finished:
                read(*pending)
                return steps, runs, launch, sync
            if steps >= limit:
                raise RuntimeError(f"search did not converge in {steps} "
                                   f"steps (iter cap {limit - 1})")

    def _paged_steps(self, prog: StateProgram,
                     limit: int) -> Tuple[int, int, dict]:
        """A paged search's steps, ``done`` read after every one (the JAX
        ``while_loop``): returns (steps, program runs, the host seconds of
        its ``PagedFeed.times`` parts)."""
        feed = prog.feed
        t0 = dict(feed.times)
        steps = 0
        while not feed.step(prog, stop_when_done=True):
            steps += 1
            if steps >= limit:
                raise RuntimeError(f"search did not converge in {steps} "
                                   f"steps (iter cap {limit - 1})")
        d = {k: feed.times[k] - t0[k] for k in t0}
        for k in ("replay_s", "sync_s", "gather_s", "h2d_s"):
            self.stats["paged_" + k] += d[k]
        return steps, 2 * steps + 1, d

    def search_debug(self, params, base, neighbors, queries: torch.Tensor,
                     entries, max_steps: Optional[int] = None,
                     on_step: Optional[Callable[[int, EngineState], None]]
                     = None, iter_caps=None, taus=None) -> SearchResult:
        """The eager host loop: one ``step`` per Python call, ``done``
        read after every step, ``on_step(steps, state)`` after each;
        ``max_steps`` cuts it (default: the config's cap + 1, extended to
        the largest ``iter_caps`` + 1). Same arguments and results as
        ``search``."""
        dev = queries.device
        store = as_corpus_store(base, self.corpus_dtype, device=dev)
        if store.device != dev:
            raise ValueError(f"corpus on {store.device}, queries on {dev}")
        neighbors = torch.as_tensor(neighbors, device=dev)
        entries = torch.as_tensor(entries, device=dev).long()
        queries = queries.float().contiguous()
        use_tile = self._use_tile_plan(store, neighbors.shape[1],
                                       queries.shape[0])
        state = self.init_state(params, store, neighbors, queries, entries,
                                iter_caps, taus, use_tile=use_tile)
        qs_flat = _repeat_rows(queries,
                               self.n_candidates(neighbors.shape[1]))
        if max_steps is not None:
            limit = max_steps
        else:
            limit = self.cfg.iters() + 1
            if iter_caps is not None:
                limit = max(limit, int(torch.as_tensor(iter_caps).max()) + 1)
        steps = 0
        while steps < limit and not bool(state.done.all()):
            state = _freeze_done(
                state.done,
                self.step(params, store, neighbors, queries, qs_flat, state,
                          use_tile=use_tile),
                state)
            steps += 1
            if on_step is not None:
                on_step(steps, state)
        return self._result(state)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def _check_options(cfg: SearchConfig, options: EngineOptions) -> None:
    if options.corpus_dtype not in CORPUS_DTYPES:
        raise ValueError(f"corpus_dtype must be one of {CORPUS_DTYPES}, got "
                         f"{options.corpus_dtype!r}")
    if options.rank_impl not in ("auto", "ref"):
        raise ValueError(f"rank_impl must be 'auto' or 'ref', got "
                         f"{options.rank_impl!r}")
    for name in ("measure_impl", "grad_impl"):
        if getattr(options, name) not in ("auto", "vmap"):
            raise ValueError(f"{name} must be 'auto' or 'vmap', got "
                             f"{getattr(options, name)!r}")
    if cfg.mode not in ("guitar", "sl2g"):
        raise ValueError(f"mode must be 'guitar' or 'sl2g', got "
                         f"{cfg.mode!r}")
    if options.adaptive not in ("off", "angle"):
        raise ValueError(f"EngineOptions.adaptive must be 'off' or 'angle', "
                         f"got {options.adaptive!r}")
    if options.adaptive == "angle" and (cfg.mode != "guitar"
                                        or cfg.rank_by != "angle"):
        raise ValueError(
            "EngineOptions(adaptive='angle') requires SearchConfig("
            f"mode='guitar', rank_by='angle'); got mode={cfg.mode!r}, "
            f"rank_by={cfg.rank_by!r}")


def _build(score_fn, meta, cfg: SearchConfig,
           options: EngineOptions) -> ExpansionEngine:
    """Assemble an engine; stage selection flows only through
    ``resolve_stages``."""
    _check_options(cfg, options)
    stages = resolve_stages(score_fn, meta, options)
    if cfg.mode == "guitar":
        grad, grad_fused = stages.grad, stages.grad_fused
        rank = make_guitar_rank_stage(cfg, options)
        rank_fused = make_guitar_rank_fused_stage(cfg, options) \
            if options.fused else None
    else:
        grad = grad_fused = None
        rank = select_all_rank_stage
        rank_fused = select_all_rank_fused_stage if options.fused else None
    return ExpansionEngine(cfg=cfg, pop=default_pop_stage, rank=rank,
                           measure=stages.measure,
                           insert=default_insert_stage, grad=grad,
                           rank_fused=rank_fused,
                           measure_fused=stages.measure_fused,
                           grad_fused=grad_fused,
                           corpus_dtype=options.corpus_dtype,
                           adaptive=options.adaptive, c_max=options.c_max,
                           angle_tau=options.angle_tau, tile=options.tile)


@functools.lru_cache(maxsize=128)
def _build_cached(score_fn, meta, cfg, options):
    return _build(score_fn, meta, cfg, options)


def build_engine_from_fn(score_fn, cfg: SearchConfig,
                         options: EngineOptions = EngineOptions(),
                         meta: Optional[Tuple] = None) -> ExpansionEngine:
    """Engine for a bare ``score_fn``; ``meta`` resolves its kernel
    bundle. Cached per (score_fn, meta, cfg, options), as in the JAX
    package, so repeated calls reuse the engine and its captured
    programs."""
    meta = tuple(meta) if meta is not None else None
    return _build_cached(score_fn, meta, cfg, options)


def build_engine(measure, cfg: SearchConfig,
                 options: EngineOptions = EngineOptions()) -> ExpansionEngine:
    """Engine for a ``Measure``: its ``meta`` resolves the kernel bundle
    (cached as ``build_engine_from_fn``)."""
    return build_engine_from_fn(measure.score_fn, cfg, options,
                                getattr(measure, "meta", None))


def engine_search(measure, base, neighbors, queries, entries,
                  cfg: SearchConfig,
                  options: EngineOptions = EngineOptions()) -> SearchResult:
    """One-call convenience: build (cached) + run."""
    eng = build_engine(measure, cfg, options)
    return eng.search(measure.params, base, neighbors, queries, entries)
