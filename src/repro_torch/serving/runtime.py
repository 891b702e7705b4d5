"""Continuous-batching serving runtime of the port (the JAX package's
``serving/runtime.py``).

A oneshot batch steps until every lane is done, so under open-loop traffic
it finishes at the pace of its slowest lane. Here the engine's Q lanes are
slots. An admission queue holds arriving requests (arrival time and
deadline tagged); each scheduler round is

    admit    queued queries go into free lanes: the host writes them into
             the runtime program's buffers and runs its lane reset once
             (``ExpansionEngine.reset_lanes`` under the lane mask: entry
             seed, pool, visited words, counters; other lanes untouched)
    tick     ``steps_per_tick`` engine steps (finished lanes stay frozen
             by ``_freeze_done`` until harvested, as in the oneshot
             search), which also pack each lane's done flag, top-k and
             counters into one buffer
    harvest  one device-to-host copy of that buffer; lanes whose query
             converged stream out ``Completion``s and become free

On the card the reset and the tick are captured CUDA graphs
(``core/program.py``; the buffers are static, so neither is captured
again within an index epoch); on the CPU the same routines run eagerly.
Per-request results equal the oneshot ``ExpansionEngine.search`` of the
same query bit for bit (ids, scores, counters): the stages are lane-row
independent.

``ShardedContinuousRuntime`` runs one runtime per corpus partition, each
shard a fault domain (``serving/health.py``: circuit breaker + straggler
monitor; ``serving/faults.py``: the chaos hooks), and merges each
request's per-shard top-k on the host with ``core.sharded.merge_topk``.

Differences from the JAX runtime, each forced by the card:

- ``shared_fns`` is refused: a captured reset and tick are bound to their
  own runtime's state, buffers, store and neighbor table, so every shard
  captures its own (S shards: 2S graphs).
- ``fail_all`` writes the idle state into the program's state tensors in
  place; ``install_index`` builds a new program for the new store and
  neighbor table at the swap and drops the old epoch's graphs and
  buffers.
- A shard's fault domain strikes only the shard's own faults
  (``SHARD_FAULTS``: a chaos plan's ``InjectedFault``, an ``OSError``).
  Everything else a shard's round raises propagates: a kernel that fails
  to build or launch (``kernels._lib.CudaKernelError``), a wrapper's
  argument refusal, a failed capture or replay, a bug. Such an error is a
  fault of the port or the card, not of one shard, and it must not turn
  into partial answers.

Traced, the sharded runtime emits two site-scoped spans the JAX runtime
does not (``TRACE_SITES``; ``obs.attribution(..., sites=TRACE_SITES)``
counts them for every request they overlap): ``spans`` (site ``tracer``),
a shard's time writing its round's phase spans, and ``round`` (site
``merge``), the merge layer's bookkeeping and merges after the shards'
passes. Each is measured around that work alone; the stream loop between
rounds stays unattributed.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.corpus import CorpusStore, as_corpus_store
from repro_torch.core.engine import ExpansionEngine
from repro_torch.core.program import StateProgram
from repro_torch.core.sharded import _devices, merge_topk, shard_params
from repro_torch.obs.profile import annotate
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.faults import InjectedFault
from repro_torch.serving.health import ShardHealthTracker
from repro_torch.serving.metrics import RequestRecord, ServingMetrics
from repro_torch.serving.sla import SLAPolicy, resolve_tier

# what a shard's fault domain strikes; every other exception of a shard's
# round propagates (module docstring)
SHARD_FAULTS = (InjectedFault, OSError)
# the sites of the sharded runtime's own site-scoped spans (module
# docstring): pass as ``obs.attribution(spans, rid, sites=TRACE_SITES)``
TRACE_SITES = ("tracer", "merge")


@dataclasses.dataclass
class Request:
    """One query for the admission queue. ``t_arrive`` is seconds from the
    start of the stream (``run_stream``) or an absolute ``now_fn`` time
    (direct ``submit``); ``deadline`` is the seconds of queueing the
    request tolerates before it is dropped as timed out; ``budget_iters``
    caps its expansions (None: the engine config's cap); ``sla`` names an
    explicit tier when the runtime has an ``SLAPolicy`` (None: classify by
    deadline); ``angle_tau`` overrides the adaptive angle cutoff (None: the
    tier's or the engine's); ``degraded`` records that pressure admitted
    it below its tier (set by the runtime)."""
    rid: int
    query: np.ndarray
    t_arrive: float = 0.0
    entry: Optional[int] = None
    deadline: Optional[float] = None
    budget_iters: Optional[int] = None
    sla: Optional[str] = None
    angle_tau: Optional[float] = None
    degraded: bool = False


@dataclasses.dataclass
class Completion:
    rid: int
    ids: np.ndarray        # (k,) int64
    scores: np.ndarray     # (k,) float32
    n_eval: int
    n_grad: int
    n_iters: int
    lane: int
    record: RequestRecord
    epoch: int = 0         # index version the request was admitted under
    # degradation ladder outcome: "ok" = full answer; "partial" = merged
    # over surviving shards only; "timeout" = deadline drop; "shed" =
    # load-shed at admission; "failed" = every fault domain holding it
    # failed. Anything but "ok" carries ids -1 / scores -inf or a flagged
    # subset, never a silently wrong full answer.
    status: str = "ok"
    partial: bool = False


def poisson_arrivals(n: int, qps: float, seed: int = 0) -> np.ndarray:
    """Open-loop Poisson arrival offsets (seconds): cumsum of Exp(1/qps)."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=n))


def _pack(state, k: int) -> torch.Tensor:
    """(L, 2k + 4) int64 rows of [ids | score bits | n_eval, n_grad,
    n_iters, done]: one device-to-host copy brings back a harvest."""
    return torch.cat([
        state.pool_ids[:, :k],
        state.pool_scores[:, :k].contiguous().view(torch.int32).long(),
        torch.stack([state.n_eval, state.n_grad, state.n_iters,
                     state.done.int()], dim=1).long()], dim=1)


def _empty(k: int) -> Tuple[np.ndarray, np.ndarray]:
    return np.full((k,), -1, np.int64), np.full((k,), -np.inf, np.float32)


class ContinuousRuntime:
    """Lane-recycling scheduler over one ``ExpansionEngine``. Shapes are
    fixed per index epoch (n_lanes x corpus), so the reset and the tick
    are captured once per epoch and replayed."""

    def __init__(self, engine: ExpansionEngine, params, corpus, neighbors,
                 n_lanes: int, query_dim: int, entry: int = 0,
                 steps_per_tick: int = 4,
                 now_fn: Callable[[], float] = time.perf_counter,
                 max_queue: Optional[int] = None,
                 fault_hook: Optional[Callable[[], float]] = None,
                 shared_fns: Optional[tuple] = None,
                 tracer=NULL_TRACER, trace_site: str = "",
                 trace_owner: bool = True,
                 sla_policy: Optional[SLAPolicy] = None, device=None):
        if shared_fns is not None:
            raise ValueError(
                "shared_fns: a captured reset and tick are bound to their "
                "own runtime's state, buffers, store and neighbor table, "
                "so runtimes cannot share them; each runtime captures its "
                "own (ShardedContinuousRuntime: two graphs per shard)")
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        if steps_per_tick < 1:
            raise ValueError(
                f"steps_per_tick must be >= 1, got {steps_per_tick}")
        if device is None:
            device = corpus.device if isinstance(
                corpus, (torch.Tensor, CorpusStore)) else DEFAULT_DEVICE
        self.device = resolve_device(device)
        self.engine = engine
        self.params = params
        self.n_lanes = n_lanes
        self.query_dim = query_dim
        self.default_entry = entry
        self.steps_per_tick = steps_per_tick
        self._now = now_fn
        # bounded admission: beyond max_queue queued requests a submit is
        # shed; with an SLA policy the ladder degrades first (floor-tier
        # admission at max_queue) and sheds past 2 x max_queue
        self.max_queue = max_queue
        self.sla_policy = sla_policy
        # EMA of service time (admit -> done): a request whose remaining
        # deadline is under it is admitted one tier down
        self._ema_service_s = 0.0
        # chaos surface (serving/faults.py): consulted once per busy tick,
        # before the replay; returns extra reported tick seconds or raises
        self.fault_hook = fault_hook
        self.tick_penalty_s = 0.0
        self._closing = False
        # telemetry: spans go to the injected tracer (the NullTracer
        # default costs one attribute lookup per guard). ``trace_site``
        # labels this runtime's spans (the sharded runtime passes
        # "shard:<s>"); ``trace_owner=False``: the layer above owns the
        # request root span, this runtime emits phase spans only
        self.tracer = tracer
        self.trace_site = trace_site
        self._trace_owner = trace_owner
        self._queue_spans: Dict[int, int] = {}
        self._n_ticks = 0

        self.epoch = 0
        self._pending_index: Optional[tuple] = None
        self._lane_epoch: List[int] = [0] * n_lanes
        # the routines each earlier epoch's program captured
        self.epoch_captures: List[tuple] = []
        self.queue: collections.deque[Request] = collections.deque()
        self._lane_req: List[Optional[Request]] = [None] * n_lanes
        self._admit_time: List[float] = [0.0] * n_lanes
        self._queries_np = np.zeros((n_lanes, query_dim), np.float32)
        self._entries_np = np.full((n_lanes,), entry, np.int64)
        self._caps_np = np.full((n_lanes,), engine.cfg.iters(), np.int32)
        self._taus_np = np.full((n_lanes,), engine.angle_tau, np.float32)
        self.completions: List[Completion] = []
        self.metrics = ServingMetrics(n_lanes)
        self._rid_gen = itertools.count()
        self._set_index(corpus, neighbors)

    def _set_index(self, corpus, neighbors) -> None:
        """The store, neighbor table and the program of one epoch: an idle
        state, the buffers, the reset and the tick over them."""
        dev, engine, params = self.device, self.engine, self.params
        self.program = None     # the old epoch's graphs and buffers go first
        self.store = as_corpus_store(corpus, engine.corpus_dtype, device=dev)
        if self.store.device != dev:
            raise ValueError(f"corpus on {self.store.device}, runtime on "
                             f"{dev}")
        self.neighbors = torch.as_tensor(neighbors, device=dev)
        k, L = engine.cfg.k, self.n_lanes
        bufs = {"queries": torch.zeros((L, self.query_dim),
                                       dtype=torch.float32, device=dev),
                "entries": torch.zeros((L,), dtype=torch.int64, device=dev),
                "mask": torch.zeros((L,), dtype=torch.bool, device=dev),
                "caps": torch.zeros((L,), dtype=torch.int32, device=dev),
                "taus": torch.zeros((L,), dtype=torch.float32, device=dev),
                "harvest": torch.zeros((L, 2 * k + 4), dtype=torch.int64,
                                       device=dev)}
        program = StateProgram(engine.idle_state(L, self.store.n, dev), bufs)
        store, nbrs = self.store, self.neighbors

        def reset(b, s):
            return engine.reset_lanes(params, store, b["queries"],
                                      b["entries"], s, b["mask"], b["caps"],
                                      b["taus"]), {}
        steps = engine.step_routine(params, store, nbrs, self.steps_per_tick)

        def tick(b, s):
            s, _ = steps(b, s)
            return s, {"harvest": _pack(s, k)}
        program.add("reset", reset)
        program.add("tick", tick)
        self.program = program

    # -- queue side ---------------------------------------------------------

    @property
    def in_flight(self) -> int:
        return sum(r is not None for r in self._lane_req)

    def submit(self, query: np.ndarray, rid: Optional[int] = None,
               entry: Optional[int] = None, deadline: Optional[float] = None,
               t_arrive: Optional[float] = None,
               budget_iters: Optional[int] = None,
               sla: Optional[str] = None,
               angle_tau: Optional[float] = None) -> int:
        rid = rid if rid is not None else next(self._rid_gen)
        t = t_arrive if t_arrive is not None else self._now()
        tr = self.tracer
        if tr.enabled and tr.sampled(rid):
            # idempotent: under the sharded fan-out the merge layer has
            # already created this rid's root; we parent to it
            root = tr.root_for(rid, t0=t)
            self._queue_spans[rid] = tr.begin(
                "queue", t0=t, rid=rid, site=self.trace_site, parent=root)
        tier = resolve_tier(self.sla_policy, sla, deadline)
        degraded = False
        pressured = (self.max_queue is not None
                     and len(self.queue) >= self.max_queue)
        if self._closing or (pressured and (
                tier is None
                or len(self.queue) >= 2 * self.max_queue)):
            self._resolve_sentinel(rid, t, "shed",
                                   sla=tier.name if tier else "")
            return rid
        eff = tier
        if pressured:
            # degrade-before-shed: admit at the policy floor; the record
            # keeps the original tier's name, ``degraded`` the outcome
            eff = self.sla_policy.floor()
            degraded = eff.name != tier.name
        if eff is not None:
            if budget_iters is None:
                budget_iters = eff.iter_cap
            if angle_tau is None:
                angle_tau = eff.angle_tau
        self.queue.append(Request(rid, np.asarray(query, np.float32), t,
                                  entry, deadline, budget_iters,
                                  sla=tier.name if tier else sla,
                                  angle_tau=angle_tau, degraded=degraded))
        return rid

    def _sentinel(self, rid: int, rec: RequestRecord,
                  status: str) -> Completion:
        """Resolve a request without a search: ids -1, scores -inf,
        flagged by ``status``; it completes exactly once."""
        ids, scores = _empty(self.engine.cfg.k)
        c = Completion(rid, ids, scores, 0, 0, 0, -1, rec, self.epoch,
                       status=status)
        self.metrics.observe(rec)
        self.completions.append(c)
        tr = self.tracer
        if tr.enabled:
            qs = self._queue_spans.pop(rid, None)
            if qs is not None:
                tr.end(qs, t1=rec.t_done, status=status)
            if self._trace_owner and tr.sampled(rid):
                tr.finish_request(rid, t1=rec.t_done, status=status)
        return c

    def _resolve_sentinel(self, rid: int, t_arrive: float, status: str,
                          sla: str = "") -> Completion:
        now = self._now()
        return self._sentinel(rid, RequestRecord(
            rid, t_arrive, now, now, shed=(status == "shed"),
            failed=(status == "failed"), sla=sla), status)

    def complete_failed(self, rid: int,
                        t_arrive: Optional[float] = None) -> Completion:
        """Resolve one rid as failed without queueing it (the sharded
        runtime synthesizes parts for breaker-open shards this way)."""
        t = t_arrive if t_arrive is not None else self._now()
        return self._resolve_sentinel(rid, t, "failed")

    def shed_queue(self) -> List[Completion]:
        """Shed every queued request (graceful drain)."""
        out = []
        while self.queue:
            req = self.queue.popleft()
            out.append(self._resolve_sentinel(req.rid, req.t_arrive, "shed",
                                              sla=req.sla or ""))
        return out

    def fail_all(self) -> List[Completion]:
        """Resolve everything this runtime holds as failed (lanes in
        flight and queued requests) and park every lane: the idle state is
        written into the program's state in place, so the captured reset
        and tick go on reading the same tensors. Called when this
        runtime's fault domain is declared dead (its breaker opens)."""
        out = []
        for lane in range(self.n_lanes):
            req = self._lane_req[lane]
            if req is not None:
                self._lane_req[lane] = None
                out.append(self._resolve_sentinel(req.rid, req.t_arrive,
                                                  "failed"))
        while self.queue:
            req = self.queue.popleft()
            out.append(self._resolve_sentinel(req.rid, req.t_arrive,
                                              "failed"))
        self.program.assign(self.engine.idle_state(
            self.n_lanes, self.store.n, self.device))
        return out

    # -- index-version epochs -----------------------------------------------

    def install_index(self, corpus, neighbors, entry: Optional[int] = None
                      ) -> int:
        """Stage a new index version (corpus store + neighbor table +
        optional entry point). The swap is deferred: lanes in flight
        finish against the epoch they were admitted under, admissions
        hold while the swap is pending, and once the lanes drain the new
        index swaps in with a new program (its reset and tick captured at
        their first run; the old epoch's graphs and buffers are dropped).
        Returns the epoch the staged index will serve as; each
        ``Completion.epoch`` records the version its request ran against."""
        self._pending_index = (corpus, neighbors, entry)
        return self.epoch + 1

    def _maybe_swap_index(self) -> bool:
        if self._pending_index is None or self.in_flight:
            return False
        corpus, neighbors, entry = self._pending_index
        self._pending_index = None
        self.epoch_captures.append(self.program.captured)
        self._set_index(corpus, neighbors)
        if entry is not None:
            self.default_entry = int(entry)
        self._entries_np[:] = self.default_entry
        self.epoch += 1
        return True

    # -- scheduler round ----------------------------------------------------

    def _admit(self, now: float) -> List[Completion]:
        dropped: List[Completion] = []
        if self._pending_index is not None:
            return dropped      # admissions hold until the staged epoch
        free = [lane for lane in range(self.n_lanes)
                if self._lane_req[lane] is None]
        if not free or not self.queue:
            return dropped
        tr = self.tracer
        mask = np.zeros((self.n_lanes,), bool)
        while free and self.queue:
            req = self.queue.popleft()
            if req.deadline is not None and now - req.t_arrive > req.deadline:
                # dropped, but still completed: every rid resolves once
                dropped.append(self._sentinel(req.rid, RequestRecord(
                    req.rid, req.t_arrive, now, now, timed_out=True,
                    sla=req.sla or "", degraded=req.degraded), "timeout"))
                continue
            cap, tau = req.budget_iters, req.angle_tau
            if (self.sla_policy is not None and req.sla
                    and req.deadline is not None
                    and self._ema_service_s > 0.0
                    and req.deadline - (now - req.t_arrive)
                    < self._ema_service_s):
                # deadline-aware degrade: the remaining budget is under the
                # typical service time, so drop one rung
                down = self.sla_policy.degrade(self.sla_policy.get(req.sla))
                if down is not None:
                    cap = (down.iter_cap if down.iter_cap is not None
                           else cap)
                    tau = down.angle_tau
                    req.degraded = True
            lane = free.pop(0)
            mask[lane] = True
            if tr.enabled:
                qs = self._queue_spans.pop(req.rid, None)
                if qs is not None:
                    tr.end(qs, t1=now, lane=lane)
            self._lane_req[lane] = req
            self._lane_epoch[lane] = self.epoch
            self._admit_time[lane] = now
            self._queries_np[lane] = req.query
            self._entries_np[lane] = (req.entry if req.entry is not None
                                      else self.default_entry)
            self._caps_np[lane] = (cap if cap is not None
                                   else self.engine.cfg.iters())
            self._taus_np[lane] = (tau if tau is not None
                                   else self.engine.angle_tau)
        if mask.any():
            self.program.load(queries=self._queries_np,
                              entries=self._entries_np, mask=mask,
                              caps=self._caps_np, taus=self._taus_np)
            with annotate("repro/reset"):
                self.program.run("reset")
        return dropped

    def _tick(self) -> None:
        self.tick_penalty_s = 0.0
        busy = self.in_flight
        if not busy:
            return
        if self.fault_hook is not None:
            # before the replay: an injected crash leaves the state as it
            # was, so the next round retries the tick exactly; a stall or
            # slow tick reports extra seconds for the sharded runtime's
            # deadline check and straggler monitor
            self.tick_penalty_s = float(self.fault_hook() or 0.0)
        with annotate("repro/tick"):
            self.program.run("tick")
        self._n_ticks += 1
        self.metrics.observe_occupancy(busy, self.n_lanes,
                                       self.steps_per_tick)

    def _harvest(self, now: float) -> List[Completion]:
        occupied = [lane for lane in range(self.n_lanes)
                    if self._lane_req[lane] is not None]
        if not occupied:
            return []
        # one copy per round: done + results + counters together (its sync
        # is where the host waits for the tick)
        k = self.engine.cfg.k
        packed = self.program.buffers["harvest"].cpu().numpy()
        ids = packed[:, :k]
        scores = packed[:, k:2 * k].astype(np.int32).view(np.float32)
        n_eval, n_grad, n_iters, done = packed[:, 2 * k:].T
        out = []
        for lane in occupied:
            if not done[lane]:
                continue
            req = self._lane_req[lane]
            service = now - self._admit_time[lane]
            self._ema_service_s = (service if self._ema_service_s == 0.0
                                   else 0.9 * self._ema_service_s
                                   + 0.1 * service)
            rec = RequestRecord(req.rid, req.t_arrive,
                                self._admit_time[lane], now,
                                int(n_eval[lane]), int(n_grad[lane]),
                                int(n_iters[lane]), sla=req.sla or "",
                                degraded=req.degraded)
            c = Completion(req.rid, ids[lane].copy(), scores[lane].copy(),
                           int(n_eval[lane]), int(n_grad[lane]),
                           int(n_iters[lane]), lane, rec,
                           self._lane_epoch[lane])
            self.metrics.observe(rec)
            self.completions.append(c)
            self._lane_req[lane] = None
            out.append(c)
        return out

    def step_once(self) -> List[Completion]:
        """One admit -> tick -> harvest round; returns every request that
        resolved in it (harvested results and deadline drops). A staged
        index (``install_index``) swaps in at the top of the round once
        the previous epoch's lanes have all harvested."""
        self._maybe_swap_index()
        self.metrics.observe_queue_depth(len(self.queue))
        tr = self.tracer
        if not tr.enabled:
            dropped = self._admit(self._now())
            self._tick()
            return dropped + self._harvest(self._now())
        # traced round: four shared timestamps tile the round, so the
        # per-request phase spans (admit / tick / harvest) cover its wall
        # clock. The tick span covers the replay's dispatch only: the card
        # works asynchronously, and the harvest copy's sync carries the
        # device wait
        t0 = self._now()
        dropped = self._admit(t0)
        t1 = self._now()
        self._tick()
        t2 = self._now()
        harvested = self._harvest(t2)
        t3 = self._now()
        if self._emit_round_spans(t0, t1, t2, t3, harvested) \
                and not self._trace_owner:
            # under the sharded fan-out, the tracer's own time on this
            # round is a site-scoped span (module docstring)
            tr.emit("spans", t3, self._now(), site="tracer",
                    shard=self.trace_site)
        return dropped + harvested

    def _emit_round_spans(self, t0: float, t1: float, t2: float, t3: float,
                          harvested: List[Completion]) -> bool:
        """The round's phase spans of every sampled rid (the JAX
        runtime's); returns whether there was one."""
        tr = self.tracer
        rids = [r.rid for r in self._lane_req
                if r is not None and tr.sampled(r.rid)]
        rids += [c.rid for c in harvested
                 if c.lane >= 0 and tr.sampled(c.rid)]
        site = self.trace_site
        for rid in rids:
            root = tr.root_for(rid)
            if t1 > t0:
                tr.emit("admit", t0, t1, rid=rid, site=site, parent=root)
            if t2 > t1:
                tr.emit("tick", t1, t2, rid=rid, site=site, parent=root,
                        i=self._n_ticks, steps=self.steps_per_tick)
            if t3 > t2:
                tr.emit("harvest", t2, t3, rid=rid, site=site, parent=root)
        if self._trace_owner:
            for c in harvested:
                if c.lane >= 0 and tr.sampled(c.rid):
                    tr.finish_request(c.rid, t1=t3, status=c.status)
        return bool(rids)

    def close(self) -> List[Completion]:
        """Graceful drain: admit nothing more (late submits are shed), shed
        the queue, finish the lanes in flight."""
        self._closing = True
        out = self.shed_queue()
        while self.in_flight:
            out += self.step_once()
        if self._trace_owner and self.tracer.enabled:
            # a span whose request never resolved surfaces flagged
            # open=True rather than vanishing
            self.tracer.drain()
        return out

    def pop_completions(self) -> List[Completion]:
        out, self.completions = self.completions, []
        return out

    # -- observability ------------------------------------------------------

    def bind_registry(self, registry):
        """Register this runtime's serving metric families into an
        ``obs.Registry``. Call after ``warmup()``, which replaces
        ``self.metrics``. (The JAX runtime also binds a paged store's
        families; paged residency is not ported yet.)"""
        self.metrics.bind_registry(registry)
        return registry

    def health_snapshot(self) -> dict:
        recs = self.metrics.records
        return {"queue": len(self.queue), "in_flight": self.in_flight,
                "completed": sum(not (r.timed_out or r.shed or r.failed)
                                 for r in recs),
                "timed_out": sum(r.timed_out for r in recs),
                "shed": sum(r.shed for r in recs),
                "failed": sum(r.failed for r in recs)}

    def format_health(self) -> str:
        s = self.health_snapshot()
        return (f"[health] queue={s['queue']} in_flight={s['in_flight']} "
                f"completed={s['completed']} timed_out={s['timed_out']} "
                f"shed={s['shed']} failed={s['failed']}")

    def warmup(self, query: np.ndarray) -> None:
        """Capture the reset and the tick off the clock: one sentinel
        request to completion, its completion and metrics discarded.
        Raises unless the sentinel comes back ``ok``."""
        done = self.run_stream([Request(rid=-1, query=np.asarray(query))],
                               realtime=False)
        status = [c.status for c in done if c.rid == -1]
        if status != ["ok"]:
            raise RuntimeError(f"warmup: the sentinel request resolved as "
                               f"{status}, not ok")
        self.metrics = ServingMetrics(self.n_lanes)

    # -- open-loop driver ---------------------------------------------------

    def run_stream(self, requests: Sequence[Request],
                   realtime: bool = True,
                   health_every_s: Optional[float] = None
                   ) -> List[Completion]:
        """Drive a pre-scheduled stream to completion. ``t_arrive`` offsets
        are seconds from the start of the run; arrivals are open-loop.
        ``realtime=False`` makes every request due at once, stamped as
        arriving at submission (arrival order still follows the offsets).
        ``health_every_s`` prints a ``format_health`` line that often."""
        pending = collections.deque(
            sorted(requests, key=lambda r: r.t_arrive))
        t0 = self._now()
        t_health = t0
        while pending or self.queue or self.in_flight:
            if health_every_s is not None \
                    and self._now() - t_health >= health_every_s:
                t_health = self._now()
                print(self.format_health())
            now = self._now() - t0
            while pending and (not realtime or pending[0].t_arrive <= now):
                r = pending.popleft()
                self.submit(r.query, rid=r.rid, entry=r.entry,
                            deadline=r.deadline,
                            t_arrive=(t0 + r.t_arrive) if realtime
                            else self._now(),
                            budget_iters=r.budget_iters, sla=r.sla,
                            angle_tau=r.angle_tau)
            if realtime and not self.queue and not self.in_flight and pending:
                dt = pending[0].t_arrive - (self._now() - t0)
                if dt > 0:
                    time.sleep(min(dt, 0.005))
                continue
            self.step_once()
        return self.pop_completions()


class ShardedContinuousRuntime:
    """Continuous batching over a partitioned corpus: one lane-recycling
    runtime per shard (shard s on ``devices[s % len(devices)]``, default
    the card, with the stores and neighbor tables ``ShardedIndex.stores``
    and ``placed`` cache), a request fans out to every shard, and each
    request merges its per-shard top-k on the host with
    ``core.sharded.merge_topk`` (bit for bit the one-shot sharded search's
    merge). Counters follow the sharded accounting: ``n_eval`` / ``n_grad``
    sum over shards, ``n_iters`` is the max.

    Each shard is a **fault domain**: a ``ShardHealthTracker`` (circuit
    breaker + straggler monitor) takes a strike whenever a shard's round
    raises one of ``SHARD_FAULTS``, the straggler monitor escalates it, or
    its tick time (host clock, through the harvest copy's sync,
    plus the fault hook's reported penalty) blows ``tick_deadline_s``;
    ``k_failures`` consecutive strikes open the breaker: the shard's work
    resolves as failed parts, it receives no traffic for
    ``cooldown_rounds`` rounds, then probes half-open and one clean busy
    tick re-admits it. Merges proceed over the surviving shards, flagged
    ``partial``; only if every shard failed does the rid resolve as
    ``failed`` (ids -1). Any other error of a shard's round propagates
    (module docstring). ``fault_plan`` installs a chaos
    schedule's tick hooks (site ``shard:<s>/tick``)."""

    def __init__(self, engine: ExpansionEngine, params, index, n_lanes: int,
                 query_dim: int, steps_per_tick: int = 4,
                 now_fn: Callable[[], float] = time.perf_counter,
                 max_queue: Optional[int] = None,
                 tick_deadline_s: Optional[float] = None,
                 k_failures: int = 3, cooldown_rounds: int = 8,
                 fault_plan=None, tracer=NULL_TRACER,
                 sla_policy: Optional[SLAPolicy] = None,
                 devices: Optional[Sequence] = None,
                 params_by_device=None):
        self.engine = engine
        self.index = index
        self.max_queue = max_queue
        # tiers resolve here, once per rid: shards receive the resolved
        # knobs (cap / tau), so a rid runs the same tier on every shard
        self.sla_policy = sla_policy
        self._sla_info: Dict[int, tuple] = {}
        self.tick_deadline_s = tick_deadline_s
        self._closing = False
        self.tracer = tracer
        # merge-window open time per sampled rid: stamped when the first
        # shard part lands, so the "merge" span covers the straggler wait
        self._merge_open: Dict[int, float] = {}
        self.health = ShardHealthTracker(index.n_shards,
                                         k_failures=k_failures,
                                         cooldown_rounds=cooldown_rounds)
        self.devices = _devices(devices)
        stores = index.stores(engine.corpus_dtype, self.devices)
        self.runtimes: List[ContinuousRuntime] = []
        for s in range(index.n_shards):
            dev = stores[s].device
            hook = (fault_plan.tick_hook(f"shard:{s}/tick")
                    if fault_plan is not None else None)
            self.runtimes.append(ContinuousRuntime(
                engine, shard_params(params, dev, params_by_device),
                stores[s], index.placed(s, dev)[0], n_lanes, query_dim,
                entry=int(index.entries[s]), steps_per_tick=steps_per_tick,
                now_fn=now_fn, fault_hook=hook, tracer=tracer,
                trace_site=f"shard:{s}", trace_owner=False, device=dev))
        self.n_lanes = n_lanes
        self.metrics = ServingMetrics(n_lanes * index.n_shards)
        self.completions: List[Completion] = []
        self._partial: Dict[int, List[Optional[Completion]]] = {}
        self._rid_gen = itertools.count()
        self._indices: Dict[int, object] = {0: index}
        self.n_rounds = 0

    def install_index(self, index) -> int:
        """Stage a new ``ShardedIndex`` version on every shard runtime.
        Each shard swaps when its lanes drain (one install moves every
        shard by one epoch), and the merge maps each part's local ids
        through the ``global_ids`` of the epoch that shard searched, so
        harvests straddling the swap stay correct. Returns the staged
        epoch number."""
        if index.n_shards != len(self.runtimes):
            raise ValueError(
                f"staged index has {index.n_shards} shards, runtime has "
                f"{len(self.runtimes)}")
        epoch = max(self._indices) + 1
        self._indices[epoch] = index
        self.index = index
        stores = index.stores(self.engine.corpus_dtype, self.devices)
        for s, rt in enumerate(self.runtimes):
            rt.install_index(stores[s], index.placed(s, rt.device)[0],
                             int(index.entries[s]))
        return epoch

    @property
    def in_flight(self) -> int:
        return max(rt.in_flight for rt in self.runtimes)

    @property
    def queued(self) -> int:
        return max(len(rt.queue) for rt in self.runtimes)

    def submit(self, query: np.ndarray, rid: Optional[int] = None,
               deadline: Optional[float] = None,
               t_arrive: Optional[float] = None,
               budget_iters: Optional[int] = None,
               sla: Optional[str] = None,
               angle_tau: Optional[float] = None) -> int:
        """No per-request ``entry`` here: entry ids are partition-local
        rows, so each shard searches from its own entry point."""
        rid = rid if rid is not None else next(self._rid_gen)
        now_fn = self.runtimes[0]._now
        t = t_arrive if t_arrive is not None else now_fn()
        tr = self.tracer
        traced = tr.enabled and tr.sampled(rid)
        if traced:
            # the merge layer owns the root's lifecycle; the shards'
            # runtimes parent their phase spans to it
            tr.root_for(rid, t0=t)
        tier = resolve_tier(self.sla_policy, sla, deadline)
        degraded = False
        pressured = (self.max_queue is not None
                     and self.queued >= self.max_queue)
        if self._closing or (pressured and (
                tier is None or self.queued >= 2 * self.max_queue)):
            # shed at the top level: per-shard sheds would desync rid
            # resolution across the fan-out
            now = now_fn()
            rec = RequestRecord(rid, t, now, now, shed=True,
                                sla=tier.name if tier else "")
            ids, scores = _empty(self.engine.cfg.k)
            self.metrics.observe(rec)
            self.completions.append(Completion(
                rid, ids, scores, 0, 0, 0, -1, rec, max(self._indices),
                status="shed"))
            if traced:
                tr.emit("queue", t, now, rid=rid,
                        parent=tr.root_for(rid), status="shed")
                tr.finish_request(rid, t1=now, status="shed")
            return rid
        eff = tier
        if pressured:
            # degrade-before-shed (the single runtime's ladder)
            eff = self.sla_policy.floor()
            degraded = eff.name != tier.name
        if eff is not None:
            if budget_iters is None:
                budget_iters = eff.iter_cap
            if angle_tau is None:
                angle_tau = eff.angle_tau
            self._sla_info[rid] = (tier.name, degraded)
        for s, rt in enumerate(self.runtimes):
            if self.health.serving(s):
                rt.submit(query, rid=rid, deadline=deadline, t_arrive=t,
                          budget_iters=budget_iters,
                          sla=tier.name if tier else None,
                          angle_tau=angle_tau)
            else:
                # breaker open: this shard's part resolves as failed up
                # front, so the rid's merge window never misses a slot
                rt.complete_failed(rid, t)
        return rid

    def _shard_failed(self, s: int, reason: str) -> bool:
        opened = self.health.record_failure(s, reason)
        if opened:
            # out of rotation: everything the shard holds resolves as
            # failed parts. A strike short of opening leaves its work in
            # place; the next round retries it.
            self.runtimes[s].fail_all()
        return opened

    def step_once(self) -> List[Completion]:
        """One round: each serving shard's admit -> tick -> harvest in
        turn (its time, through the harvest's sync, feeds the deadline
        check and the straggler monitor), then the merge of every rid
        whose parts have all arrived."""
        self.health.on_round()
        self.n_rounds += 1
        now_fn = self.runtimes[0]._now
        times = {}
        for s, rt in enumerate(self.runtimes):
            if not self.health.serving(s):
                continue
            probe = rt.in_flight > 0 or bool(rt.queue)
            t0 = now_fn()
            try:
                rt.step_once()
            except SHARD_FAULTS as err:
                self._shard_failed(s, repr(err))
                continue
            dt = (now_fn() - t0) + rt.tick_penalty_s
            if self.tick_deadline_s is not None and dt > self.tick_deadline_s:
                self._shard_failed(
                    s, f"tick {dt:.3f}s > deadline {self.tick_deadline_s}s")
                continue
            times[s] = min(dt, 1e6)     # stalls report inf
            self.health.record_success(s, probed=probe)
        tr = self.tracer
        t_shards = now_fn() if tr.enabled else 0.0
        self.health.record_tick_times(times)
        # the merged occupancy mirrors the shards' tick samples
        self.metrics.sync_occupancy(
            sum(rt.metrics._busy_steps for rt in self.runtimes),
            sum(rt.metrics._lane_steps for rt in self.runtimes))
        self.metrics.observe_queue_depth(self.queued)
        out = self._merge_ready()
        if tr.enabled:
            # the merge layer's own time this round (module docstring)
            tr.emit("round", t_shards, now_fn(), site="merge",
                    i=self.n_rounds)
        return out

    def _merge_ready(self) -> List[Completion]:
        S = len(self.runtimes)
        tr = self.tracer
        now_fn = self.runtimes[0]._now
        for s, rt in enumerate(self.runtimes):
            for c in rt.pop_completions():
                if tr.enabled and c.rid not in self._merge_open \
                        and tr.sampled(c.rid):
                    self._merge_open[c.rid] = now_fn()
                self._partial.setdefault(c.rid, [None] * S)[s] = c
        out = []
        k = self.engine.cfg.k
        for rid in [r for r, ps in self._partial.items()
                    if all(p is not None for p in ps)]:
            parts = self._partial.pop(rid)
            live = [(s, p) for s, p in enumerate(parts)
                    if p.status not in ("failed", "shed")]
            ids, scores = _empty(k)
            if any(p.status == "shed" for p in parts):
                # a drain-time shed on the serving shards: shed here too
                status = "shed"
            elif not live:
                # every shard in the window failed: resolve with ids -1
                # instead of raising or waiting forever
                status = "failed"
            elif any(p.record.timed_out for _, p in live):
                # shards can disagree about a deadline (admit times
                # differ); a merge missing a partition is not a top-k
                status = "timeout"
            else:
                # the merge over the shards that answered; a failed shard
                # makes the answer partial, flagged
                ids, scores = _merge_one([
                    (self._local_to_global(s, p), p.scores)
                    for s, p in live], k)
                status = ("partial" if any(p.status == "failed"
                                           for p in parts) else "ok")
            live_p = [p for _, p in live]
            src = live_p if live_p else parts
            sla_name, degraded = self._sla_info.pop(rid, ("", False))
            # a per-shard deadline degrade counts at the merged level too
            degraded = degraded or any(p.record.degraded for p in parts)
            rec = RequestRecord(
                rid, min(p.record.t_arrive for p in parts),
                max(p.record.t_admit for p in src),
                max(p.record.t_done for p in src),
                sum(p.n_eval for p in live_p),
                sum(p.n_grad for p in live_p),
                max((p.n_iters for p in live_p), default=0),
                timed_out=(status == "timeout"), shed=(status == "shed"),
                failed=(status == "failed"),
                partial=(status == "partial"),
                sla=sla_name, degraded=degraded)
            c = Completion(rid, ids, scores,
                           rec.n_eval, rec.n_grad, rec.n_iters, -1, rec,
                           max(p.epoch for p in parts), status=status,
                           partial=(status == "partial"))
            self.metrics.observe(rec)
            self.completions.append(c)
            out.append(c)
            if tr.enabled and tr.sampled(rid):
                now = now_fn()
                tr.emit("merge", self._merge_open.pop(rid, now), now,
                        rid=rid, parent=tr.root_for(rid), status=status,
                        shards=len(live))
                tr.finish_request(rid, t1=now, status=status)
        return out

    def _local_to_global(self, s: int, part: Completion) -> np.ndarray:
        """A part's shard-local ids as corpus ids, through the global ids
        of the epoch that shard searched (padded rows and -1 stay -1)."""
        gids = self._indices[part.epoch].global_ids[s]
        return np.where(part.ids >= 0, gids[np.maximum(part.ids, 0)], -1)

    def pop_completions(self) -> List[Completion]:
        out, self.completions = self.completions, []
        return out

    def close(self) -> List[Completion]:
        """Graceful drain at the merged level: admit nothing new, shed the
        queued requests (their merge windows resolve as shed), then run
        rounds until every rid in flight has merged."""
        self._closing = True
        out = []
        for rt in self.runtimes:
            rt.shed_queue()
        # un-popped per-shard parts (e.g. synthesized failures) count as
        # unresolved work: every rid must merge before the drain ends
        while self.in_flight or self._partial \
                or any(rt.completions for rt in self.runtimes):
            out += self.step_once()
        if self.tracer.enabled:
            self.tracer.drain()
        return out

    def warmup(self, query: np.ndarray) -> None:
        """Capture every shard's reset and tick off the clock: each shard
        runtime's own ``warmup`` (one sentinel request, its fault hook
        off), outside the fault domains, so a shard that cannot build,
        capture or run raises here. Shard health is untouched; the merged
        metrics start afresh."""
        for rt in self.runtimes:
            hook, rt.fault_hook = rt.fault_hook, None
            try:
                rt.warmup(query)
            finally:
                rt.fault_hook = hook
        self.metrics = ServingMetrics(self.n_lanes * len(self.runtimes))

    # -- observability ------------------------------------------------------

    def bind_registry(self, registry):
        """Register the merged serving metrics and the per-shard health
        into an ``obs.Registry`` (after ``warmup()``, which replaces
        both)."""
        self.metrics.bind_registry(registry)
        self.health.bind_registry(registry)
        return registry

    def health_snapshot(self) -> dict:
        recs = self.metrics.records
        return {"shards": self.health.states(),
                "breaker_opens": self.health.n_opened,
                "queue": self.queued, "in_flight": self.in_flight,
                "completed": sum(not (r.timed_out or r.shed or r.failed)
                                 for r in recs),
                "partial": sum(r.partial for r in recs),
                "timed_out": sum(r.timed_out for r in recs),
                "shed": sum(r.shed for r in recs),
                "failed": sum(r.failed for r in recs)}

    def format_health(self) -> str:
        s = self.health_snapshot()
        return (f"[health] shards=[{','.join(s['shards'])}] "
                f"opens={s['breaker_opens']} queue={s['queue']} "
                f"in_flight={s['in_flight']} completed={s['completed']} "
                f"partial={s['partial']} timed_out={s['timed_out']} "
                f"shed={s['shed']} failed={s['failed']}")

    def run_stream(self, requests: Sequence[Request],
                   realtime: bool = True,
                   health_every_s: Optional[float] = None
                   ) -> List[Completion]:
        now_fn = self.runtimes[0]._now
        pending = collections.deque(
            sorted(requests, key=lambda r: r.t_arrive))
        t0 = now_fn()
        t_health = t0
        while pending or self.queued or self.in_flight or self._partial \
                or any(rt.completions for rt in self.runtimes):
            if health_every_s is not None \
                    and now_fn() - t_health >= health_every_s:
                t_health = now_fn()
                print(self.format_health())
            now = now_fn() - t0
            while pending and (not realtime or pending[0].t_arrive <= now):
                r = pending.popleft()
                if r.entry is not None:
                    raise ValueError(
                        "Request.entry is partition-local and cannot be "
                        "honored by the sharded runtime; leave it None")
                self.submit(r.query, rid=r.rid, deadline=r.deadline,
                            t_arrive=(t0 + r.t_arrive) if realtime
                            else now_fn(),
                            budget_iters=r.budget_iters, sla=r.sla,
                            angle_tau=r.angle_tau)
            if realtime and not self.queued and not self.in_flight \
                    and not self._partial and pending:
                dt = pending[0].t_arrive - (now_fn() - t0)
                if dt > 0:
                    time.sleep(min(dt, 0.005))
                continue
            self.step_once()
        return self.pop_completions()


def _merge_one(parts: Sequence[Tuple[np.ndarray, np.ndarray]], k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """One rid's merge over its live parts ((global ids, scores) pairs,
    shard order): ``merge_topk`` on the host, as the JAX runtime merges
    each rid."""
    ids, scores = merge_topk(
        torch.from_numpy(np.stack([p[0] for p in parts]).astype(np.int64)
                         )[None],
        torch.from_numpy(np.stack([p[1] for p in parts]))[None], k)
    return ids[0].numpy(), scores[0].numpy()

