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
again); on the CPU the same routines run eagerly. Per-request results
equal the oneshot ``ExpansionEngine.search`` of the same query bit for bit
(ids, scores, counters): the stages are lane-row independent.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md):
``fault_hook``, ``tracer`` / ``trace_site`` / ``trace_owner``,
``shared_fns``, ``install_index`` and ``bind_registry``; the fault-domain
helpers (``complete_failed``, ``fail_all``) and
``ShardedContinuousRuntime`` are next (the one-shot sharded search they
build on is ``core/sharded.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.corpus import CorpusStore, as_corpus_store
from repro_torch.core.engine import ExpansionEngine
from repro_torch.core.program import StateProgram
from repro_torch.serving.metrics import RequestRecord, ServingMetrics
from repro_torch.serving.sla import SLAPolicy, resolve_tier


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"ContinuousRuntime: {what} is not ported yet (the JAX package's "
        f"serving/runtime.py has it; see ROADMAP.md)")


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
    epoch: int = 0         # index version (always 0: no install_index)
    # "ok" = full answer; "timeout" = deadline drop; "shed" = load-shed at
    # admission. Anything but "ok" carries ids -1 and scores -inf.
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


class ContinuousRuntime:
    """Lane-recycling scheduler over one ``ExpansionEngine``. Shapes are
    fixed at construction (n_lanes x corpus), so the reset and the tick
    are captured once and replayed for the life of the runtime."""

    def __init__(self, engine: ExpansionEngine, params, corpus, neighbors,
                 n_lanes: int, query_dim: int, entry: int = 0,
                 steps_per_tick: int = 4,
                 now_fn: Callable[[], float] = time.perf_counter,
                 max_queue: Optional[int] = None,
                 fault_hook: Optional[Callable[[], float]] = None,
                 shared_fns: Optional[tuple] = None,
                 tracer=None, trace_site: str = "",
                 trace_owner: bool = True,
                 sla_policy: Optional[SLAPolicy] = None, device=None):
        if fault_hook is not None:
            raise _not_ported("fault_hook (serving/faults.py)")
        if tracer is not None or trace_site or not trace_owner:
            raise _not_ported("tracing (tracer, trace_site, trace_owner; "
                              "obs/)")
        if shared_fns is not None:
            raise _not_ported("shared_fns (ShardedContinuousRuntime)")
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        if steps_per_tick < 1:
            raise ValueError(
                f"steps_per_tick must be >= 1, got {steps_per_tick}")
        if device is None:
            device = corpus.device if isinstance(
                corpus, (torch.Tensor, CorpusStore)) else DEFAULT_DEVICE
        dev = resolve_device(device)
        self.engine = engine
        self.params = params
        self.store = as_corpus_store(corpus, engine.corpus_dtype, device=dev)
        if self.store.device != dev:
            raise ValueError(f"corpus on {self.store.device}, runtime on "
                             f"{dev}")
        self.neighbors = torch.as_tensor(neighbors, device=dev)
        self.device = dev
        self.n_lanes = n_lanes
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
        self._closing = False
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

        k = engine.cfg.k
        L = n_lanes
        bufs = {"queries": torch.zeros((L, query_dim), dtype=torch.float32,
                                       device=dev),
                "entries": torch.zeros((L,), dtype=torch.int64, device=dev),
                "mask": torch.zeros((L,), dtype=torch.bool, device=dev),
                "caps": torch.zeros((L,), dtype=torch.int32, device=dev),
                "taus": torch.zeros((L,), dtype=torch.float32, device=dev),
                "harvest": torch.zeros((L, 2 * k + 4), dtype=torch.int64,
                                       device=dev)}
        self.program = StateProgram(
            engine.idle_state(L, self.store.n, dev), bufs)
        store, nbrs = self.store, self.neighbors

        def reset(b, s):
            return engine.reset_lanes(params, store, b["queries"],
                                      b["entries"], s, b["mask"], b["caps"],
                                      b["taus"]), {}
        steps = engine.step_routine(params, store, nbrs, steps_per_tick)

        def tick(b, s):
            s, _ = steps(b, s)
            return s, {"harvest": _pack(s, k)}
        self.program.add("reset", reset)
        self.program.add("tick", tick)

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
        k = self.engine.cfg.k
        c = Completion(rid, np.full((k,), -1, np.int64),
                       np.full((k,), -np.inf, np.float32), 0, 0, 0, -1,
                       rec, status=status)
        self.metrics.observe(rec)
        self.completions.append(c)
        return c

    def _resolve_sentinel(self, rid: int, t_arrive: float, status: str,
                          sla: str = "") -> Completion:
        now = self._now()
        return self._sentinel(rid, RequestRecord(
            rid, t_arrive, now, now, shed=(status == "shed"), sla=sla),
            status)

    def shed_queue(self) -> List[Completion]:
        """Shed every queued request (graceful drain)."""
        out = []
        while self.queue:
            req = self.queue.popleft()
            out.append(self._resolve_sentinel(req.rid, req.t_arrive, "shed",
                                              sla=req.sla or ""))
        return out

    def install_index(self, corpus, neighbors, entry: Optional[int] = None):
        raise _not_ported("install_index (streaming index epochs)")

    # -- scheduler round ----------------------------------------------------

    def _admit(self, now: float) -> List[Completion]:
        dropped: List[Completion] = []
        free = [lane for lane in range(self.n_lanes)
                if self._lane_req[lane] is None]
        if not free or not self.queue:
            return dropped
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
            self._lane_req[lane] = req
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
            self.program.run("reset")
        return dropped

    def _tick(self) -> None:
        busy = self.in_flight
        if not busy:
            return
        self.program.run("tick")
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
                           int(n_iters[lane]), lane, rec)
            self.metrics.observe(rec)
            self.completions.append(c)
            self._lane_req[lane] = None
            out.append(c)
        return out

    def step_once(self) -> List[Completion]:
        """One admit -> tick -> harvest round; returns every request that
        resolved in it (harvested results and deadline drops)."""
        self.metrics.observe_queue_depth(len(self.queue))
        dropped = self._admit(self._now())
        self._tick()
        return dropped + self._harvest(self._now())

    def close(self) -> List[Completion]:
        """Graceful drain: admit nothing more (late submits are shed), shed
        the queue, finish the lanes in flight."""
        self._closing = True
        out = self.shed_queue()
        while self.in_flight:
            out += self.step_once()
        return out

    def pop_completions(self) -> List[Completion]:
        out, self.completions = self.completions, []
        return out

    # -- observability ------------------------------------------------------

    def bind_registry(self, registry):
        raise _not_ported("bind_registry (obs/)")

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
        request to completion, its completion and metrics discarded."""
        self.run_stream([Request(rid=-1, query=np.asarray(query))],
                        realtime=False)
        self.pop_completions()
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
