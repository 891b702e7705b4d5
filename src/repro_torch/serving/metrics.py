"""Serving SLA metrics: the accounting surface of both serve paths
(plain numpy on host timestamps; nothing touches the device). The
continuous runtime records one ``RequestRecord`` per resolved request
(arrival, admission and completion times plus the engine's per-lane
counters); the oneshot launcher feeds per-batch latencies through
``latency_summary``.

Occupancy is step-weighted: each tick adds ``busy_lanes * steps``
live-lane-steps out of ``n_lanes * steps`` possible, the fraction of
lane-steps that carried a live query. ``bind_registry`` adds an
``obs.Registry`` view with the JAX package's metric names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def percentile(xs, q: float) -> float:
    """float(np.percentile) with an empty-input guard (nan, not a crash)."""
    if len(xs) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), q))


def latency_summary(lat_ms) -> Dict[str, float]:
    """p50/p95/p99 over a latency sample (ms)."""
    return {"p50_ms": percentile(lat_ms, 50),
            "p95_ms": percentile(lat_ms, 95),
            "p99_ms": percentile(lat_ms, 99)}


@dataclasses.dataclass
class RequestRecord:
    rid: int
    t_arrive: float
    t_admit: float
    t_done: float
    n_eval: int = 0
    n_grad: int = 0
    n_iters: int = 0
    timed_out: bool = False
    shed: bool = False      # load-shed at admission (queue full / draining)
    failed: bool = False    # every fault domain that held it failed
    partial: bool = False   # merged over surviving shards only
    sla: str = ""           # resolved SLA tier name ("" = untiered)
    degraded: bool = False  # admitted below its resolved tier (pressure)

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_arrive) * 1e3

    @property
    def queue_ms(self) -> float:
        return (self.t_admit - self.t_arrive) * 1e3


class ServingMetrics:
    """Accumulates per-request records + per-tick lane occupancy samples."""

    def __init__(self, n_lanes: int = 0):
        self.n_lanes = n_lanes
        self.records: List[RequestRecord] = []
        self._busy_steps = 0
        self._lane_steps = 0
        self._queue_depth_last = 0
        self._queue_depth_max = 0
        self._reg_live = None   # (requests, latency, queue_ms, evals,
        #                          grads, iters) when bound to a Registry
        self._reg_sla = None    # (latency{sla}, evals{sla}, degraded{sla},
        #                          requests{sla,status}) when bound

    def bind_registry(self, registry):
        """Adapter into an ``obs.Registry`` (docs/DESIGN.md §13): completed
        requests / latency / engine counters update live at ``observe``
        time; queue depth and occupancy are copied out at exposition via
        a collect callback. The snapshot APIs (``summary``/``report``)
        keep working unchanged — the registry is an additional view."""
        self._reg_live = (
            registry.counter("repro_serving_requests_total",
                             "completed requests by final status",
                             labelnames=("status",)),
            registry.histogram("repro_serving_latency_ms",
                               "end-to-end latency of answered "
                               "(ok/partial) requests, ms"),
            registry.histogram("repro_serving_queue_ms",
                               "time-in-queue of answered requests, ms"),
            registry.counter("repro_engine_evals_total",
                             "measure forward evaluations over "
                             "completed requests"),
            registry.counter("repro_engine_grads_total",
                             "gradient evaluations over completed requests"),
            registry.counter("repro_engine_iters_total",
                             "expansion iterations over completed requests"),
        )
        # per-SLA-tier families (docs/DESIGN.md §14): labeled by resolved
        # tier name; untiered requests ("" sla) stay out of these — the
        # unlabeled families above remain the all-traffic view
        self._reg_sla = (
            registry.histogram("repro_serving_sla_latency_ms",
                               "end-to-end latency of answered requests "
                               "by SLA tier, ms", labelnames=("sla",)),
            registry.counter("repro_serving_sla_evals_total",
                             "measure evaluations by SLA tier",
                             labelnames=("sla",)),
            registry.counter("repro_serving_sla_degraded_total",
                             "requests admitted below their resolved tier",
                             labelnames=("sla",)),
            registry.counter("repro_serving_sla_requests_total",
                             "completed requests by SLA tier and final "
                             "status", labelnames=("sla", "status")),
        )
        g_depth = registry.gauge("repro_serving_queue_depth",
                                 "admission queue depth, last round")
        g_depth_max = registry.gauge("repro_serving_queue_depth_max",
                                     "admission queue depth high-water mark")
        g_occ = registry.gauge("repro_serving_occupancy",
                               "fraction of lane-steps carrying a live "
                               "query")

        def _collect():
            g_depth.set(self._queue_depth_last)
            g_depth_max.set(self._queue_depth_max)
            g_occ.set(self.occupancy)

        registry.register_collect(_collect)
        return registry

    def observe(self, rec: RequestRecord) -> None:
        self.records.append(rec)
        status = ("timeout" if rec.timed_out else
                  "shed" if rec.shed else
                  "failed" if rec.failed else
                  "partial" if rec.partial else "ok")
        if self._reg_live is not None:
            requests, latency, queue_ms, evals, grads, iters = self._reg_live
            requests.labels(status=status).inc()
            if status in ("ok", "partial"):
                latency.observe(rec.latency_ms)
                queue_ms.observe(rec.queue_ms)
            evals.inc(rec.n_eval)
            grads.inc(rec.n_grad)
            iters.inc(rec.n_iters)
        if self._reg_sla is not None and rec.sla:
            s_lat, s_evals, s_degraded, s_requests = self._reg_sla
            s_requests.labels(sla=rec.sla, status=status).inc()
            if status in ("ok", "partial"):
                s_lat.labels(sla=rec.sla).observe(rec.latency_ms)
            s_evals.labels(sla=rec.sla).inc(rec.n_eval)
            if rec.degraded:
                s_degraded.labels(sla=rec.sla).inc()

    def observe_queue_depth(self, depth: int) -> None:
        """Admission-queue depth gauge, sampled once per serving round."""
        self._queue_depth_last = int(depth)
        self._queue_depth_max = max(self._queue_depth_max, int(depth))

    def observe_occupancy(self, busy: int, n_lanes: int, steps: int = 1
                          ) -> None:
        self._busy_steps += busy * steps
        self._lane_steps += n_lanes * steps

    def sync_occupancy(self, busy_steps: int, lane_steps: int) -> None:
        """Overwrite the occupancy totals from an external aggregation —
        the sharded runtime mirrors its sub-runtimes' samples here."""
        self._busy_steps = busy_steps
        self._lane_steps = lane_steps

    @property
    def occupancy(self) -> float:
        return self._busy_steps / self._lane_steps if self._lane_steps else 0.0

    def summary(self) -> Dict[str, float]:
        done = [r for r in self.records
                if not (r.timed_out or r.shed or r.failed)]
        lat = [r.latency_ms for r in done]
        queue = [r.queue_ms for r in done]
        iters = np.asarray([r.n_iters for r in done], np.float64)
        evals = np.asarray([r.n_eval for r in done], np.float64)
        out = {"n_completed": float(len(done)),
               "n_timed_out": float(sum(r.timed_out for r in self.records)),
               "n_shed": float(sum(r.shed for r in self.records)),
               "n_failed": float(sum(r.failed for r in self.records)),
               "n_partial": float(sum(r.partial for r in done)),
               "queue_depth_last": float(self._queue_depth_last),
               "queue_depth_max": float(self._queue_depth_max),
               "occupancy": self.occupancy,
               "queue_p50_ms": percentile(queue, 50),
               "queue_p95_ms": percentile(queue, 95),
               "evals_per_query": float(evals.mean()) if done else float("nan"),
               "iters_mean": float(iters.mean()) if done else float("nan"),
               "iters_max": float(iters.max()) if done else float("nan"),
               "iters_std": float(iters.std()) if done else float("nan")}
        out.update(latency_summary(lat))
        if done:
            t0 = min(r.t_arrive for r in done)
            t1 = max(r.t_done for r in done)
            out["qps"] = len(done) / (t1 - t0) if t1 > t0 else float("nan")
        else:
            out["qps"] = float("nan")
        return out

    def sla_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-SLA-tier breakdown (snapshot API): tier name
        -> {n, n_degraded, n_timed_out, n_shed, p50/p95/p99_ms,
        evals_per_query, iters_mean}. Only tiered requests appear; an
        empty dict means the stream ran without an SLA policy."""
        tiers: Dict[str, List[RequestRecord]] = {}
        for r in self.records:
            if r.sla:
                tiers.setdefault(r.sla, []).append(r)
        out: Dict[str, Dict[str, float]] = {}
        for name, recs in tiers.items():
            done = [r for r in recs
                    if not (r.timed_out or r.shed or r.failed)]
            lat = [r.latency_ms for r in done]
            evals = np.asarray([r.n_eval for r in done], np.float64)
            iters = np.asarray([r.n_iters for r in done], np.float64)
            d = {"n": float(len(recs)),
                 "n_completed": float(len(done)),
                 "n_degraded": float(sum(r.degraded for r in recs)),
                 "n_timed_out": float(sum(r.timed_out for r in recs)),
                 "n_shed": float(sum(r.shed for r in recs)),
                 "evals_per_query": (float(evals.mean()) if done
                                     else float("nan")),
                 "iters_mean": (float(iters.mean()) if done
                                else float("nan"))}
            d.update(latency_summary(lat))
            out[name] = d
        return out

    def report(self, prefix: str = "[serve]") -> str:
        s = self.summary()
        if not s["n_completed"]:
            # zero completions (everything shed/failed/timed out): one
            # clean line instead of a wall of nan-formatted percentiles
            return (f"{prefix} completed=0 "
                    f"timed_out={s['n_timed_out']:.0f} "
                    f"shed={s['n_shed']:.0f} failed={s['n_failed']:.0f} "
                    f"queue_depth_max={s['queue_depth_max']:.0f} "
                    "— no completed requests, latency/QPS unavailable")
        straggle = (s["iters_max"] / s["iters_mean"]
                    if s["iters_mean"] else float("nan"))
        lines = [
            f"{prefix} completed={s['n_completed']:.0f} "
            f"timed_out={s['n_timed_out']:.0f} "
            f"shed={s['n_shed']:.0f} failed={s['n_failed']:.0f} "
            f"partial={s['n_partial']:.0f} "
            f"steady-state {s['qps']:.0f} QPS "
            f"lane-occupancy={s['occupancy']:.2f}",
            f"{prefix} latency p50={s['p50_ms']:.1f}ms "
            f"p95={s['p95_ms']:.1f}ms p99={s['p99_ms']:.1f}ms "
            f"time-in-queue p50={s['queue_p50_ms']:.1f}ms "
            f"p95={s['queue_p95_ms']:.1f}ms",
            f"{prefix} evals/query={s['evals_per_query']:.0f} "
            f"iters mean={s['iters_mean']:.0f} max={s['iters_max']:.0f} "
            f"(straggler ratio {straggle:.1f}x)",
        ]
        for name, t in self.sla_summary().items():
            lines.append(
                f"{prefix} sla={name} n={t['n']:.0f} "
                f"degraded={t['n_degraded']:.0f} "
                f"timed_out={t['n_timed_out']:.0f} "
                f"p50={t['p50_ms']:.1f}ms p95={t['p95_ms']:.1f}ms "
                f"p99={t['p99_ms']:.1f}ms "
                f"evals/query={t['evals_per_query']:.0f}")
        return "\n".join(lines)
