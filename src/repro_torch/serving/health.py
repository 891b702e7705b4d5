"""Shard health tracking for the sharded serving runtime (the JAX
package's ``serving/health.py``; docs/DESIGN.md §12).

Composes the two `ft/` primitives into one per-shard state machine:

- ``CircuitBreaker`` decides *whether a shard serves at all*: K consecutive
  hard failures (tick crash, pager unavailable, tick-deadline blown) trip
  it open; after a cooldown the shard takes half-open probe traffic and one
  real success re-admits it.
- ``StragglerMonitor`` watches *relative* tick times across shards; a shard
  that is merely slow is flagged (reported as ``suspect``), and a shard the
  monitor escalates to ``swap`` (persistently >threshold× median) is struck
  as a breaker failure — sustained stalling converts to unavailability
  instead of dragging every merge window forever.

Reported states (health line, benchmarks, tests):

    healthy   closed breaker, no strikes, not straggling
    suspect   closed breaker but recent strikes or straggler-flagged
    open      breaker open — shard receives no traffic, its parts are
              synthesized as failed, merges proceed partial
    half-open cooldown expired — probe traffic flows; one success closes
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.ft.straggler import CircuitBreaker, StragglerAction, StragglerMonitor

HEALTHY = "healthy"
SUSPECT = "suspect"
OPEN = "open"
HALF_OPEN = "half-open"


class ShardHealthTracker:
    def __init__(self, n_shards: int, k_failures: int = 3,
                 cooldown_rounds: int = 8, straggler_threshold: float = 3.0,
                 straggler_patience: int = 3):
        self.n_shards = n_shards
        self.breakers = [CircuitBreaker(k_failures, cooldown_rounds)
                         for _ in range(n_shards)]
        self.monitor = StragglerMonitor(n_shards, threshold=straggler_threshold,
                                        patience=straggler_patience)
        self.last_reason: Dict[int, str] = {}

    # -- per-round bookkeeping ----------------------------------------------

    def on_round(self) -> None:
        """Advance one serving round: open breakers cool toward half-open."""
        for b in self.breakers:
            b.tick()

    def record_tick_times(self, times: Dict[int, float]) -> StragglerAction:
        """Feed this round's per-shard tick durations to the straggler
        monitor; a shard escalated to ``swap`` is struck as a failure."""
        if not times:
            return StragglerAction("none", [])
        action = self.monitor.record_step(times)
        if action.kind == "swap":
            for s in action.hosts:
                self.record_failure(s, action.reason or "persistent straggler")
        return action

    def record_failure(self, shard: int, reason: str = "") -> bool:
        """Returns True iff this failure tripped the shard's breaker open."""
        self.last_reason[shard] = reason
        return self.breakers[shard].record_failure()

    def record_success(self, shard: int, probed: bool = True) -> None:
        """A clean tick. ``probed=False`` means the shard had no real work —
        an idle tick must not close a half-open breaker (re-admission
        requires evidence the shard can actually serve)."""
        b = self.breakers[shard]
        if b.state == CircuitBreaker.HALF_OPEN and not probed:
            return
        b.record_success()

    # -- queries ------------------------------------------------------------

    def serving(self, shard: int) -> bool:
        return self.breakers[shard].serving

    def state(self, shard: int) -> str:
        b = self.breakers[shard]
        if b.state == CircuitBreaker.OPEN:
            return OPEN
        if b.state == CircuitBreaker.HALF_OPEN:
            return HALF_OPEN
        if b.failures > 0 or shard in self.monitor.flagged:
            return SUSPECT
        return HEALTHY

    def states(self) -> List[str]:
        return [self.state(s) for s in range(self.n_shards)]

    @property
    def n_opened(self) -> int:
        return sum(b.n_opened for b in self.breakers)

    def bind_registry(self, registry):
        """Adapter into an ``obs.Registry``: per-shard breaker state as a
        coded gauge (0 healthy / 1 suspect / 2 half-open / 3 open) plus
        the cumulative breaker-open count — collected at exposition time,
        nothing on the serving path."""
        code = {HEALTHY: 0, SUSPECT: 1, HALF_OPEN: 2, OPEN: 3}
        g_state = registry.gauge(
            "repro_health_shard_state",
            "breaker state: 0 healthy, 1 suspect, 2 half-open, 3 open",
            labelnames=("shard",))
        c_opens = registry.counter(
            "repro_health_breaker_opens_total",
            "cumulative circuit-breaker open transitions")

        def _collect():
            for s, st in enumerate(self.states()):
                g_state.labels(shard=str(s)).set(code[st])
            c_opens.set_to(self.n_opened)

        registry.register_collect(_collect)
        return registry

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ShardHealthTracker({self.states()!r})"
