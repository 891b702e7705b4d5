"""Straggler detection & mitigation policy (the JAX package's
``ft/straggler.py``; host code, copied so the port stands alone).

On a real multi-pod job the fleet controller feeds per-host step times; here
the monitor consumes whatever step durations the trainer reports (and the
tests inject synthetic distributions). Policy (standard practice, cf.
backup-workers in large-scale SGD):

  - EMA of median step time; a host is a *straggler* when its step time
    exceeds ``threshold``x the median for ``patience`` consecutive steps;
  - mitigation ladder: (1) flag for the data pipeline to rebalance shards
    away from the slow host, (2) recommend hot-spare swap (the launcher
    replaces the host and restores from the latest checkpoint — restart
    path exercised in tests), (3) if >5% of hosts are slow, recommend a
    global re-shard (elastic down-size) instead of whack-a-mole.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerAction:
    kind: str            # none | rebalance | swap | reshard
    hosts: List[int]
    reason: str = ""


class StragglerMonitor:
    def __init__(self, n_hosts: int, threshold: float = 1.5,
                 patience: int = 3, window: int = 32,
                 reshard_frac: float = 0.05):
        self.n_hosts = n_hosts
        self.threshold = threshold
        self.patience = patience
        self.reshard_frac = reshard_frac
        self.times: Dict[int, deque] = defaultdict(lambda: deque(maxlen=window))
        self.slow_streak: Dict[int, int] = defaultdict(int)
        self.flagged: set[int] = set()

    def record_step(self, host_times: Dict[int, float]) -> StragglerAction:
        med = float(np.median(list(host_times.values())))
        newly_slow = []
        for h, t in host_times.items():
            self.times[h].append(t)
            if t > self.threshold * med:
                self.slow_streak[h] += 1
            else:
                self.slow_streak[h] = 0
                self.flagged.discard(h)
            if self.slow_streak[h] >= self.patience and h not in self.flagged:
                self.flagged.add(h)
                newly_slow.append(h)

        if len(self.flagged) > max(1.0, self.reshard_frac * self.n_hosts):
            return StragglerAction("reshard", sorted(self.flagged),
                                   f"{len(self.flagged)} hosts slow — global re-shard")
        # escalate flagged hosts that stayed slow past 2x patience: swap
        persistent = [h for h in sorted(self.flagged)
                      if self.slow_streak[h] >= 2 * self.patience]
        if persistent:
            return StragglerAction("swap", persistent, "persistent straggler")
        if newly_slow:
            return StragglerAction("rebalance", newly_slow,
                                   f">{self.threshold}x median for {self.patience} steps")
        return StragglerAction("none", [])

    def healthy_hosts(self) -> List[int]:
        return [h for h in range(self.n_hosts) if h not in self.flagged]


class CircuitBreaker:
    """Classic three-state breaker guarding one fault domain (a shard, a
    host, a downstream store).

    CLOSED — normal operation; ``k_failures`` *consecutive* failures trip
    it OPEN. OPEN — the domain is not used at all for ``cooldown`` calls
    to ``tick()`` (one per serving round), then transitions to HALF_OPEN.
    HALF_OPEN — the domain takes probe traffic: one real success closes
    the breaker, any failure re-opens it immediately (no K-strike grace).
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    def __init__(self, k_failures: int = 3, cooldown: int = 8):
        if k_failures < 1 or cooldown < 1:
            raise ValueError("k_failures and cooldown must be >= 1")
        self.k_failures = k_failures
        self.cooldown = cooldown
        self.state = self.CLOSED
        self.failures = 0          # consecutive failures while CLOSED
        self.n_opened = 0          # lifetime count of CLOSED/HALF_OPEN -> OPEN
        self._cooldown_left = 0

    def record_failure(self) -> bool:
        """Returns True iff this failure tripped the breaker OPEN."""
        self.failures += 1
        if self.state == self.OPEN:
            return False
        if self.state == self.HALF_OPEN or self.failures >= self.k_failures:
            self.state = self.OPEN
            self._cooldown_left = self.cooldown
            self.n_opened += 1
            return True
        return False

    def record_success(self) -> None:
        self.failures = 0
        if self.state == self.HALF_OPEN:
            self.state = self.CLOSED

    def tick(self) -> None:
        """Advance one serving round; OPEN breakers count down to HALF_OPEN."""
        if self.state == self.OPEN:
            self._cooldown_left -= 1
            if self._cooldown_left <= 0:
                self.state = self.HALF_OPEN

    @property
    def serving(self) -> bool:
        """Whether the guarded domain should receive work this round."""
        return self.state != self.OPEN
