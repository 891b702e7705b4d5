"""Deterministic fault-injection harness of the port (the JAX package's
``serving/faults.py``; docs/DESIGN.md §12).

A chaos run is only useful if it is *reproducible*: the same plan must
fire the same faults at the same points of the same workload, every run,
on every machine. ``FaultPlan`` is therefore a pure schedule — a list of
``FaultEvent``s addressed to named **sites** (hook points in the serving
stack), each firing on a window of that site's invocation counter,
optionally thinned by a seeded Bernoulli rate. No wall clock, no global
RNG: site counters + ``np.random.SeedSequence([seed, crc(site)])`` streams
make every firing a deterministic function of (plan, workload), and the
same plan fires on the same invocations here as in the JAX package.

Sites wired in the port:

- ``shard:<s>/tick`` (``tick`` for ``serve --chaos``) —
  ``ContinuousRuntime._tick`` consults its ``fault_hook`` once per busy
  tick, before the tick's replay. ``shard_crash`` raises
  ``InjectedFault`` (the tick dies before it runs, so the state is left
  as it was), ``shard_stall`` reports an infinite tick duration (trips
  the sharded runtime's tick deadline without sleeping), ``slow_tick``
  adds ``seconds`` of reported duration (feeds the straggler monitor).
- ``pager`` / ``pager/whole`` — ``pager_hook``, installed with
  ``PagedCorpusStore.set_read_hook`` (``serve --chaos`` on a paged
  store): ``page_io_error`` raises ``OSError`` before a page read
  (``pager``) or the whole-payload fallback read (``pager/whole``).
- ``mutate/<stage>`` — ``kill_hook``, the ``graph.mutate.DurableIndex``
  kill hook: ``kill`` raises ``InjectedKill`` at a durability stage
  (``pre-journal``, ``post-journal``, ``pre-save``, ``post-save``).

Plans round-trip through JSON (``save``/``load``) in the JAX package's
layout, so a chaos schedule is an artifact either package replays.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("page_io_error", "shard_crash", "shard_stall", "slow_tick",
               "kill")
TICK_KINDS = ("shard_crash", "shard_stall", "slow_tick")

MUTATION_STAGES = ("pre-journal", "post-journal", "pre-save", "post-save")


class InjectedFault(RuntimeError):
    """A fault fired by a ``FaultPlan`` (never raised by real code paths —
    catching it specifically lets tests distinguish injected failures from
    genuine bugs)."""

    def __init__(self, kind: str, site: str, index: int):
        super().__init__(f"injected {kind} at {site}[{index}]")
        self.kind = kind
        self.site = site
        self.index = index


class InjectedKill(InjectedFault):
    """An injected mid-mutation process death (``kill`` events): the
    mutation must be abandoned and the index recovered from disk."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fires when the target site's invocation index
    lands in ``[start, start + count)`` — and, when ``rate < 1``, only on
    the seeded Bernoulli draw for that invocation. ``site='*'`` matches
    every site that asks for this kind; ``seconds`` is the reported extra
    duration for ``slow_tick`` events."""
    kind: str
    site: str = "*"
    start: int = 0
    count: int = 1
    rate: float = 1.0
    seconds: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")
        if self.count < 0 or self.start < 0:
            raise ValueError("start/count must be >= 0")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


class ArmedSite:
    """A site's view of the plan: the matching events plus this site's
    private invocation counter and seeded RNG stream. ``next()`` advances
    the counter and returns the event that fires at this invocation (or
    None). One uniform draw is consumed per invocation regardless of
    whether any event matches, so rate-thinned plans stay deterministic
    under plan edits that add or remove unrelated events."""

    def __init__(self, site: str, events: Sequence[FaultEvent], seed: int):
        self.site = site
        self.events = list(events)
        self._idx = 0
        self._rng = np.random.default_rng(
            np.random.SeedSequence([seed, zlib.crc32(site.encode())]))

    @property
    def invocations(self) -> int:
        return self._idx

    def next(self) -> Optional[FaultEvent]:
        i = self._idx
        self._idx += 1
        u = float(self._rng.random())
        for ev in self.events:
            if ev.start <= i < ev.start + ev.count and u < ev.rate:
                return ev
        return None


class FaultPlan:
    """A seeded, serializable schedule of faults (see module docstring)."""

    def __init__(self, events: Sequence[FaultEvent] = (), seed: int = 0):
        self.events = [ev if isinstance(ev, FaultEvent) else FaultEvent(**ev)
                       for ev in events]
        self.seed = int(seed)
        self._sites: Dict[Tuple[str, Tuple[str, ...]], ArmedSite] = {}

    # -- site arming --------------------------------------------------------

    def arm(self, site: str, kinds: Sequence[str]) -> ArmedSite:
        """The armed view of ``site`` for the given fault kinds. Arming is
        idempotent — hooks installed twice share one counter."""
        key = (site, tuple(sorted(kinds)))
        if key not in self._sites:
            matched = [ev for ev in self.events
                       if ev.kind in kinds and ev.site in ("*", site)]
            self._sites[key] = ArmedSite(site, matched, self.seed)
        return self._sites[key]

    def tick_hook(self, site: str) -> Callable[[], float]:
        """The ``ContinuousRuntime.fault_hook`` for one shard's tick site:
        returns the reported extra tick seconds (0 normally, ``seconds``
        for slow_tick, +inf for shard_stall) or raises ``InjectedFault``
        for shard_crash."""
        armed = self.arm(site, TICK_KINDS)

        def hook() -> float:
            ev = armed.next()
            if ev is None:
                return 0.0
            if ev.kind == "shard_crash":
                raise InjectedFault(ev.kind, site, armed.invocations - 1)
            if ev.kind == "shard_stall":
                return float("inf")
            return float(ev.seconds)

        return hook

    def pager_hook(self, site: str = "pager"
                   ) -> Callable[[int, int], None]:
        """The ``PagedCorpusStore`` read hook: page reads consume ``site``,
        the whole-payload fallback read consumes ``site + '/whole'`` (so a
        plan can break page I/O while leaving the bulk fallback readable —
        or break both, exercising CorpusUnavailableError)."""
        pages = self.arm(site, ("page_io_error",))
        whole = self.arm(site + "/whole", ("page_io_error",))

        def hook(pid: int, attempt: int) -> None:
            armed = whole if pid < 0 else pages
            ev = armed.next()
            if ev is not None:
                raise OSError(
                    f"injected page I/O error at {armed.site}"
                    f"[{armed.invocations - 1}] (pid={pid}, "
                    f"attempt={attempt})")

        return hook

    def kill_hook(self, prefix: str = "mutate") -> Callable[[str], None]:
        """The ``DurableIndex`` kill hook: each durability stage counts its
        own invocations at site ``<prefix>/<stage>``, so a plan can kill
        exactly op #i at exactly one stage."""
        def hook(stage: str) -> None:
            armed = self.arm(f"{prefix}/{stage}", ("kill",))
            ev = armed.next()
            if ev is not None:
                raise InjectedKill(ev.kind, armed.site,
                                   armed.invocations - 1)

        return hook

    # -- (de)serialization --------------------------------------------------

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "events": [dataclasses.asdict(ev) for ev in self.events]}

    @classmethod
    def from_dict(cls, raw: dict) -> "FaultPlan":
        return cls(events=[FaultEvent(**ev) for ev in raw.get("events", [])],
                   seed=int(raw.get("seed", 0)))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
        return path

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FaultPlan(seed={self.seed}, events={self.events!r})"
