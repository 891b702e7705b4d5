"""Named phase boundaries on one clock: the port's one helper for timing
the stages of a captured program and the phases of a serving round.

A :class:`Marks` records a boundary each time its owner enters a phase
(``begin(name)`` for the first of a run, ``enter(name)`` after) and one at
the end (``stop()``); ``read()`` gives the last run's phases in order, as
``[(name, seconds)]``, each from its boundary to the next. Two clocks:

- a CUDA device: each boundary is one timing event recorded on the current
  stream. The events are made with ``external=True``: recorded inside a
  CUDA-graph capture, the record becomes a node of the graph, so every
  replay records it again. ``read()`` is valid once the stream has passed
  the last one (after a sync the owner makes anyway).
- the host (no device, or a CPU one): stamps of ``clock``
  (``time.perf_counter`` unless the owner passes its own). With a tracer
  that is on, each phase is also a site-scoped span of that tracer
  (``site``) and, while a profiler runs, runs inside a
  ``torch.profiler.record_function`` range ``repro/<name>``, so that under
  ``torch.profiler`` every idle gap of the device trace falls inside a
  named phase, on the profiler's own clock.

The owner guards all of it on one flag (its tracer's ``enabled``, or
whether the program is the timed one): with the tracer off, no event is
made, no stamp taken and no range entered.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.obs.trace import NULL_TRACER

PREFIX = "repro/"


class Marks:
    """Phase boundaries of one program routine or one round (module
    docstring). ``attrs`` go on every span it emits."""

    def __init__(self, device=None, tracer=NULL_TRACER, site: str = "",
                 clock: Callable[[], float] = time.perf_counter, **attrs):
        dev = torch.device(device) if device is not None else None
        self.device = dev if dev is not None and dev.type == "cuda" else None
        self.tracer = tracer
        self.site = site
        self.clock = clock
        self.attrs = attrs
        self._attrs = attrs
        self.names: List[Optional[str]] = []   # each boundary's phase
        self._points: list = []                # its event or stamp
        self._n = 0                            # boundaries this run
        self._range = None                     # the open profiler range

    def point(self):
        """A point on this clock now, outside the phases: an event
        recorded on the current stream, or a stamp."""
        if self.device is None:
            return self.clock()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def between(a, b) -> float:
        """Seconds from point ``a`` to point ``b`` (both of one clock)."""
        if hasattr(a, "elapsed_time"):
            return a.elapsed_time(b) * 1e-3
        return b - a

    @property
    def first(self):
        """The last run's first boundary (its start)."""
        return self._points[0]

    def begin(self, name: str, **attrs):
        """Start a run in phase ``name``, its spans carrying ``attrs`` too;
        returns the boundary's point."""
        self._n = 0
        self._attrs = {**self.attrs, **attrs} if attrs else self.attrs
        return self.enter(name)

    def enter(self, name: Optional[str]):
        """Leave the current phase and enter ``name`` (None: the end);
        returns the boundary's point."""
        i = self._n
        if i == len(self._points):
            self._points.append(
                None if self.device is None else
                torch.cuda.Event(enable_timing=True, external=True))
            self.names.append(name)
        else:
            self.names[i] = name
        self._n = i + 1
        if self.device is not None:
            self._points[i].record()
            return self._points[i]
        t = self.clock()
        self._points[i] = t
        if self.tracer.enabled:
            self._span(i, t, name)
        return t

    def stop(self):
        """End the run; returns the last boundary's point."""
        return self.enter(None)

    def _span(self, i: int, t: float, name: Optional[str]) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if i:
            self.tracer.emit(self.names[i - 1], self._points[i - 1], t,
                             site=self.site, **self._attrs)
        if name is not None and torch._C._autograd._profiler_enabled():
            # a range no profiler records shows nowhere and costs ~10 us
            self._range = torch.profiler.record_function(PREFIX + name)
            self._range.__enter__()

    def read(self) -> List[Tuple[str, float]]:
        """The last run's phases: [(name, seconds)], in order."""
        pts = self._points
        return [(self.names[i], self.between(pts[i], pts[i + 1]))
                for i in range(self._n - 1)]
