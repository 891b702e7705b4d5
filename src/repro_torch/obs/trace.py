"""Per-request tracing over monotonic host clocks (the JAX package's
``obs/trace.py``).

A :class:`Tracer` collects :class:`Span` records into a bounded ring
buffer. Spans form trees: each request gets a root ``request`` span
(created at submit, finished at completion) and the serving runtime
emits phase spans (``queue``, ``admit``, ``tick``, ``harvest``,
``merge``) parented to it. Subsystems without a request identity (the
pager, the mutation journal) emit site-scoped spans (``site="pager"`` /
``site="mutate"``) that overlap the request windows temporally.

Two properties the rest of the stack relies on:

- the disabled path is one attribute lookup: every instrumented call
  site guards on ``tracer.enabled`` and the default is the singleton
  :data:`NULL_TRACER`;
- sampling is a pure function of the request id (``rid % sample == 0``)
  so independent emitters (per-shard sub-runtimes, the sharded merge
  layer) agree on which requests are traced without coordination.

The phase spans tile each scheduler round with shared timestamps, so
the union of a request's leaf intervals covers its wall-clock up to the
inter-round Python gaps — :func:`attribution` computes that union and
the per-phase breakdown; the acceptance bar is >=95% coverage even on a
degraded (shard-crash + pager-fault) run.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence


@dataclasses.dataclass
class Span:
    """One timed interval. ``t0``/``t1`` are monotonic-clock seconds
    (comparable only within a process); ``open=True`` marks a span that
    was force-closed by :meth:`Tracer.drain` before its natural end."""
    name: str
    t0: float
    t1: float
    span_id: int
    parent_id: Optional[int] = None
    rid: Optional[int] = None
    site: str = ""
    attrs: dict = dataclasses.field(default_factory=dict)
    open: bool = False

    @property
    def dur_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    def to_dict(self) -> dict:
        d = {"name": self.name, "t0": self.t0, "t1": self.t1,
             "dur_ms": self.dur_ms, "span_id": self.span_id,
             "parent_id": self.parent_id, "rid": self.rid,
             "site": self.site}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.open:
            d["open"] = True
        return d


class NullTracer:
    """Disabled tracer: every emitter guards on ``.enabled`` so the hot
    path pays exactly one attribute lookup. The methods exist so code
    that doesn't guard (cold paths) still works."""
    enabled = False

    def sampled(self, rid) -> bool:
        return False

    def root_for(self, rid, t0=None) -> int:
        return -1

    def begin(self, name, **kw) -> int:
        return -1

    def end(self, span_id, **kw) -> None:
        return None

    def emit(self, name, t0, t1, **kw) -> int:
        return -1

    def finish_request(self, rid, **kw) -> None:
        return None

    def drain(self) -> List[Span]:
        return []

    def spans(self, rid=-1, site=None) -> List[Span]:
        return []


NULL_TRACER = NullTracer()


class Tracer:
    """Span collector with a bounded ring buffer.

    ``sample=N`` traces every Nth request id (``rid % N == 0``);
    ``capacity`` bounds retained spans (oldest evicted first). The
    clock must be monotonic; ``time.perf_counter`` by default.
    """
    enabled = True

    def __init__(self, capacity: int = 4096, sample: int = 1,
                 clock: Callable[[], float] = time.perf_counter):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if sample < 1:
            raise ValueError("sample must be >= 1")
        self.capacity = int(capacity)
        self.sample = int(sample)
        self.clock = clock
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._open: Dict[int, Span] = {}
        self._roots: Dict[int, int] = {}
        self._ids = itertools.count(1)
        self.n_emitted = 0  # total spans closed into the ring, ever

    # -- span lifecycle ------------------------------------------------
    def begin(self, name: str, t0: Optional[float] = None,
              rid: Optional[int] = None, site: str = "",
              parent: Optional[int] = None, **attrs) -> int:
        sid = next(self._ids)
        self._open[sid] = Span(name, self.clock() if t0 is None else t0,
                               0.0, sid, parent, rid, site, attrs, open=True)
        return sid

    def end(self, span_id: int, t1: Optional[float] = None,
            **attrs) -> Optional[Span]:
        sp = self._open.pop(span_id, None)
        if sp is None:
            return None
        sp.t1 = self.clock() if t1 is None else t1
        sp.open = False
        if attrs:
            sp.attrs.update(attrs)
        self._ring.append(sp)
        self.n_emitted += 1
        return sp

    def emit(self, name: str, t0: float, t1: float,
             rid: Optional[int] = None, site: str = "",
             parent: Optional[int] = None, **attrs) -> int:
        """Record an already-measured interval (no open state)."""
        sid = next(self._ids)
        self._ring.append(Span(name, t0, t1, sid, parent, rid, site, attrs))
        self.n_emitted += 1
        return sid

    # -- request roots -------------------------------------------------
    def sampled(self, rid) -> bool:
        return rid is not None and rid >= 0 and rid % self.sample == 0

    def root_for(self, rid: int, t0: Optional[float] = None) -> int:
        """Get-or-create the root ``request`` span for ``rid``.
        Idempotent so the sharded fan-out layers agree on one root."""
        sid = self._roots.get(rid)
        if sid is None:
            sid = self.begin("request", t0=t0, rid=rid)
            self._roots[rid] = sid
        return sid

    def finish_request(self, rid: int, t1: Optional[float] = None,
                       **attrs) -> None:
        sid = self._roots.pop(rid, None)
        if sid is not None:
            self.end(sid, t1=t1, **attrs)

    # -- access / export -----------------------------------------------
    def drain(self) -> List[Span]:
        """Force-close every open span at 'now' (kept flagged
        ``open=True``) and push them into the ring. Called at runtime
        close so in-flight work is never silently lost."""
        now = self.clock()
        out = []
        for sp in self._open.values():
            sp.t1 = now
            self._ring.append(sp)
            self.n_emitted += 1
            out.append(sp)
        self._open.clear()
        self._roots.clear()
        return out

    def spans(self, rid: Optional[int] = -1,
              site: Optional[str] = None) -> List[Span]:
        """Snapshot of the ring; filter by rid (``-1`` = any) and/or
        site. ``rid=None`` selects spans with no request identity."""
        out = list(self._ring)
        if rid != -1:
            out = [s for s in out if s.rid == rid]
        if site is not None:
            out = [s for s in out if s.site == site]
        return out

    def export_jsonl(self, path: str) -> int:
        spans = list(self._ring)
        with open(path, "w") as f:
            for sp in spans:
                f.write(json.dumps(sp.to_dict(), sort_keys=True) + "\n")
        return len(spans)


# -- analysis helpers ---------------------------------------------------

def _union_ms(intervals: List[tuple]) -> float:
    """Total length of the union of [t0, t1] intervals, in ms."""
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total, cur0, cur1 = 0.0, intervals[0][0], intervals[0][1]
    for a, b in intervals[1:]:
        if a > cur1:
            total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    total += cur1 - cur0
    return total * 1e3


def attribution(spans: Iterable[Span], rid: int,
                sites: Sequence[str] = ()) -> dict:
    """Attribute a request's wall-clock across its leaf spans.

    Returns ``{"wall_ms", "attributed_ms", "coverage", "by_name"}``
    where coverage is the union of the request's non-root intervals
    (plus any ``sites`` spans, e.g. the pager's, clipped to the root
    window) divided by the root span duration. ``by_name`` sums raw
    (overlap-counted) durations per span name.
    """
    spans = list(spans)
    root = next((s for s in spans if s.rid == rid and s.name == "request"),
                None)
    if root is None:
        return {"wall_ms": 0.0, "attributed_ms": 0.0, "coverage": 0.0,
                "by_name": {}}
    leaves = [s for s in spans
              if s.span_id != root.span_id
              and (s.rid == rid or (s.site in sites and s.rid is None))]
    clipped, by_name = [], {}
    for s in leaves:
        a, b = max(s.t0, root.t0), min(s.t1, root.t1)
        if b <= a:
            continue
        clipped.append((a, b))
        by_name[s.name] = by_name.get(s.name, 0.0) + (b - a) * 1e3
    wall = root.dur_ms
    attributed = _union_ms(clipped)
    return {"wall_ms": wall, "attributed_ms": attributed,
            "coverage": (attributed / wall) if wall > 0 else 0.0,
            "by_name": by_name}


def format_trace(tracer_or_spans, rid: int, sites: Sequence[str] = (),
                 width: int = 24) -> str:
    """Flame-style text rendering of one request's span tree.

    Children are indented under their parent, ordered by start time,
    each with duration, % of the root, and a bar scaled to the root
    span. ``sites`` weaves in site-scoped spans (e.g. the pager's)
    that overlap the request window.
    """
    if hasattr(tracer_or_spans, "spans"):
        spans = tracer_or_spans.spans()
    else:
        spans = list(tracer_or_spans)
    root = next((s for s in spans if s.rid == rid and s.name == "request"),
                None)
    if root is None:
        return f"(no trace for rid={rid})"
    mine = [s for s in spans if s.span_id != root.span_id
            and (s.rid == rid
                 or (s.site in sites and s.rid is None
                     and s.t1 > root.t0 and s.t0 < root.t1))]
    children: Dict[int, List[Span]] = {}
    for s in mine:
        pid = s.parent_id if s.parent_id in {x.span_id for x in mine} \
            else root.span_id
        children.setdefault(pid, []).append(s)
    for v in children.values():
        v.sort(key=lambda s: (s.t0, s.span_id))
    wall = max(root.t1 - root.t0, 1e-12)

    def _attrs(s: Span) -> str:
        bits = [f"{k}={v}" for k, v in sorted(s.attrs.items())]
        if s.open:
            bits.append("OPEN")
        return (" [" + " ".join(bits) + "]") if bits else ""

    lines = [f"request rid={rid} {root.dur_ms:.3f}ms"
             f"{_attrs(root)}"]

    def _walk(pid: int, depth: int) -> None:
        for s in children.get(pid, ()):  # noqa: B023
            frac = max(0.0, min(1.0, (s.t1 - s.t0) / wall))
            bar = "#" * max(1, round(frac * width)) if frac > 0 else ""
            label = s.name + (f" @{s.site}" if s.site else "")
            lines.append(f"{'  ' * depth}- {label:<22s} "
                         f"{s.dur_ms:9.3f}ms {100 * frac:5.1f}% {bar}"
                         f"{_attrs(s)}")
            _walk(s.span_id, depth + 1)

    _walk(root.span_id, 1)
    att = attribution(spans, rid, sites=sites)
    lines.append(f"  attributed {att['attributed_ms']:.3f}ms / "
                 f"{att['wall_ms']:.3f}ms "
                 f"(coverage {100 * att['coverage']:.1f}%)")
    return "\n".join(lines)
