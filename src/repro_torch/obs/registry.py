"""Metric registry + exposition (Prometheus text and JSON); the JAX
package's ``obs/registry.py``, with the same metric names and label caps,
so both packages' expositions read the same.

No process globals: every :class:`Registry` is an independent instance
that subsystems bind into via their ``bind_registry(...)`` adapters
(``ServingMetrics``, ``ShardHealthTracker``, ``PagedCorpusStore``,
``kernels.autotune``). Adapters
keep the snapshot-dict APIs working; the registry is an *additional*
view, not a replacement.

Naming convention (enforced shape, documented in docs/DESIGN.md §13):
``repro_<subsystem>_<name>`` with snake_case, labels for bounded
dimensions only (status, shard, site). Each metric caps its label-set
cardinality (``max_series``) and raises instead of growing without
bound — unbounded labels are a memory leak in disguise.

Two write styles:
- live: call ``counter.labels(status="ok").inc()`` on the hot path;
- collected: ``registry.register_collect(fn)`` callbacks run at
  exposition time and copy values out of existing snapshot dicts
  (``set_to`` / ``set``), so hot paths stay untouched.
"""
from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

DEFAULT_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                   250.0, 500.0, 1000.0, 2500.0)


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Child:
    """One (metric, label-values) series."""

    def __init__(self, kind: str, buckets: Optional[Tuple[float, ...]]):
        self.kind = kind
        self.value = 0.0
        if kind == "histogram":
            self.buckets = buckets
            self.bucket_counts = [0] * len(buckets)
            self.sum = 0.0
            self.count = 0

    def inc(self, n: float = 1.0) -> None:
        if self.kind == "counter" and n < 0:
            raise ValueError("counter can only increase")
        self.value += n

    def set(self, v: float) -> None:
        if self.kind != "gauge":
            raise ValueError(f"set() is gauge-only, not {self.kind}")
        self.value = float(v)

    def set_to(self, v: float) -> None:
        """Snapshot adapter hook: overwrite the cumulative total of a
        counter from an external monotonic source (e.g. a stats dict)."""
        if self.kind != "counter":
            raise ValueError(f"set_to() is counter-only, not {self.kind}")
        self.value = float(v)

    def observe(self, v: float) -> None:
        if self.kind != "histogram":
            raise ValueError(f"observe() is histogram-only, not {self.kind}")
        v = float(v)
        self.sum += v
        self.count += 1
        # per-bucket (non-cumulative) storage; exposition cumulates
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.bucket_counts[i] += 1
                break


class Metric:
    """A named family of series, one per label-value tuple."""

    def __init__(self, kind: str, name: str, help: str = "",
                 labelnames: Sequence[str] = (), max_series: int = 256,
                 buckets: Optional[Sequence[float]] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self.buckets = (tuple(sorted(buckets)) if buckets is not None
                        else DEFAULT_BUCKETS) if kind == "histogram" else None
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = _Child(kind, self.buckets)

    def labels(self, **kv) -> _Child:
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(kv)}, "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        child = self._children.get(key)
        if child is None:
            if len(self._children) >= self.max_series:
                raise ValueError(
                    f"{self.name}: label cardinality cap ({self.max_series} "
                    f"series) exceeded by {key!r} — unbounded label values "
                    "are not allowed")
            child = _Child(self.kind, self.buckets)
            self._children[key] = child
        return child

    # unlabelled convenience: metric.inc()/set()/observe() proxy to the
    # single () child
    def _solo(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} has labels "
                             f"{self.labelnames}; use .labels(...)")
        return self._children[()]

    def inc(self, n: float = 1.0) -> None:
        self._solo().inc(n)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def set_to(self, v: float) -> None:
        self._solo().set_to(v)

    def observe(self, v: float) -> None:
        self._solo().observe(v)

    def series(self):
        return sorted(self._children.items())


class Registry:
    """Instance-scoped metric registry with get-or-create semantics."""

    def __init__(self, max_series_per_metric: int = 256):
        self._metrics: Dict[str, Metric] = {}
        self._collectors: List[Callable[[], None]] = []
        self.max_series_per_metric = max_series_per_metric

    def _get_or_create(self, kind: str, name: str, help: str,
                       labelnames: Sequence[str],
                       buckets: Optional[Sequence[float]] = None) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered as {kind}"
                    f"{tuple(labelnames)} but exists as {m.kind}"
                    f"{m.labelnames}")
            return m
        m = Metric(kind, name, help, labelnames,
                   max_series=self.max_series_per_metric, buckets=buckets)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Metric:
        return self._get_or_create("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Metric:
        return self._get_or_create("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Metric:
        return self._get_or_create("histogram", name, help, labelnames,
                                   buckets=buckets)

    def register_collect(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` before every exposition; it copies current values
        out of subsystem snapshots into registry series."""
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            fn()

    # -- exposition ----------------------------------------------------
    def render_text(self) -> str:
        """Prometheus text exposition format."""
        self.collect()
        out = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                out.append(f"# HELP {name} {_escape(m.help)}")
            out.append(f"# TYPE {name} {m.kind}")
            for key, child in m.series():
                lbl = ",".join(f'{ln}="{_escape(v)}"'
                               for ln, v in zip(m.labelnames, key))
                suffix = "{" + lbl + "}" if lbl else ""
                if m.kind == "histogram":
                    cum = 0
                    for le, n in zip(child.buckets, child.bucket_counts):
                        cum += n
                        blbl = (lbl + "," if lbl else "") + \
                            f'le="{_fmt(le)}"'
                        out.append(f"{name}_bucket{{{blbl}}} {cum}")
                    blbl = (lbl + "," if lbl else "") + 'le="+Inf"'
                    out.append(f"{name}_bucket{{{blbl}}} {child.count}")
                    out.append(f"{name}_sum{suffix} {_fmt(child.sum)}")
                    out.append(f"{name}_count{suffix} {child.count}")
                else:
                    out.append(f"{name}{suffix} {_fmt(child.value)}")
        return "\n".join(out) + "\n"

    def render_json(self) -> dict:
        self.collect()
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = []
            for key, child in m.series():
                labels = dict(zip(m.labelnames, key))
                if m.kind == "histogram":
                    series.append({
                        "labels": labels, "sum": child.sum,
                        "count": child.count,
                        "buckets": {_fmt(le): n for le, n in
                                    zip(child.buckets, child.bucket_counts)}})
                else:
                    series.append({"labels": labels, "value": child.value})
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def render_json_str(self) -> str:
        return json.dumps(self.render_json(), indent=1, sort_keys=True)
