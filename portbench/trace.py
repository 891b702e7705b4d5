"""Device tracing of a short steady stretch with ``torch.profiler``, and its
reduction: the device's busy time, the kernels' time by name, and the idle
gaps named by what the host was doing meanwhile."""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "portbench/traced"


@contextlib.contextmanager
def traced(device, out: dict):
    """Profile the body; on exit ``out`` holds the reduced trace
    (``reduce``). The body runs inside a ``portbench/traced`` annotation
    whose host span is the traced window; it must end with the device
    synchronised."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    out.update(reduce(events))


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events: list) -> dict:
    """From Chrome-trace events: ``window_s`` (the traced window),
    ``busy_s`` (the union of device activity inside it), ``kernel_s``
    ({name: device seconds}), ``device_ops`` and ``idle_gaps`` (the ten
    largest, [name, seconds])."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    kernel_s = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(s, w0), min(s + d, w1)
            if b > a:
                dev.append((a, b))
                kernel_s[e["name"]] += (b - a) * 1e-6
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((s, s + d, e["name"]))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    # each gap is named by the innermost host op running at its middle
    # (one sweep over the host ops, sorted by start)
    by_host = defaultdict(float)
    host.sort()
    active, i = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        name = (min(active, key=lambda h: h[1] - h[0])[2] if active
                else "host: no traced op")
        by_host[name] += (b - a) * 1e-6
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernel_s": dict(kernel_s),
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}


def matching_seconds(kernel_s: dict, patterns) -> float:
    """Device seconds of the kernels whose names hold one of
    ``patterns``."""
    return sum(s for name, s in kernel_s.items()
               if any(p in name for p in patterns))
