"""The program's own spans at a benchmark cell's size: the engine's timed
chunks in a bulk cell (``stats``: device seconds per stage, the idle
before each chunk's replay, host seconds per replay call) and the serving
round's phases in an online cell (``ContinuousRuntime.round_s``,
``counters``), each cell set up as ``portbench`` sets it up.

    python3 tools/stage_trace.py [--cells twitch-deepfm.bulk ...]
        [--seconds 8] [--turns 2] [--device cuda|cpu]
        [--shrink '{"n_items": 3000, "batch": 64, "pool": 512}']
        [--out chiprun_out/stage_trace.json]

Per cell, in one process, once set up and settled as the benchmark settles
(``drivers.settle``): windows of ``--seconds`` with the program's
tracing off and on in turns (off, on, on, off for two turns), torch.profiler
off, which give the tracing's cost (``step_us`` or ``round_ms`` on and off)
and the spans' readings; then one stretch under torch.profiler (CUPTI) with
the tracing on (3 batches, or 1 s of arrivals), which holds the spans
against the device trace (its busy seconds, its kernels by name), and, in
a bulk cell, one eager search whose chunks open a profiler range per stage,
so that each device operation is named by the stage that issued it. Prints
one JSON line per cell and writes them all to ``--out``."""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import data as data_lib  # noqa: E402
from portbench import drivers  # noqa: E402
from portbench import harness, manifest  # noqa: E402
from portbench import trace as trace_lib  # noqa: E402
from portbench.system import System  # noqa: E402
from portbench.traffic import generator  # noqa: E402
from repro_torch.core.engine import STAGES, SYNC_EVERY  # noqa: E402
from repro_torch.obs import NULL_TRACER, Tracer  # noqa: E402
from repro_torch.obs.phases import Marks  # noqa: E402
from repro_torch.serving import ContinuousRuntime  # noqa: E402
from repro_torch.serving.runtime import ROUND_PHASES  # noqa: E402

CELLS = ("twitch-deepfm.bulk", "twitch-deepfm.poisson",
         "twitch-mlp-int8.bulk")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _turns(n: int) -> list:
    """off, on, on, off, ... (n turns of each)."""
    return [(False, True, True, False)[i % 4] for i in range(2 * n)]


def set_up(cell_name: str, seconds: float, shrink, dev):
    man = manifest.load()
    cell = manifest.cell(man, cell_name)
    config, mix = harness.shrunk(manifest.config(man, cell["config"]),
                                 generator.load(cell["traffic"]), shrink)
    n_q = harness.query_count(mix, seconds * 4 + 2)
    inputs = data_lib.make_inputs(config, n_q, 1, dev)
    setup = harness.Setup(time.time())
    system = System(config, inputs.corpus, inputs.weights, dev, setup)
    return system, inputs, mix


# -- bulk --------------------------------------------------------------------

def bulk(system, inputs, mix, seconds: float, turns: int, dev) -> dict:
    eng = system.engine
    tr = Tracer(sample=None)
    tr.enabled = False
    eng.set_tracer(tr)
    pool, B = inputs.queries, mix["batch"]
    entries = system.entries(B)
    lane = torch.arange(B, device=dev)
    pos = [0]

    def batch():
        idx = (lane + pos[0]) % pool.shape[0]
        pos[0] = (pos[0] + B) % pool.shape[0]
        return system.search(pool[idx], entries)

    for on in (False, False, True, True):    # both programs, captured
        tr.enabled = on
        batch()
    _sync(dev)
    drivers.settle()
    out = {"kind": "bulk", "batch": B, "windows": []}
    for on in _turns(turns):
        tr.enabled = on
        st0 = dict(eng.stats)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            batch()
        _sync(dev)
        wall = time.perf_counter() - t0
        d = {k: eng.stats[k] - st0[k] for k in st0}
        out["windows"].append(_bulk_window(on, wall, d))
    # the device trace of the timed program, 3 batches as the benchmark's
    tr.enabled = True
    st0 = dict(eng.stats)
    reduced = {}
    with trace_lib.traced(dev, reduced):
        for _ in range(mix["trace_batches"]):
            batch()
        _sync(dev)
    d = {k: eng.stats[k] - st0[k] for k in st0}
    stage_s = {s: d["stage_s." + s] for s in STAGES}
    out["cupti"] = {
        "busy_s": reduced.get("busy_s"), "window_s": reduced.get("window_s"),
        "steps": d["steps"], "stage_s": stage_s,
        "stage_sum_over_busy": (sum(stage_s.values()) / reduced["busy_s"]
                                if reduced.get("busy_s") else None),
        "chunk_gap_s": d["chunk_gap_s"],
        "device_ops": reduced.get("device_ops"),
        "idle_gaps": reduced.get("idle_gaps"),
        "memcpy32_post_s": trace_lib.matching_seconds(
            reduced.get("kernel_s", {}), ("memcpy32_post",))}
    tr.enabled = False
    out["eager_by_stage"] = _eager_by_stage(system, pool[:B], entries, dev)
    eng.set_tracer(NULL_TRACER)
    return out


def _bulk_window(on: bool, wall: float, d: dict) -> dict:
    w = {"tracing": on, "window_s": wall, "steps": d["steps"],
         "step_us": 1e6 * wall / d["steps"], "runs": d["runs"],
         "load_us_per_search": 1e6 * d["load_s"] / d["searches"],
         "launch_us": 1e6 * d["launch_s"] / d["runs"],
         "sync_us_per_chunk": 1e6 * d["sync_s"] / (d["runs"] - d["searches"]),
         "copy_back_bytes_per_chunk":
             d["copy_back_bytes"] / (d["runs"] - d["searches"])}
    if on:
        steps = d["stage_calls.pop"]
        w["stage_us"] = {s: 1e6 * d["stage_s." + s] / steps for s in STAGES}
        w["stage_sum_us"] = sum(w["stage_us"].values())
        w["chunk_gap_us"] = 1e6 * d["chunk_gap_s"] / d["chunk_gaps"]
    return w


def _eager_by_stage(system, queries, entries, dev) -> dict:
    """One search run eagerly, its chunks marked on the host with profiler
    ranges ``repro/<stage>``: each device operation is named by the range
    its launch fell in. Returns {stage: [[op, seconds], ...]} (the five
    largest), and the stages' device seconds."""
    eng = system.engine
    params, store, nbrs = system.params, system.store, system.neighbors
    prog = eng.search_program(params, store, nbrs, queries, capture=False)
    marks = Marks(tracer=Tracer(sample=None), site="tool")
    use_tile = system.plan(queries.shape[0]) == "tile"
    prog.add("marked", eng.step_routine(params, store, nbrs, SYNC_EVERY,
                                        use_tile, marks), marks=marks)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prog.load(queries=queries, entries=entries)
    prog.fill(caps=eng.cfg.iters(), taus=eng.angle_tau)
    prog.run("init")
    _sync(dev)
    with profile(activities=acts) as prof:
        for _ in range(eng.cfg.iters() // SYNC_EVERY + 2):
            prog.run("marked")
            if bool(prog.state.done.all()):
                break
        _sync(dev)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.load(open(path)).get("traceEvents", [])
    finally:
        os.unlink(path)
    return attribute(events)


def attribute(events: list) -> dict:
    """Device seconds by (the ``repro/`` range its launch fell in, op)."""
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"][6:])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("repro/"))
    starts = [r[0] for r in ranges]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    by = defaultdict(lambda: defaultdict(float))
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace_lib.DEVICE_CATS:
            continue
        ts = launch.get(e.get("args", {}).get("correlation"))
        stage = "outside"
        if ts is not None:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ranges[i][0] <= ts <= ranges[i][1]:
                stage = ranges[i][2]
        by[stage][e["name"]] += e["dur"] * 1e-6
    return {"stage_s": {s: sum(v.values()) for s, v in by.items()},
            "top_ops": {s: sorted(([n, t] for n, t in v.items()),
                                  key=lambda x: -x[1])[:5]
                        for s, v in by.items()}}


# -- online ------------------------------------------------------------------

def online(system, inputs, mix, seconds: float, turns: int, dev) -> dict:
    tr = Tracer(sample=None)
    tr.enabled = False
    rt = ContinuousRuntime(system.engine, system.params, system.store,
                           system.neighbors, query_dim=system.config["dim"],
                           entry=system.entry, device=dev, tracer=tr,
                           **mix["runtime"])
    queries = inputs.queries.cpu().numpy()
    rt.warmup(queries[0])
    drivers.settle()
    rng = np.random.default_rng(7)
    nxt = [0]

    def drive(window: float, on: bool, cupti: bool = False) -> dict:
        due = generator.arrivals(mix, window, rng)
        tr.enabled = on
        c0, r0, n0 = dict(rt.counters), dict(rt.round_s), rt.traced_rounds
        reduced = {}
        prof = trace_lib.traced(dev, reduced) if cupti else None
        if prof is not None:
            prof.__enter__()
        i, rounds = 0, 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            if now - t0 >= window:
                break
            while i < len(due) and t0 + due[i] <= now:
                rt.submit(queries[nxt[0] % len(queries)],
                          t_arrive=t0 + due[i])
                nxt[0] += 1
                i += 1
            if not rt.queue and not rt.in_flight:
                time.sleep(0.0002)
                continue
            rt.step_once()
            rt.pop_completions()
            rounds += 1
        wall = time.perf_counter() - t0
        if prof is not None:
            _sync(dev)
            prof.__exit__(None, None, None)
        tr.enabled = False
        while rt.queue or rt.in_flight:      # drain, off the clock
            rt.step_once()
        rt.pop_completions()
        c = {k: rt.counters[k] - c0[k] for k in c0}
        r = {k: rt.round_s[k] - r0[k] for k in r0}
        w = {"tracing": on, "cupti": cupti, "window_s": wall,
             "rounds": rounds, "round_ms": 1e3 * wall / rounds,
             "counters": c}
        if on:
            n = rt.traced_rounds - n0
            w["phase_ms"] = {p: 1e3 * r[p] / n for p in ROUND_PHASES}
            w["round_busy_ms"] = 1e3 * r["device"] / n
            w["phase_cover"] = sum(r[p] for p in ROUND_PHASES) / wall
        if cupti:
            w["busy_s"] = reduced.get("busy_s")
            w["trace_window_s"] = reduced.get("window_s")
            w["idle_gaps"] = reduced.get("idle_gaps")
            w["device_ops"] = reduced.get("device_ops")
            if on and reduced.get("busy_s"):
                w["round_busy_over_busy"] = r["device"] / reduced["busy_s"]
        return w

    out = {"kind": "online", "rate_qps": mix["rate_qps"],
           "windows": [drive(seconds, on) for on in _turns(turns)]}
    out["cupti"] = [drive(mix["trace_s"], True, cupti=True),
                    drive(mix["trace_s"], False, cupti=True)]
    out["tick_alone_ms"] = _tick_alone(rt, queries, dev)
    return out


def _tick_alone(rt, queries, dev, n: int = 20):
    """A tick's device ms when the device never waits for the host: every
    lane filled, then ``n`` tick replays issued back to back between two
    events (None off a card)."""
    if dev.type != "cuda":
        return None
    for i in range(rt.n_lanes):
        rt.submit(queries[i % len(queries)])
    rt.step_once()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        rt.program.run("tick")
    b.record()
    torch.cuda.synchronize(dev)
    while rt.queue or rt.in_flight:
        rt.step_once()
    rt.pop_completions()
    return a.elapsed_time(b) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shrink", type=json.loads, default=None)
    ap.add_argument("--out", default="chiprun_out/stage_trace.json")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    results = {}
    built = {}
    for name in args.cells:
        config = name.split(".")[0]
        if config not in built:
            for old in built.values():
                old[0].release()
            built.clear()
            built[config] = set_up(name, args.seconds, args.shrink, dev)
        system, inputs, mix = built[config]
        mix = harness.shrunk(system.config, generator.load(
            manifest.cell(manifest.load(), name)["traffic"]),
            args.shrink)[1]
        run = bulk if mix["kind"] == "bulk" else online
        res = run(system, inputs, mix, args.seconds, args.turns, dev)
        res["card"] = (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")
        results[name] = res
        print(json.dumps({name: res}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
