"""Serving launcher of the port: stand up a GUITAR ranking service (a
registered measure family, DeepFM or the generic MLP, + l2 graph index) on
one device and answer queries through the expansion engine. ``--runtime``
picks the serving discipline:

- ``oneshot``      closed-loop batch jobs: each bucket-padded batch steps
  until every lane converges, as captured programs on the card
  (``--host-loop``: the eager host loop, for comparison).
- ``continuous``   open-loop traffic: Poisson arrivals at
  ``--offered-qps`` feed an admission queue; the lane-recycling runtime
  (``serving/runtime.py``) swaps queued queries into free lanes, and
  per-request completions stream out with SLA metrics (p50/p95/p99
  latency, time in queue, lane occupancy, evals/query).

    PYTHONPATH=src python -m repro_torch.launch.serve --items 10000 \
        --queries 128 [--measure deepfm|mlp] [--fused] \
        [--corpus-dtype float32|bfloat16|int8] [--tile rowwise|tile] \
        [--autotune] [--adaptive angle --c-max 16] [--device cuda|cpu]
    # the legacy lane-major searcher, the engine's A/B baseline
    PYTHONPATH=src python -m repro_torch.launch.serve --searcher legacy
    PYTHONPATH=src python -m repro_torch.launch.serve --runtime continuous \
        --lanes 32 --offered-qps 200 --queries 256 [--sla default] \
        [--chaos plan.json --health-every 0.5 --trace-sample 4 \
         --trace-out spans.jsonl --metrics-out metrics.prom \
         --metrics-json metrics.json --profile-dir prof/]
    PYTHONPATH=src python -m repro_torch.launch.serve --list-measures
    # serve an index built by launch/build_index.py (either package's)
    PYTHONPATH=src python -m repro_torch.launch.serve --index runs/idx \
        [--corpus-dtype int8] [--save-index runs/idx-copy]
    # ... with the corpus paged from the memory-mapped files through a host
    # LRU page cache (16 MiB, 64-row pages)
    PYTHONPATH=src python -m repro_torch.launch.serve --index runs/idx \
        --residency paged --page-rows 64 --cache-mb 16

It takes every flag of the JAX launcher, with its defaults, plus
``--device`` and ``--host-loop``. As there, a non-float32 ``--corpus-dtype``
implies the index-fused path; the store is quantized once at start-up
(or, from ``--index`` in the dtype it was saved in, loaded as stored, with
its tombstones), and recall is labelled against the float32 base (from an
index: its base as ``load_index`` dequantizes it). ``--residency paged``
pages the corpus through a host LRU cache of ``--cache-mb`` MiB in pages of
``--page-rows`` rows: from an index, the saved payload memory-mapped (the
meta's page size when ``--page-rows`` is left at its default); otherwise
the synthetic corpus from host memory. A paged search gathers each step's
rows through the pager between the two captured halves of the step
(``core/engine.py``); ``--chaos`` also installs the plan's page-read
faults (site ``pager``) and tracing the pager's spans.

``--tile`` overrides the fused step's plan (``kernels/autotune.py``:
``rowwise`` runs the fused kernels, ``tile`` one combined gather per step
and the pre-gathered kernels); ``--autotune`` sweeps both at the serving
shape before any traffic and keeps the winner in the tuning cache
(``$REPRO_TORCH_TUNING_CACHE``, else ``./.tuning_cache.torch.json``); a
second run at that shape is a cache hit. ``--searcher legacy`` serves
through ``core.search.search_legacy`` over the float32 base, as the JAX
launcher does: it refuses index-fused or quantized residency and the
continuous runtime, searches the whole base under ``--residency paged``,
and ignores the engine's options (``--adaptive``, ``--tile``).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (MEASURE_FAMILIES, EngineOptions,
                              ResidencyPolicy, SearchConfig,
                              brute_force_topk, build_engine, get_bundle,
                              list_families, make_corpus_store,
                              make_family_measure, recall, search_legacy,
                              search_measure)
from repro_torch.core.search import legacy_searcher
from repro_torch.graph import (GraphIndex, build_l2_graph,
                               load_corpus_store, load_index,
                               load_index_meta, save_index)
from repro_torch.kernels import autotune
from repro_torch.obs import (NULL_TRACER, Registry, Tracer, format_trace,
                             profile_trace)
from repro_torch.serving import (ContinuousRuntime, FaultPlan, Request,
                                 bucket_pad, latency_summary, load_policy,
                                 poisson_arrivals)

# continuous-runtime telemetry and chaos flags (refused for oneshot)
CONTINUOUS_FLAGS = ("chaos", "health_every", "trace_sample", "trace_out",
                    "metrics_out", "metrics_json")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_oneshot(args, graph, measure, cfg, options, store, nbrs, base_t,
                  rng, device: torch.device,
                  results: Optional[list] = None) -> dict:
    """Closed-loop batch serving: whole bucket-padded batches, each stepped
    to full convergence. Batch 0 is the warm-up (kernel library load, first
    allocations) and is left out of the steady-state numbers. ``store`` is
    the resident corpus the search runs on; ``base_t`` is the float32 (N, D)
    base that recall is labelled against. ``results`` (a list), if given,
    receives each batch's ``SearchResult`` (its live rows) in order.
    ``--searcher legacy`` searches ``base_t`` with ``search_legacy``.
    Returns the summary it prints."""
    capture = not args.host_loop
    legacy = args.searcher == "legacy"
    stats = (legacy_searcher(measure.score_fn, cfg) if legacy
             else build_engine(measure, cfg, options)).stats
    lat_ms, evals, iters_all, host = [], [], [], []
    first_recall = None
    shapes_seen = set()
    n_batches = 0

    def run_batch(qt, entries):
        st0 = dict(stats)
        _sync(device)
        t0 = time.perf_counter()
        if legacy:
            res = search_legacy(measure.score_fn, measure.params, base_t,
                                nbrs, qt, entries, cfg, capture=capture)
        else:
            res = search_measure(measure, store, nbrs, qt, entries, cfg,
                                 options, capture=capture)
        _sync(device)
        dt = (time.perf_counter() - t0) * 1e3
        st = {k: stats[k] - st0[k] for k in st0}
        return res, dt, st

    for s in range(0, args.queries, args.batch):
        n = min(args.batch, args.queries - s)   # ragged tail exercises
        q = rng.normal(size=(n, args.dim)).astype(np.float32)  # bucketing
        qt, entries, n = bucket_pad(q, graph.entry, device)
        n_batches += 1
        shapes_seen.add(tuple(qt.shape))
        res, dt, st = run_batch(qt, entries)
        if results is not None:
            results.append(type(res)(*(t[:n] for t in res)))
        lat_ms.append(dt)
        host.append(st)
        evals.append(float(res.n_eval[:n].float().mean()))
        iters_all.extend(res.n_iters[:n].tolist())
        if s == 0:
            nr = min(16, n)
            true_ids, _ = brute_force_topk(measure, base_t, qt[:nr],
                                           args.k)
            first_recall = recall(res.ids[:nr], true_ids)

    # guard the single-batch (--queries <= --batch) case: re-run the warm
    # batch so the report never divides by zero or quotes the warm-up
    steady, steady_host = lat_ms[1:], host[1:]
    if not steady:
        q = rng.normal(size=(args.batch, args.dim)).astype(np.float32)
        qt, entries, _ = bucket_pad(q, graph.entry, device)
        res, dt, st = run_batch(qt, entries)
        steady, steady_host = [dt], [st]
        evals.append(float(res.n_eval.float().mean()))
    qps = args.batch * len(steady) / (sum(steady) / 1e3)
    lat = latency_summary(steady)
    iters = np.asarray(iters_all) if iters_all else np.asarray([0])
    steps = sum(st["steps"] for st in steady_host)
    host_us = 1e6 * sum(st["issue_s"] for st in steady_host) / steps
    runs = sum(st["runs"] for st in steady_host) / len(steady_host)
    paged = store.is_paged and not legacy
    summary = {"runtime": "oneshot", "searcher": args.searcher,
               "device": str(device),
               "loop": ("captured" if capture and device.type == "cuda"
                        else "host"),
               "fused": options.fused, "corpus_dtype": options.corpus_dtype,
               "adaptive": options.adaptive, "qps": qps,
               **lat, "evals_per_query": float(np.mean(evals)),
               "iters_mean": float(iters.mean()),
               "iters_max": float(iters.max()),
               "steps_per_batch": steps / len(steady_host),
               "host_us_per_step": host_us, "runs_per_batch": runs,
               "recall": first_recall, "n_batches": n_batches,
               "bucket_shapes": len(shapes_seen),
               "residency": "paged" if paged else "whole"}
    if paged:
        # host us per step of a paged search, by part (PagedFeed.times)
        summary["paged_us_per_step"] = {
            part: 1e6 * sum(st["paged_" + part + "_s"]
                            for st in steady_host) / steps
            for part in ("replay", "sync", "gather", "h2d")}
        summary["pager"] = dataclasses.asdict(store.stats_snapshot())
    print(f"[serve] searcher={args.searcher} device={device} "
          f"mode={args.mode} measure={args.measure} "
          f"corpus_dtype={options.corpus_dtype} fused={options.fused} "
          f"adaptive={options.adaptive} recall@{args.k}={first_recall:.3f} steady-state {qps:.0f} QPS "
          f"(batch={args.batch})")
    print(f"[serve] latency/batch p50={lat['p50_ms']:.1f}ms "
          f"p95={lat['p95_ms']:.1f}ms batches={n_batches} "
          f"({len(shapes_seen)} bucket shapes) "
          f"effective-evals/query={np.mean(evals):.0f} "
          f"iters mean={iters.mean():.0f} max={iters.max()}")
    print(f"[serve] {summary['loop']} loop: "
          f"{summary['steps_per_batch']:.0f} steps and "
          f"{runs:.0f} program runs per batch, {host_us:.1f}us of host "
          f"issue per step")
    if paged:
        us, st = summary["paged_us_per_step"], store.stats_snapshot()
        print(f"[serve] paged step: replays {us['replay']:.1f}us, ids sync "
              f"{us['sync']:.1f}us, pager gather {us['gather']:.1f}us, "
              f"tile copy {us['h2d']:.1f}us; pager hits={st.hits} "
              f"faults={st.faults} evictions={st.evictions} hit_rate="
              f"{st.hit_rate:.3f} peak_resident="
              f"{st.peak_resident_bytes / 2**20:.2f} MiB")
    return summary


def _parse_sla_mix(spec: str, policy) -> list:
    """'premium:0.2,standard:0.5,economy:0.3' -> tier-name list of 100
    slots (request i takes slot i % 100): a deterministic traffic mix."""
    names = {c.name for c in policy.classes}
    slots = []
    for part in spec.split(","):
        name, _, frac = part.partition(":")
        name = name.strip()
        if name not in names:
            raise SystemExit(f"--sla-mix tier {name!r} not in policy "
                             f"(have {sorted(names)})")
        slots += [name] * max(1, round(float(frac or 1) * 100))
    return slots[:100] or [policy.classes[0].name]


def serve_continuous(args, graph, measure, cfg, options, store, nbrs,
                     base_t, rng, device: torch.device) -> dict:
    """Open-loop continuous batching: Poisson arrivals at --offered-qps
    into the lane-recycling runtime; per-request SLA metrics out. Recall
    is labelled on the float32 base over the first 16 requests' ok
    completions. Returns the summary it prints."""
    engine = build_engine(measure, cfg, options)
    sla_policy = None
    if args.sla != "off":
        sla_policy = load_policy(args.sla)
        print("[serve] SLA tiers (richest first; each tier overrides the "
              "request's iter_cap + angle_tau, corpus_dtype is advisory):")
        for line in sla_policy.table():
            print(f"[serve]   {line}")
        if options.adaptive == "off" \
                and any(c.angle_tau > 0 for c in sla_policy.classes):
            print("[serve] note: tiers carry angle_tau cutoffs but "
                  "--adaptive is off: taus are inert; pass --adaptive "
                  "angle to let tiers shrink |C|")
    fault_hook = None
    if args.chaos:
        fault_plan = FaultPlan.load(args.chaos)
        fault_hook = fault_plan.tick_hook("tick")
        print(f"[serve] chaos: replaying {args.chaos} "
              f"(seed={fault_plan.seed}, {len(fault_plan.events)} event(s))")
    # --profile-dir alone: a tracer of the round's phases, no request
    tracer = (Tracer(sample=args.trace_sample) if args.trace_sample
              else Tracer(sample=None) if args.profile_dir else NULL_TRACER)
    runtime = ContinuousRuntime(engine, measure.params, store, nbrs,
                                n_lanes=args.lanes, query_dim=args.dim,
                                entry=graph.entry,
                                steps_per_tick=args.steps_per_tick,
                                max_queue=args.max_queue,
                                fault_hook=fault_hook, tracer=tracer,
                                sla_policy=sla_policy, device=device)
    if runtime.store.is_paged:
        # page-read faults only make sense against a pager
        if args.chaos:
            runtime.store.set_read_hook(fault_plan.pager_hook("pager"))
        if tracer.enabled:
            runtime.store.set_tracer(tracer)
    queries = rng.normal(size=(args.queries, args.dim)).astype(np.float32)
    runtime.warmup(queries[0])      # capture reset + tick off the clock
    registry = None
    if args.metrics_out:
        registry = runtime.bind_registry(Registry())  # after warmup
        autotune.bind_registry(registry)
    arrivals = poisson_arrivals(args.queries, args.offered_qps, seed=1)
    mix = (_parse_sla_mix(args.sla_mix, sla_policy)
           if sla_policy is not None and args.sla_mix else None)
    stream = [Request(rid=i, query=queries[i], t_arrive=float(arrivals[i]),
                      deadline=args.deadline,
                      sla=mix[i % len(mix)] if mix else None)
              for i in range(args.queries)]
    completions = runtime.run_stream(stream,
                                     health_every_s=args.health_every)
    summary = {"runtime": "continuous", "device": str(device),
               "lanes": args.lanes, "steps_per_tick": args.steps_per_tick,
               "offered_qps": args.offered_qps,
               **runtime.metrics.summary(),
               "health": runtime.health_snapshot(), "recall": None,
               "statuses": dict(collections.Counter(
                   c.status for c in completions))}
    by_rid = {c.rid: c for c in completions}
    nr = min(16, args.queries)
    ok_rids = [i for i in range(nr) if by_rid[i].status == "ok"]
    if not ok_rids:
        print(f"[serve] runtime=continuous lanes={args.lanes} "
              f"offered={args.offered_qps:.0f} QPS: no ok completions in "
              f"the recall window (degraded run)")
    else:
        true_ids, _ = brute_force_topk(
            measure, base_t, torch.as_tensor(queries[:nr], device=device),
            args.k)
        got = np.stack([by_rid[i].ids for i in ok_rids])
        summary["recall"] = recall(got, true_ids.cpu().numpy()[ok_rids])
        print(f"[serve] runtime=continuous device={device} "
              f"lanes={args.lanes} steps_per_tick={args.steps_per_tick} "
              f"offered={args.offered_qps:.0f} QPS mode={args.mode} "
              f"measure={args.measure} "
              f"corpus_dtype={options.corpus_dtype} fused={options.fused} "
              f"recall@{args.k}={summary['recall']:.3f}")
    print(runtime.format_health())
    print(runtime.metrics.report())
    export_telemetry(args, runtime, tracer, registry, completions)
    return summary


def export_telemetry(args, runtime, tracer, registry, completions) -> None:
    """--trace-out (the span ring as JSONL, and the slowest traced ok
    request's span tree), --metrics-out (the registry in Prometheus text)
    and --metrics-json (``metrics.summary()``), after the stream drains."""
    if args.trace_out and tracer.enabled:
        n = tracer.export_jsonl(args.trace_out)
        print(f"[serve] traces -> {args.trace_out} ({n} spans, "
              f"1/{args.trace_sample} sampling)")
        slow = max((c for c in completions
                    if tracer.sampled(c.rid) and c.status == "ok"),
                   key=lambda c: c.record.latency_ms, default=None)
        if slow is not None:
            print("[serve] slowest traced ok request:")
            print(format_trace(tracer, slow.rid, sites=("pager",)))
    if registry is not None:
        with open(args.metrics_out, "w") as f:
            f.write(registry.render_text())
        print(f"[serve] metrics (prometheus text) -> {args.metrics_out}")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(runtime.metrics.summary(), f, indent=1,
                      sort_keys=True)
        print(f"[serve] metrics json -> {args.metrics_json}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="GUITAR serving on one device (PyTorch port)")
    ap.add_argument("--items", type=int, default=10000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--mode", choices=["guitar", "sl2g"], default="guitar")
    ap.add_argument("--measure", choices=sorted(MEASURE_FAMILIES),
                    default="deepfm",
                    help="measure family (registry-resolved kernel bundle): "
                         "the paper's DeepFM, or the generic "
                         "sigmoid(MLP([x, q])) measure")
    ap.add_argument("--list-measures", action="store_true",
                    help="print the measure-kernel bundle registry and exit")
    ap.add_argument("--searcher", choices=["engine", "legacy"],
                    default="engine",
                    help="the staged expansion engine, or the legacy "
                         "lane-major searcher (its A/B baseline: float32 "
                         "base, oneshot only)")
    ap.add_argument("--runtime", choices=["oneshot", "continuous"],
                    default="oneshot",
                    help="batch-scoped vs lane-recycling serving")
    ap.add_argument("--lanes", type=int, default=32,
                    help="continuous runtime: engine lanes (slots)")
    ap.add_argument("--offered-qps", type=float, default=200.0,
                    help="continuous runtime: open-loop Poisson arrival rate")
    ap.add_argument("--steps-per-tick", type=int, default=8,
                    help="continuous runtime: engine steps per scheduler "
                         "round (latency quantum vs host overhead)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="continuous runtime: max seconds in queue before a "
                         "request is dropped as timed out")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="continuous runtime: bounded admission queue; "
                         "submits beyond this depth are shed (with --sla "
                         "this depth degrades to the floor tier and 2x "
                         "this depth sheds)")
    ap.add_argument("--sla", type=str, default="off",
                    metavar="off|default|POLICY.json",
                    help="continuous runtime: SLA-tiered serving; each tier "
                         "sets a request's iter_cap and angle_tau (active "
                         "under --adaptive angle only); 'default' is the "
                         "premium/standard/economy ladder, a JSON path a "
                         "custom one (serving/sla.py)")
    ap.add_argument("--sla-mix", type=str, default=None,
                    metavar="TIER:FRAC,...",
                    help="with --sla: pin requests to tiers in this "
                         "proportion (e.g. 'premium:0.2,standard:0.5,"
                         "economy:0.3') instead of deadline classification")
    ap.add_argument("--chaos", type=str, default=None, metavar="PLAN.json",
                    help="continuous runtime: replay a FaultPlan "
                         "(serving/faults.py); tick faults at site 'tick'")
    ap.add_argument("--health-every", type=float, default=None,
                    metavar="SECONDS",
                    help="continuous runtime: print a [health] line at this "
                         "period while the stream drains")
    ap.add_argument("--trace-sample", type=int, default=0, metavar="N",
                    help="continuous runtime: trace every Nth request "
                         "(rid %% N == 0) into per-request span trees "
                         "(obs/trace.py); 0 = tracing off")
    ap.add_argument("--trace-out", type=str, default=None,
                    metavar="TRACES.jsonl",
                    help="export the trace ring buffer as JSONL after the "
                         "stream drains (requires --trace-sample)")
    ap.add_argument("--metrics-out", type=str, default=None,
                    metavar="METRICS.prom",
                    help="continuous runtime: write the obs.Registry in "
                         "Prometheus text exposition format at exit")
    ap.add_argument("--metrics-json", type=str, default=None, metavar="PATH",
                    help="continuous runtime: dump the final metrics "
                         "summary() dict as JSON")
    ap.add_argument("--profile-dir", type=str, default=None,
                    help="torch.profiler trace of the serve run (host, and "
                         "the card's kernels on a card) into this "
                         "directory as trace.json (Chrome trace format)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=1.01)
    ap.add_argument("--budget", type=int, default=8)
    ap.add_argument("--corpus-dtype",
                    choices=["float32", "bfloat16", "int8"],
                    default="float32",
                    help="corpus residency; non-fp32 implies the "
                         "index-fused search path")
    ap.add_argument("--fused", action="store_true",
                    help="index-fused rank/score/grad stages (ids into the "
                         "resident corpus, gathered in the kernels)")
    ap.add_argument("--tile", type=str, default=None,
                    help="fused-step plan override ('tile'|'rowwise'"
                         "[:<bt>], kernels/autotune.py spec; bt is kept "
                         "for the JAX spec and changes nothing on the "
                         "card); default resolves the tuning cache / "
                         "shipped defaults per shape")
    ap.add_argument("--autotune", action="store_true",
                    help="sweep the fused-step plan at this serving shape "
                         "before accepting traffic and keep the winner in "
                         "the tuning cache (skipped on a cache hit: the "
                         "second serve never pays the sweep)")
    ap.add_argument("--adaptive", choices=["off", "angle"], default="off",
                    help="angle-based adaptive candidate-set sizing: the "
                         "alpha*theta band + per-lane tau cutoff as a "
                         "prefix mask over a static c-max block")
    ap.add_argument("--c-max", type=int, default=0,
                    help="adaptive: static candidate block width (0 = "
                         "--budget)")
    ap.add_argument("--angle-tau", type=float, default=0.0,
                    help="adaptive: absolute angle cutoff in radians "
                         "(<=0 disables)")
    ap.add_argument("--index", type=str, default=None,
                    help="serve a saved index directory (launch/"
                         "build_index.py, either package's) instead of "
                         "building one; --items/--dim come from it")
    ap.add_argument("--save-index", type=str, default=None,
                    help="write the served graph index (in --corpus-dtype "
                         "residency) to this directory")
    ap.add_argument("--residency", choices=["whole", "paged"],
                    default="whole",
                    help="corpus residency policy: 'paged' serves the "
                         "corpus through a host LRU page cache (from "
                         "--index: the memory-mapped payload files)")
    ap.add_argument("--page-rows", type=int, default=4096,
                    help="paged residency: rows per page (the index meta's "
                         "saved page_rows wins when this is left at the "
                         "default)")
    ap.add_argument("--cache-mb", type=int, default=64,
                    help="paged residency: LRU page-cache byte budget (MiB "
                         "of host memory)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--host-loop", action="store_true",
                    help="oneshot: run the search as the eager host loop "
                         "(one launch per op, done read every 8 steps) "
                         "instead of the captured programs; for comparison")
    return ap


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.searcher == "legacy" and (args.fused
                                      or args.corpus_dtype != "float32"):
        raise SystemExit("--searcher legacy has no index-fused/quantized "
                         "path; use the engine searcher")
    if args.runtime == "continuous" and args.searcher == "legacy":
        raise SystemExit("--runtime continuous is engine-only (lane "
                         "recycling needs the per-lane reset API)")
    if args.host_loop and args.runtime != "oneshot":
        raise SystemExit("[serve] --host-loop is a oneshot option (the "
                         "continuous runtime always runs its programs)")
    if args.sla != "off" and args.runtime != "continuous":
        raise SystemExit("[serve] --sla needs --runtime continuous (tiers "
                         "are admission policy on the lane scheduler)")
    for name in CONTINUOUS_FLAGS:
        if getattr(args, name) and args.runtime != "continuous":
            flag = "--" + name.replace("_", "-")
            raise SystemExit(f"[serve] {flag} needs --runtime continuous")
    if args.trace_out and not args.trace_sample:
        raise SystemExit("[serve] --trace-out needs --trace-sample N")
    return args


def list_measures() -> dict:
    """Print the measure-kernel bundle registry, as the JAX launcher's
    ``--list-measures`` does; returns {family: registered slots}."""
    print("measure-kernel bundle registry "
          "(family: registered stage factories)")
    out = {}
    for fam in list_families():
        have = [s for s, ok in get_bundle(fam).slots().items() if ok]
        servable = " (serve constructor)" if fam in MEASURE_FAMILIES else ""
        print(f"  {fam}: {', '.join(have)}{servable}")
        out[fam] = have
    print("unregistered families fall back to the generic batched "
          "score_fn / torch.func stages")
    print("adaptive |C| (--adaptive angle) masks the score_fused stage: "
          "families with a fused scorer skip fully-masked rows in-kernel; "
          "generic fallbacks mask densely")
    return out


def engine_options(args: argparse.Namespace) -> EngineOptions:
    """The JAX launcher's mapping: a non-float32 residency implies the
    index-fused path."""
    fused = args.fused or args.corpus_dtype != "float32"
    return EngineOptions(fused=fused, corpus_dtype=args.corpus_dtype,
                         tile=args.tile, adaptive=args.adaptive,
                         c_max=args.c_max, angle_tau=args.angle_tau)


def autotune_plan(args, graph, measure, cfg, options, store, nbrs,
                  device: torch.device):
    """``--autotune``: sweep the fused step's plan at the serving shape
    (Q = ``--lanes`` for the continuous runtime, else ``--batch``) before
    any traffic, on queries from their own generator (the served query
    stream, and recall, stay as without the flag). Paged residency always
    runs the tile plan and a non-fused run has nothing to tune. Returns
    the winning ``TileConfig`` (None when nothing was tuned)."""
    if store.is_paged:
        print("[serve] autotune: skipped (paged residency always runs the "
              "tile plan: one combined pager gather per step)")
        return None
    if not options.fused:
        print("[serve] autotune: nothing to tune (the tile plan applies "
              "to the fused path; pass --fused or a non-fp32 "
              "--corpus-dtype)")
        return None
    lanes = args.lanes if args.runtime == "continuous" else args.batch
    tune_rng = np.random.default_rng(12345)
    tune_q = torch.as_tensor(tune_rng.normal(
        size=(lanes, args.dim)).astype(np.float32), device=device)
    tune_e = torch.full((lanes,), graph.entry, dtype=torch.int64,
                        device=device)
    sweeps = autotune.CACHE_STATS["sweeps"]
    t0 = time.perf_counter()
    tuned = autotune.tune_engine_step(measure, store, nbrs, tune_q, tune_e,
                                      cfg, options)
    dt = time.perf_counter() - t0
    key = autotune.make_key("engine_step", lanes, nbrs.shape[1], store.dim,
                            options.corpus_dtype, device.type)
    swept = autotune.load_cache().get(key, {}).get("swept_us", {})
    how = ("swept " + ", ".join(f"{k}={v:.1f}us" for k, v in swept.items())
           if autotune.CACHE_STATS["sweeps"] > sweeps
           else "cache hit, no sweep")
    print(f"[serve] autotune: engine_step plan={tuned.plan} (Q={lanes}, "
          f"B={nbrs.shape[1]}, D={store.dim}, {options.corpus_dtype}) in "
          f"{dt:.1f}s ({how}) -> {autotune.cache_path()}")
    return tuned


def residency_policy(args) -> Optional[ResidencyPolicy]:
    """``--residency paged``'s policy (None for whole residency)."""
    if args.residency != "paged":
        return None
    return ResidencyPolicy("paged", args.page_rows, args.cache_mb << 20)


def load_served_index(args, device: torch.device):
    """``--index DIR``: the saved graph (its base as ``load_index``
    dequantizes it) and the store to serve, loaded as stored (with its
    tombstones; paged under ``--residency paged``) when the saved dtype is
    the requested one, else re-quantized from the loaded base with a
    warning, as the JAX launcher does (a paged store cannot be). Sets
    ``args.items`` / ``args.dim`` from the index. Returns (graph, store,
    provenance)."""
    graph = load_index(args.index)
    if not isinstance(graph, GraphIndex):
        raise SystemExit(f"[serve] --index {args.index} is not a "
                         f"single-partition graph index (search a "
                         f"ShardedIndex with core.sharded)")
    args.items, args.dim = graph.base.shape
    meta = load_index_meta(args.index)
    saved_dtype = meta.get("corpus_dtype", "float32")
    policy = residency_policy(args)
    if saved_dtype == args.corpus_dtype:
        store = load_corpus_store(args.index, residency=policy,
                                  device=device)
    elif policy is not None:
        raise SystemExit(
            f"[serve] --residency paged cannot re-quantize (paging serves "
            f"the saved payload as it is); rebuild the index with "
            f"--corpus-dtype {args.corpus_dtype} or serve --corpus-dtype "
            f"{saved_dtype}")
    else:
        print(f"[serve] WARNING: index at {args.index} stores the corpus "
              f"as {saved_dtype!r} but --corpus-dtype={args.corpus_dtype!r} "
              f"was requested — re-quantizing the loaded payload to "
              f"{args.corpus_dtype!r} ({saved_dtype!r} round-trip error "
              f"carries over; rebuild with --corpus-dtype "
              f"{args.corpus_dtype} to serve exactly what was quantized "
              f"at build time)")
        store = make_corpus_store(graph.base, args.corpus_dtype,
                                  device=device, tombstones=graph.tombstones)
    print(f"[serve] index: loaded {args.index} ({graph.n} items, "
          f"{graph.n_alive} alive, degree {graph.avg_degree:.1f}, "
          f"corpus_dtype={saved_dtype})")
    built_under = meta.get("measure_family")
    if built_under is not None and built_under != args.measure:
        print(f"[serve] WARNING: index was built measure-aware under the "
              f"{built_under!r} family but --measure={args.measure!r} is "
              f"being served — the query-aware adjacency no longer matches "
              f"the measure; recall will degrade (rebuild with --measure "
              f"{args.measure} or serve --measure {built_under})")
    # carried through --save-index so provenance survives copies
    provenance = {k: meta[k] for k in ("graph_kind", "measure_family")
                  if k in meta}
    return graph, store, provenance


def main(argv: Optional[Sequence[str]] = None,
         results: Optional[list] = None) -> dict:
    """Run the launcher; ``results`` (a list), if given, receives each
    oneshot batch's ``SearchResult`` (``serve_oneshot``)."""
    args = parse_args(argv)
    if args.list_measures:
        return list_measures()
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[serve] {e}")
    rng = np.random.default_rng(0)
    if args.index:
        graph, store, provenance = load_served_index(args, device)
    else:
        base = rng.normal(size=(args.items, args.dim)).astype(np.float32)
        t0 = time.time()
        graph = build_l2_graph(base, m=16, k_construction=48, device=device)
        _sync(device)
        print(f"[serve] index: {args.items} items, "
              f"degree {graph.avg_degree:.1f}, "
              f"built in {time.time() - t0:.1f}s on {device}")
        # quantize once, up front: every batch searches the same payload
        # (paged: from host memory through the pager)
        store = make_corpus_store(graph.base, args.corpus_dtype,
                                  device=device,
                                  residency=residency_policy(args))
        provenance = {"graph_kind": "l2"}
    if args.save_index:
        save_index(args.save_index, graph, corpus_dtype=args.corpus_dtype,
                   extra_meta=provenance)
        print(f"[serve] index saved -> {args.save_index} "
              f"(corpus_dtype={args.corpus_dtype})")
    # deterministic in the seed: build_index constructs the SAME measure
    # for measure-aware (BEGIN) graph construction
    measure = make_family_measure(args.measure,
                                  torch.Generator().manual_seed(0),
                                  args.dim, device=device)
    cfg = SearchConfig(k=args.k, ef=args.ef, mode=args.mode,
                       budget=args.budget, alpha=args.alpha)
    options = engine_options(args)
    if args.searcher == "engine":
        try:
            build_engine(measure, cfg, options)  # refuse bad combinations
        except ValueError as e:
            raise SystemExit(f"[serve] {e}")
    base_t = torch.as_tensor(graph.base, device=device)
    if args.searcher == "legacy":
        print("[serve] searcher=legacy: the lane-major searcher over the "
              "float32 base (the engine's options --adaptive/--tile do "
              "not apply" + ("; the paged store is not searched"
                             if store.is_paged else "") + ")")
    if store.is_paged:
        print(f"[serve] corpus paged: dtype={store.dtype} page_rows="
              f"{store.cache.page_rows} cache_budget={args.cache_mb} MiB "
              f"(resident bytes bounded; LRU page faults on demand; the "
              f"pre-gathered stages run on each step's gathered rows)")
    else:
        print(f"[serve] corpus resident: dtype={store.dtype} "
              f"{store.nbytes() / 2**20:.1f} MiB "
              f"({'fused' if options.fused else 'unfused'} path)")
    nbrs = torch.as_tensor(graph.neighbors, device=device)
    if args.autotune:
        autotune_plan(args, graph, measure, cfg, options, store, nbrs, device)
    # --profile-dir turns the engine's phases and timed chunks on (the
    # continuous runtime's: serve_continuous); the engine is shared by
    # build_engine's cache, so its tracer is taken away after the run
    engine = (build_engine(measure, cfg, options)
              if args.searcher == "engine" and args.runtime == "oneshot"
              and args.profile_dir else None)
    if engine is not None:
        engine.set_tracer(Tracer(sample=None))
    try:
        with profile_trace(args.profile_dir):
            if args.runtime == "continuous":
                out = serve_continuous(args, graph, measure, cfg, options,
                                       store, nbrs, base_t, rng, device)
            else:
                out = serve_oneshot(args, graph, measure, cfg, options,
                                    store, nbrs, base_t, rng, device,
                                    results=results)
    finally:
        if engine is not None:
            engine.set_tracer(NULL_TRACER)
    if args.profile_dir:
        print(f"[serve] profiler trace -> {args.profile_dir}")
    return out


if __name__ == "__main__":
    main()
