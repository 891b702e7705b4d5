"""Serving launcher of the port: stand up a GUITAR ranking service (a
registered measure family, DeepFM or the generic MLP, + l2 graph index) on
one device and answer batches of queries through the expansion engine
(closed-loop "oneshot" serving: each bucket-padded batch steps until every
lane converges).

    PYTHONPATH=src python -m repro_torch.launch.serve --items 10000 \
        --queries 128 [--measure deepfm|mlp] [--fused] \
        [--corpus-dtype float32|bfloat16|int8] \
        [--adaptive angle --c-max 16] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --list-measures

It takes the JAX launcher's flags that the port supports (``--items --dim
--queries --batch --mode --measure --list-measures --k --ef --alpha
--budget --fused --corpus-dtype --adaptive --c-max --angle-tau``) plus
``--device``; any other flag of the JAX launcher exits with a "not ported
yet" message. As there, a non-float32 ``--corpus-dtype`` implies the
index-fused path; the store is quantized once at start-up, and recall is
labelled against the float32 base.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (MEASURE_FAMILIES, EngineOptions, SearchConfig,
                              brute_force_topk, build_engine, get_bundle,
                              list_families, make_corpus_store,
                              make_family_measure, recall, search_measure)
from repro_torch.graph import build_l2_graph
from repro_torch.serving import bucket_pad, latency_summary

# flags of the JAX launcher (repro.launch.serve) this slice does not serve
JAX_ONLY_FLAGS = (
    "--searcher", "--runtime", "--lanes", "--offered-qps",
    "--steps-per-tick", "--deadline", "--max-queue", "--sla", "--sla-mix",
    "--chaos", "--health-every", "--trace-sample", "--trace-out",
    "--metrics-out", "--metrics-json", "--profile-dir", "--tile",
    "--autotune", "--index", "--save-index", "--residency", "--page-rows",
    "--cache-mb")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_oneshot(args, graph, measure, cfg, options, store, nbrs, base_t,
                  rng, device: torch.device) -> dict:
    """Closed-loop batch serving: whole bucket-padded batches, each stepped
    to full convergence. Batch 0 is the warm-up (kernel library load, first
    allocations) and is left out of the steady-state numbers. ``store`` is
    the resident corpus the search runs on; ``base_t`` is the float32 (N, D)
    base that recall is labelled against. Returns the summary it prints."""
    lat_ms, evals, iters_all = [], [], []
    first_recall = None
    shapes_seen = set()
    n_batches = 0
    for s in range(0, args.queries, args.batch):
        n = min(args.batch, args.queries - s)   # ragged tail exercises
        q = rng.normal(size=(n, args.dim)).astype(np.float32)  # bucketing
        qt, entries, n = bucket_pad(q, graph.entry, device)
        n_batches += 1
        shapes_seen.add(tuple(qt.shape))
        _sync(device)
        t0 = time.perf_counter()
        res = search_measure(measure, store, nbrs, qt, entries, cfg, options)
        _sync(device)
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        evals.append(float(res.n_eval[:n].float().mean()))
        iters_all.extend(res.n_iters[:n].tolist())
        if s == 0:
            nr = min(16, n)
            true_ids, _ = brute_force_topk(measure, base_t, qt[:nr],
                                           args.k)
            first_recall = recall(res.ids[:nr], true_ids)

    # guard the single-batch (--queries <= --batch) case: re-run the warm
    # batch so the report never divides by zero or quotes the warm-up
    steady = lat_ms[1:]
    if not steady:
        q = rng.normal(size=(args.batch, args.dim)).astype(np.float32)
        qt, entries, _ = bucket_pad(q, graph.entry, device)
        _sync(device)
        t0 = time.perf_counter()
        res = search_measure(measure, store, nbrs, qt, entries, cfg, options)
        _sync(device)
        steady = [(time.perf_counter() - t0) * 1e3]
        evals.append(float(res.n_eval.float().mean()))
    qps = args.batch * len(steady) / (sum(steady) / 1e3)
    lat = latency_summary(steady)
    iters = np.asarray(iters_all) if iters_all else np.asarray([0])
    summary = {"runtime": "oneshot", "device": str(device),
               "fused": options.fused, "corpus_dtype": options.corpus_dtype,
               "adaptive": options.adaptive, "qps": qps,
               **lat, "evals_per_query": float(np.mean(evals)),
               "iters_mean": float(iters.mean()),
               "iters_max": float(iters.max()),
               "recall": first_recall, "n_batches": n_batches,
               "bucket_shapes": len(shapes_seen)}
    print(f"[serve] device={device} mode={args.mode} measure={args.measure} "
          f"corpus_dtype={options.corpus_dtype} fused={options.fused} "
          f"adaptive={options.adaptive} recall@{args.k}={first_recall:.3f} steady-state {qps:.0f} QPS "
          f"(batch={args.batch})")
    print(f"[serve] latency/batch p50={lat['p50_ms']:.1f}ms "
          f"p95={lat['p95_ms']:.1f}ms batches={n_batches} "
          f"({len(shapes_seen)} bucket shapes) "
          f"effective-evals/query={np.mean(evals):.0f} "
          f"iters mean={iters.mean():.0f} max={iters.max()}")
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="GUITAR oneshot serving on one device (PyTorch port)")
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
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    return ap


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = build_parser()
    args, rest = ap.parse_known_args(argv)
    for a in rest:
        flag = a.split("=", 1)[0]
        if flag in JAX_ONLY_FLAGS:
            raise SystemExit(f"[serve] {flag} is not ported yet (the JAX "
                             f"launcher, python -m repro.launch.serve, "
                             f"has it; see ROADMAP.md)")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
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
                         adaptive=args.adaptive, c_max=args.c_max,
                         angle_tau=args.angle_tau)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if args.list_measures:
        return list_measures()
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[serve] {e}")
    rng = np.random.default_rng(0)
    base = rng.normal(size=(args.items, args.dim)).astype(np.float32)
    t0 = time.time()
    try:
        graph = build_l2_graph(base, m=16, k_construction=48, device=device)
    except NotImplementedError as e:
        raise SystemExit(f"[serve] {e}")
    _sync(device)
    print(f"[serve] index: {args.items} items, "
          f"degree {graph.avg_degree:.1f}, "
          f"built in {time.time() - t0:.1f}s on {device}")
    measure = make_family_measure(args.measure,
                                  torch.Generator().manual_seed(0),
                                  args.dim, device=device)
    cfg = SearchConfig(k=args.k, ef=args.ef, mode=args.mode,
                       budget=args.budget, alpha=args.alpha)
    options = engine_options(args)
    try:
        build_engine(measure, cfg, options)     # refuse bad combinations
    except ValueError as e:
        raise SystemExit(f"[serve] {e}")
    base_t = torch.as_tensor(base, device=device)
    # quantize once, up front: every batch searches the resident payload
    store = make_corpus_store(base_t, args.corpus_dtype, device=device)
    print(f"[serve] corpus resident: dtype={store.dtype} "
          f"{store.nbytes() / 2**20:.1f} MiB "
          f"({'fused' if options.fused else 'unfused'} path)")
    nbrs = torch.as_tensor(graph.neighbors, device=device)
    return serve_oneshot(args, graph, measure, cfg, options, store, nbrs,
                         base_t, rng, device)


if __name__ == "__main__":
    main()
