#!/usr/bin/env python3
"""Card smoke test of the PyTorch/CUDA port (``src/repro_torch``): builds
the CUDA kernels from this checkout, holds each against its plain PyTorch
version on the card, runs the engine on the card against the same engine on
the CPU, serves the GUITAR DeepFM search at N=100,000 through the port's
oneshot serving path, counting kernel launches, and profiles one served
batch (device busy share, device time by kernel).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card; exits non-zero without one, when any phase fails, or
when run without the rest of the repository. Imports nothing of JAX. The
last line of standard output is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel's numbers as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and fp32 (non-tensor) peak
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12

# kernel-vs-plain tolerances on the card. Both compute in fp32 and differ
# only in summation order (warp shuffles and FMA chains vs cuBLAS), a few
# ulps through 64-wide sums; acos turns a one-ulp cosine difference near
# +-1 into ~3.5e-4 rad, so angle keys get 5e-4.
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
ANGLE_KEY_ATOL = 5e-4
PROJ_KEY_RTOL, PROJ_KEY_ATOL = 1e-5, 1e-5
RESULT_SCORE_ATOL = 1e-5
RECALL_AGREE = 0.01


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, trials: int = 25) -> float:
    """Median device time of one call: ``reps`` calls captured in a CUDA
    graph, the graph replayed ``trials`` times between CUDA events (after a
    warm-up), each replay's time divided by ``reps``. Replay leaves out the
    host's launch overhead, which ``host_us`` measures."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us(fn, reps: int = 200) -> float:
    """Wall-clock microseconds per call, launches included, synchronised
    at the end: what one eager call costs the serving loop."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close_err(got, want, rtol, atol):
    """(max abs error, worst |err| / (atol + rtol*|want|))."""
    err = (got.double() - want.double()).abs()
    lim = atol + rtol * want.double().abs()
    return float(err.max()), float((err / lim).max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def deepfm_costs(M, D, fm, H0, H1, per_row_query, grad):
    K0 = 2 * (D - fm)
    weights = K0 * H0 + H0 + H0 * H1 + H1 + H1 + 1
    rows_in = M * D + (M * D if per_row_query else D)
    rows_out = M + (M * D if grad else 0)
    nbytes = 4 * (rows_in + weights + rows_out)
    fwd = 2 * fm + 2 * K0 * H0 + H0 + 2 * H0 * H1 + H1 + 2 * H1 + 4
    bwd = 3 * H1 + 2 * H1 * H0 + H0 + 2 * H0 * (K0 // 2) + fm + 2
    return nbytes, M * (fwd + (bwd if grad else 0))


def rank_costs(Q, B, D):
    nbytes = 4 * (2 * Q * D + Q * B * D + Q * B) + 2 * Q * B
    flops = Q * (2 * D) + Q * B * (D + 4 * D + 8)
    return nbytes, flops


def check_kernels(torch, dev, measure, fm_dim):
    from repro_torch.kernels import (deepfm_score, deepfm_value_and_grad,
                                     neighbor_rank)
    from repro_torch.kernels.deepfm_grad.ref import deepfm_value_and_grad_ref
    from repro_torch.kernels.deepfm_score.ref import deepfm_score_ref
    from repro_torch.kernels.neighbor_rank.ref import neighbor_rank_ref

    mlp = measure.params["mlp"]
    w, b = mlp["w"], mlp["b"]
    D = w[0].shape[0] // 2 + fm_dim
    H0, H1 = w[0].shape[1], w[1].shape[1]
    gen = torch.Generator(device="cpu").manual_seed(123)

    def rows(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def plain_score(c, q):
        q = q.expand(c.shape[0], -1) if q.dim() == 1 else q
        return deepfm_score_ref(c, q, w[0], b[0], w[1], b[1], w[2], b[2],
                                fm_dim)

    def plain_grad(c, q):
        q = q.expand(c.shape[0], -1) if q.dim() == 1 else q
        return deepfm_value_and_grad_ref(c, q, w[0], b[0], w[1], b[1], w[2],
                                         b[2], fm_dim)

    report = {}
    # -- deepfm_score: main path M = Q*C = 256 (per step) and 32 (init),
    #    a ragged M, both query forms
    worst = 0.0
    for M in (256, 32, 77):
        for shared in (False, True):
            c = rows(M, D)
            q = rows(D) if shared else rows(M, D)
            got = deepfm_score(c, q, mlp, fm_dim)
            torch.cuda.synchronize()
            err, ratio = close_err(got, plain_score(c, q), SCORE_RTOL,
                                   SCORE_ATOL)
            log(f"deepfm_score M={M} shared_query={shared}: max_abs_err="
                f"{err:.3e} (err/tol {ratio:.3f})")
            require(ratio <= 1.0, f"deepfm_score mismatch at M={M} "
                    f"shared={shared}: {err:.3e}")
            worst = max(worst, err)
    c, q = rows(256, D), rows(256, D)
    nbytes, flops = deepfm_costs(256, D, fm_dim, H0, H1, True, False)
    report["deepfm_score"] = dict(
        err=worst, ms=time_ms(lambda: deepfm_score(c, q, mlp, fm_dim)),
        plain_ms=time_ms(lambda: plain_score(c, q)),
        host_us=host_us(lambda: deepfm_score(c, q, mlp, fm_dim)),
        bound=bound_ms(nbytes, flops))

    # -- deepfm_grad: main path Q=32, a ragged Q, both query forms
    worst = 0.0
    for M in (32, 7, 256):
        for shared in (False, True):
            c = rows(M, D)
            q = rows(D) if shared else rows(M, D)
            v, g = deepfm_value_and_grad(c, q, mlp, fm_dim)
            torch.cuda.synchronize()
            pv, pg = plain_grad(c, q)
            ev, rv = close_err(v, pv, SCORE_RTOL, SCORE_ATOL)
            eg, rg = close_err(g, pg, GRAD_RTOL, GRAD_ATOL)
            log(f"deepfm_grad M={M} shared_query={shared}: vals max_abs_err="
                f"{ev:.3e} (err/tol {rv:.3f}) grads max_abs_err={eg:.3e} "
                f"(err/tol {rg:.3f})")
            require(rv <= 1.0 and rg <= 1.0, f"deepfm_grad mismatch at "
                    f"M={M} shared={shared}: vals {ev:.3e} grads {eg:.3e}")
            worst = max(worst, ev, eg)
    c, q = rows(32, D), rows(32, D)
    nbytes, flops = deepfm_costs(32, D, fm_dim, H0, H1, True, True)
    report["deepfm_grad"] = dict(
        err=worst,
        ms=time_ms(lambda: deepfm_value_and_grad(c, q, mlp, fm_dim)),
        plain_ms=time_ms(lambda: plain_grad(c, q)),
        host_us=host_us(lambda: deepfm_value_and_grad(c, q, mlp, fm_dim)),
        bound=bound_ms(nbytes, flops))

    # -- neighbor_rank: main path (Q, B, D) = (32, 48, D), a ragged shape,
    #    both rank modes; gradients from the grad kernel's plain version
    alpha = 1.01
    worst = 0.0
    for Q, B in ((32, 48), (5, 37)):
        x = rows(Q, D)
        nv = x[:, None, :] + 0.5 * rows(Q, B, D)
        g = plain_grad(x, rows(Q, D))[1].contiguous()
        valid = (torch.rand((Q, B), generator=gen) < 0.7).to(dev)
        valid[0] = False                                 # an all-invalid lane
        for rank_by in ("angle", "projection"):
            key, mask = neighbor_rank(x, g, nv, valid, alpha, rank_by)
            torch.cuda.synchronize()
            pk, pm = neighbor_rank_ref(x, g, nv, valid, alpha, rank_by)
            fin = torch.isfinite(pk)
            require(bool((torch.isfinite(key) == fin).all())
                    and bool((key[~fin] == pk[~fin]).all()),
                    f"neighbor_rank {rank_by}: invalid keys differ")
            if rank_by == "angle":
                err, ratio = close_err(key[fin], pk[fin], 0.0, ANGLE_KEY_ATOL)
                theta = torch.where(fin, pk, torch.inf).min(1,
                                                           True).values
                near = (pk - (alpha * theta)).abs() <= ANGLE_KEY_ATOL
            else:
                err, ratio = close_err(key[fin], pk[fin], PROJ_KEY_RTOL,
                                       PROJ_KEY_ATOL)
                proj = torch.where(fin, -pk, -torch.inf)
                theta = proj.max(1, True).values
                bnd = torch.where(theta >= 0, theta / alpha, theta * alpha)
                near = (proj - bnd).abs() <= PROJ_KEY_ATOL * (1 + bnd.abs())
            n_diff = int(((mask != pm) & ~near).sum())
            log(f"neighbor_rank Q={Q} B={B} {rank_by}: key max_abs_err="
                f"{err:.3e} (err/tol {ratio:.3f}) mask mismatches away from "
                f"the band edge: {n_diff}")
            require(ratio <= 1.0 and n_diff == 0,
                    f"neighbor_rank {rank_by} mismatch at Q={Q} B={B}")
            worst = max(worst, err)
    Q, B = 32, 48
    x, gq = rows(Q, D), rows(Q, D)
    nv = x[:, None, :] + 0.5 * rows(Q, B, D)
    g = plain_grad(x, gq)[1].contiguous()
    valid = (torch.rand((Q, B), generator=gen) < 0.7).to(dev)
    nbytes, flops = rank_costs(Q, B, D)
    report["neighbor_rank"] = dict(
        err=worst, ms=time_ms(lambda: neighbor_rank(x, g, nv, valid, alpha)),
        plain_ms=time_ms(lambda: neighbor_rank_ref(x, g, nv, valid, alpha)),
        host_us=host_us(lambda: neighbor_rank(x, g, nv, valid, alpha)),
        bound=bound_ms(nbytes, flops))
    return report


# ---------------------------------------------------------------------------
# phase 4: the engine on the card against the engine on the CPU
# ---------------------------------------------------------------------------

def plain_result_scores(torch, measure, base_t, queries_t, ids):
    """The plain DeepFM score of each returned id (-inf where id < 0)."""
    from repro_torch.kernels.deepfm_score.ref import deepfm_score_ref
    mlp = measure.params["mlp"]
    Q, k = ids.shape
    rows = base_t[ids.clamp_min(0).reshape(-1)]
    qs = queries_t.repeat_interleave(k, dim=0)
    s = deepfm_score_ref(rows, qs, *[t for pair in zip(mlp["w"], mlp["b"])
                                     for t in pair], measure.meta[1])
    return s.reshape(Q, k).masked_fill(ids < 0, float("-inf"))


def check_result(torch, measure, base_t, queries_t, res, k, label):
    ids, scores = res.ids, res.scores
    require(tuple(ids.shape) == (queries_t.shape[0], k), f"{label}: ids "
            f"shape {tuple(ids.shape)}")
    require(bool((ids >= 0).all()), f"{label}: a query returned < {k} ids")
    require(bool(torch.isfinite(scores).all()), f"{label}: non-finite "
            f"scores")
    srt = ids.sort(dim=1).values
    require(bool((srt[:, 1:] != srt[:, :-1]).all()), f"{label}: repeated "
            f"ids in a result row")
    want = plain_result_scores(torch, measure, base_t, queries_t, ids)
    err = float((scores - want).abs().max())
    log(f"{label}: returned scores vs plain DeepFM score of the returned "
        f"ids: max_abs_err={err:.3e}")
    require(err <= RESULT_SCORE_ATOL, f"{label}: returned scores differ "
            f"from the plain score by {err:.3e}")


def check_engine(torch, np, dev):
    from repro_torch.core import (EngineOptions, SearchConfig,
                                  brute_force_topk, make_corpus_store,
                                  make_family_measure, recall, search_measure)
    from repro_torch.graph import build_l2_graph
    N, D, Q = 5000, 40, 256
    rng = np.random.default_rng(1)
    base = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    graph = build_l2_graph(base, m=24, k_construction=100, device=dev)
    cfg = SearchConfig(k=10, ef=64, budget=8, alpha=1.01, mode="guitar",
                       rank_by="angle")
    out = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        measure = make_family_measure("deepfm",
                                      torch.Generator().manual_seed(0), D,
                                      device=where)
        store = make_corpus_store(base, device=where)
        qt = torch.as_tensor(queries, device=where)
        t0 = time.perf_counter()
        res = search_measure(measure, store, torch.as_tensor(
            graph.neighbors, device=where), qt,
            torch.full((Q,), graph.entry, device=where), cfg,
            EngineOptions())
        if label == "card":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if label == "cpu":
            true_ids, _ = brute_force_topk(measure, store.data, qt, cfg.k)
        else:
            check_result(torch, measure, store.data, qt, res, cfg.k,
                         f"engine N={N} on {where}")
        out[label] = (res, secs)
    r_card = recall(out["card"][0].ids, true_ids)
    r_cpu = recall(out["cpu"][0].ids, true_ids)
    same = float((out["card"][0].ids.cpu() == out["cpu"][0].ids).all(1)
                 .float().mean())
    log(f"engine N={N} Q={Q}: recall@10 card={r_card:.4f} cpu={r_cpu:.4f} "
        f"(|diff| {abs(r_card - r_cpu):.4f} <= {RECALL_AGREE}); identical "
        f"result rows {same:.3f}; card {out['card'][1]:.3f}s, cpu "
        f"{out['cpu'][1]:.3f}s")
    require(abs(r_card - r_cpu) <= RECALL_AGREE,
            f"card/CPU recall disagree: {r_card:.4f} vs {r_cpu:.4f}")
    return {"n": N, "queries": Q, "recall_card": r_card, "recall_cpu": r_cpu,
            "identical_rows": same, "card_s": out["card"][1],
            "cpu_s": out["cpu"][1]}


# ---------------------------------------------------------------------------
# phase 5: serve N = 100,000 through the oneshot path
# ---------------------------------------------------------------------------

def check_serve(torch, np, dev):
    from repro_torch.core import (EngineOptions, SearchConfig,
                                  brute_force_topk, make_corpus_store,
                                  make_family_measure, recall, search_measure)
    from repro_torch.graph import build_l2_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    # the DeepFM model's width (D = 40, hidden 64x64) and corpus size
    # (DeepFMConfig.n_items), the paper's graph (M = 24, k_construction =
    # 100) and search settings; 10 batches of 32 queries
    args = serve.parse_args(["--items", "100000", "--dim", "40",
                             "--queries", "320", "--batch", "32",
                             "--ef", "64", "--budget", "8",
                             "--alpha", "1.01", "--k", "10",
                             "--device", str(dev)])
    rng = np.random.default_rng(0)
    base = rng.normal(size=(args.items, args.dim)).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = build_l2_graph(base, m=24, k_construction=100,
                           exact_threshold=args.items, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"serve: graph N={args.items} built on the card in {build_s:.2f}s "
        f"(avg degree {graph.avg_degree:.1f}, max {graph.max_degree})")
    measure = make_family_measure("deepfm", torch.Generator().manual_seed(0),
                                  args.dim, device=dev)
    cfg = SearchConfig(k=args.k, ef=args.ef, mode=args.mode,
                       budget=args.budget, alpha=args.alpha)
    store = make_corpus_store(base, device=dev)
    nbrs = torch.as_tensor(graph.neighbors, device=dev)

    reset_launch_counts()
    summary = serve.serve_oneshot(args, graph, measure, cfg, EngineOptions(),
                                  store, nbrs, rng, dev)
    counts = launch_counts()
    log(f"serve: kernel launches in the serve run: {counts}")
    for name, n in counts.items():
        require(n > 0, f"serve: kernel {name} was never launched")

    # recall@10 on 64 more queries against the exact top-10
    qr = np.random.default_rng(7).normal(size=(64, args.dim))
    qt = torch.as_tensor(qr.astype(np.float32), device=dev)
    res = search_measure(measure, store, nbrs, qt,
                         torch.full((64,), graph.entry, device=dev), cfg)
    check_result(torch, measure, store.data, qt, res, cfg.k,
                 f"serve N={args.items}")
    true_ids, _ = brute_force_topk(measure, store.data, qt, cfg.k)
    rec = recall(res.ids, true_ids)
    log(f"serve: recall@10 on 64 queries = {rec:.4f}; evals/query "
        f"{float(res.n_eval.float().mean()):.1f}, iterations mean "
        f"{float(res.n_iters.float().mean()):.1f}")
    log(f"serve: QPS={summary['qps']:.1f} p50={summary['p50_ms']:.3f}ms "
        f"p95={summary['p95_ms']:.3f}ms per batch of {args.batch}; "
        f"evals/query {summary['evals_per_query']:.1f}, iterations mean "
        f"{summary['iters_mean']:.1f} max {summary['iters_max']:.0f}")
    out = {**summary, "graph_build_s": build_s, "recall64": rec,
           "launches": counts}
    return out, (measure, store, nbrs, graph, cfg)


def profile_serve(torch, np, dev, ctx):
    """torch.profiler over one served batch of 32 at N=100,000: the share
    of the batch's wall time in which the card runs a kernel, and device
    time by kernel. It reports and checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import search_measure
    from repro_torch.kernels import deepfm_value_and_grad
    measure, store, nbrs, graph, cfg = ctx
    q = torch.as_tensor(np.random.default_rng(9).normal(
        size=(32, store.dim)).astype(np.float32), device=dev)
    entries = torch.full((32,), graph.entry, device=dev)
    search_measure(measure, store, nbrs, q, entries, cfg)
    torch.cuda.synchronize()
    launches0 = deepfm_value_and_grad.launches      # one per engine step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search_measure(measure, store, nbrs, q, entries, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = deepfm_value_and_grad.launches - launches0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        log("profile: the profiler recorded no device events")
        return {"wall_us": wall_us, "device_events": 0}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    by_name = {}
    for e in kern:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    log(f"profile: one batch of 32 at N={store.n}: wall {wall_us:.0f}us, "
        f"device busy {busy:.0f}us ({busy / wall_us:.1%}), idle "
        f"{1 - busy / wall_us:.1%}; {len(kern)} device events over {steps} "
        f"engine steps")
    for name, (n, t) in top:
        log(f"profile:   {t:9.1f}us {n:6d}x  {name[:90]}")
    return {"wall_us": wall_us, "busy_us": busy, "device_events": len(kern),
            "idle_share": 1 - busy / wall_us, "steps": steps,
            "top": [(name, n, t) for name, (n, t) in top]}


KERNEL_META = {
    "deepfm_score": ("src/repro_torch/kernels/csrc/deepfm_score.cu",
                     "src/repro/kernels/deepfm_score/kernel.py:46"),
    "neighbor_rank": ("src/repro_torch/kernels/csrc/neighbor_rank.cu",
                      "src/repro/kernels/neighbor_rank/kernel.py:47"),
    "deepfm_grad": ("src/repro_torch/kernels/csrc/deepfm_grad.cu",
                    "src/repro/kernels/deepfm_grad/kernel.py:63"),
}
WRAPPER = {"deepfm_score": "deepfm_score", "neighbor_rank": "neighbor_rank",
           "deepfm_grad": "deepfm_value_and_grad"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON file")
    opts = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("[smoke] FAIL: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _lib
    except ImportError as e:
        print(f"[smoke] FAIL: the port is not importable ({e}); run from a "
              f"checkout of the repository", file=sys.stderr)
        return 3

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    results = {"nvidia_smi": smi, "torch": torch.__version__,
               "cuda": torch.version.cuda}
    try:
        t0 = time.perf_counter()
        _lib.build(force=True)
        _lib.load()
        results["build_s"] = time.perf_counter() - t0
        log(f"build: {_lib.BUILD_INFO['path']} in {results['build_s']:.1f}s")
        with open(os.path.join(os.path.dirname(_lib.BUILD_INFO["path"]),
                               "build.log")) as f:
            for line in f:
                if "registers" in line or "spill" in line \
                        or "Compiling entry" in line:
                    log("ptxas: " + line.strip())

        from repro_torch.core import make_family_measure
        measure = make_family_measure("deepfm",
                                      torch.Generator().manual_seed(0), 40,
                                      device=dev)
        kern = check_kernels(torch, dev, measure, measure.meta[1])
        for name, r in kern.items():
            log(f"kernel {name}: {r['ms'] * 1e3:.2f}us (plain "
                f"{r['plain_ms'] * 1e3:.2f}us, bound {r['bound'][0] * 1e3:.4f}"
                f"us by {r['bound'][1]}; one eager call costs the host "
                f"{r['host_us']:.1f}us), max_abs_err {r['err']:.3e}")
        results["kernels"] = kern
        results["engine"] = check_engine(torch, np, dev)
        results["serve"], ctx = check_serve(torch, np, dev)
        results["profile"] = profile_serve(torch, np, dev, ctx)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    results["seconds"] = time.perf_counter() - t_start
    log(f"all phases passed in {results['seconds']:.1f}s")

    launches = results["serve"]["launches"]
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
         "replaces": KERNEL_META[name][1],
         "launches": launches[WRAPPER[name]],
         "max_abs_err": kern[name]["err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound"][0],
         "bound_by": kern[name]["bound"][1], "library_ms": None}
        for name in ("deepfm_score", "neighbor_rank", "deepfm_grad")]}
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)),
                    exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump({**results, "kernel_line": line}, f, indent=1,
                      default=str)
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
