#!/usr/bin/env python3
"""Card smoke test of the PyTorch/CUDA port (``src/repro_torch``): builds
the thirteen CUDA kernels from this checkout, holds each against its plain
PyTorch version on the card (the index-fused ones at float32, bfloat16 and
int8 residency, and bit for bit against the pre-gathered ones at float32;
the MLP ones at several depths, the DeepFM pairs at six widths, the
rank pair at six shapes with its plans held against their CPU mirror;
each DeepFM wrapper refusing a net its cluster plan cannot place; the
library kernels embedding_bag, decode_attention and flash_attention at
the JAX test shapes and at DLRM-RM2 and Yi-9B widths in float32 and
bfloat16, driven once each as the slice's main path and timed beside one
PyTorch call of the same function; attention on the tensor cores, bf16
by wgmma and mma.sync and float32 in 3xTF32 by both, checked in the SASS,
in ptxas's spill report and in each launch's path; the cluster kernels
of the MLP and DeepFM pairs checked in the SASS for their cluster
barrier, st.async pushes and mbarrier waits, and built without a spill;
a launch floor timed beside the search-path kernels), runs the engine
with the DeepFM and the MLP measure on the card against the same engine
on the CPU, holds the search's captured programs (CUDA graphs of init and
of 8 steps) against the eager ``search_debug`` and the eager host loop at
N=5,000 on every engine path (bit for bit; the same launches, captured
ones counted once per replay; one eager step of each path free of host
syncs), serves the GUITAR search at N=100,000 through the port's oneshot
serving path on the captured programs (DeepFM unfused, fused at float32,
bfloat16 and int8, and int8 with adaptive angle sizing; the MLP measure
unfused, fused int8 and fused int8 adaptive), counting kernel launches in
each run, serves each of those runs again through the eager host loop and
the captured programs in turns (eager, captured, captured, eager: QPS,
p50/p95, host us per step, program runs per batch, recall), profiles one
served batch of four of those runs through each loop (device busy share,
device events per engine step, device time by kernel and by kind), and
runs the continuous runtime at N=100,000 (DeepFM and MLP fused int8, 32
lanes, 8 steps per tick: a backlog run for capacity, then Poisson
arrivals at 0.8x of it; each request's result = the oneshot captured
search's bit for bit), and runs the index lifecycle: NN-descent on the
card against its CPU path at N=61,000 (recall within 0.01), an l2 graph
at Twitch's N=739,991 (D=40) built through NN-descent (each stage timed;
the graph and NN-descent's lists checked, their recall against the exact
kNN of 1,000 rows logged, and an exact-kNN build of the same items timed
beside it), the index saved and loaded in float32, bfloat16 and int8
(exact round trips; the loaded stores byte for byte ``make_corpus_store``'s),
``serve --index`` from the saved files (DeepFM unfused float32 and fused
int8 adaptive: bit for bit the in-memory serve, the path's kernels
launched as often), and a 4-shard search of the N=100,000 corpus on the
one card (duplicate-free, padded rows never returned, scores the plain
measure's, launches the four shards' searches' sum), and then serves
that 4-shard index through the fault-domain sharded continuous runtime
(32 lanes per shard, 8 steps per tick, 320 requests: DeepFM and MLP fused
int8 healthy, a backlog and Poisson arrivals at 0.8x of it, bit for bit
the one-shot sharded search, launches the shards' captured reset and tick
x replays; a chaos plan from a JSON file (a shard crash that opens its
breaker and recovers, a slow tick, a stall under the tick deadline);
every shard down; a traced run with the metric registry, bit for bit
the untraced one; two more indexes installed mid-stream as index epochs;
``serve --runtime continuous`` with --chaos, --trace-*, --metrics-*,
--health-every and --profile-dir), and then, in the index phase's
directory, paged residency (phase 10: a paged gather from the saved
739,991-item files = the whole store's in f32/bf16/int8; ``serve --index
--residency paged`` at 64-row pages and a 16 MiB host budget for DeepFM
unfused and fused f32/bf16/int8 and MLP unfused, and at the JAX defaults,
each = the whole unfused serve bit for bit with only the pre-gathered
kernels launched, once per step; the continuous runtime on the paged
int8 store = the whole one; paged shard stores and their sharded runtime
under page-read faults; streaming mutation of the N=100,000 graph with
the recovery kill matrix and ``install_index`` into a paged runtime; the
paged continuous launcher with chaos, tracing and the registry), and
last trains (phase 11: the paper's DeepFM measure learned from
interactions at Twitch scale through the example's steps, indexed by
NN-descent and exact kNN, labelled and served by SL2G and GUITAR
unfused and fused int8 with each run's kernels counted; test_system's
claims on the card; a crash and resume equal to the uninterrupted run bit
for bit, and the launcher's resume; DLRM-RM2, DCN-v2, BST and BERT4Rec at
their published configs with full tables, the deterministic table
gradient beside the atomic one, and one smoke step each on the card
against the CPU), and last the tuning cache and the legacy searcher
(phase 12: the engine's tile plan against the rowwise plan and unfused at
N=5,000, DeepFM and MLP, GUITAR and SL2G, f32/bf16/int8, bit for bit,
each plan launching only its kernels once per step; ``serve --autotune``
over the serve phase's N=100,000 graph, a sweep then a cache hit, recall
unchanged, ``--metrics-out`` with the autotune families, and ``--tile
rowwise`` / ``--tile tile`` in turns; ``search_legacy`` on the card
against the CPU, captured = eager, no port kernel; ``serve --searcher
legacy`` beside the engine in turns, and its refusals), and last the LM
and GNN families (phase 13: Yi-9B and Granite-MoE at full width cut to
two layers, one init, prefill and four decode steps on the card against
the CPU in float32 and bf16, the CPU on the card's expert routes and the
router logits held; Yi-9B at full
width, 48 layers, bf16: ``prefill_32k`` at batch 2 through the flash
kernel, one launch a layer, timed and profiled, then greedy steps from
its cache through the decode kernel, one launch a layer a step;
``decode_32k`` at batch 8 from a drawn 32,768-token cache, timed against
its bound; Granite-MoE at full width, a prefill of 8,192 tokens and
greedy steps, the MoE dispatch's share of a layer; ``launch.train`` for
every LM and GNN arch, the first step card against CPU; GIN at
``minibatch_lg`` over the ported generator and fanout sampler, the loss
falling, the sampler timed against the step).

    python3 chip_smoke.py [--out results.json] [--only train|tune|lm]

Needs one CUDA card; exits non-zero without one, when any phase fails, or
when run without the rest of the repository. Imports nothing of JAX. The
last line of standard output is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel's numbers as JSON.
"""
from __future__ import annotations

import argparse
import collections
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, fp32 (non-tensor) peak and
# dense bf16 and TF32 tensor-core peaks
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 495e12

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


def launch_floor_ms(torch, dev) -> float:
    """``time_ms`` of a trivial kernel, an in-place add on a one-element
    tensor: the least a launch costs under the same graph replay, beside
    which the search-path kernels' times are read."""
    one = torch.zeros(1, device=dev)
    return time_ms(lambda: one.add_(1.0))


def bound_ms(nbytes: float, flops: float, dtype: str = "float32"):
    """The least time of a call: the larger of its bytes over the memory
    rate and its FLOPs over the peak of its input dtype (the bf16 tensor
    peak for bfloat16 inputs, the TF32 tensor peak for "tf32", the fp32
    peak otherwise), and which one."""
    peak = {"bfloat16": H100_BF16_FLOPS, "tf32": H100_TF32_FLOPS}.get(
        dtype, H100_FP32_FLOPS)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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


def rank_close(torch, key, mask, pk, pm, alpha, rank_by, name):
    """Keys against the plain keys (invalid keys equal, finite ones within
    the tolerance) and the number of mask entries that differ away from the
    alpha*theta band edge. Returns (max abs err, err/tol, n_diff)."""
    fin = torch.isfinite(pk)
    require(bool((torch.isfinite(key) == fin).all())
            and bool((key[~fin] == pk[~fin]).all()),
            f"{name} {rank_by}: invalid keys differ")
    if not bool(fin.any()):
        return 0.0, 0.0, int((mask != pm).sum())
    if rank_by == "angle":
        err, ratio = close_err(key[fin], pk[fin], 0.0, ANGLE_KEY_ATOL)
        theta = torch.where(fin, pk, torch.inf).min(1, True).values
        near = (pk - (alpha * theta)).abs() <= ANGLE_KEY_ATOL
    else:
        err, ratio = close_err(key[fin], pk[fin], PROJ_KEY_RTOL,
                               PROJ_KEY_ATOL)
        proj = torch.where(fin, -pk, -torch.inf)
        theta = proj.max(1, True).values
        bnd = torch.where(theta >= 0, theta / alpha, theta * alpha)
        near = (proj - bnd).abs() <= PROJ_KEY_ATOL * (1 + bnd.abs())
    return err, ratio, int(((mask != pm) & ~near).sum())


RESIDENCIES = ("float32", "bfloat16", "int8")


def row_bytes(dtype, D):
    """Bytes of one resident corpus row: int8 rows carry a float32 scale."""
    return {"float32": 4 * D, "bfloat16": 2 * D, "int8": D + 4}[dtype]


def fused_deepfm_costs(dtype, M, D, fm, H0, H1, per_row_query, grad,
                       masked=False):
    """deepfm_costs with the rows read from the corpus in residency format
    by int64 id, the optional mask, the x rows the grad form writes, and
    the int8 dequant multiply."""
    nbytes, flops = deepfm_costs(M, D, fm, H0, H1, per_row_query, grad)
    nbytes += M * (row_bytes(dtype, D) - 4 * D) + 8 * M
    nbytes += M if masked else 0
    nbytes += 4 * M * D if grad else 0
    flops += M * D if dtype == "int8" else 0
    return nbytes, flops


def fused_rank_costs(dtype, Q, B, D):
    nbytes, flops = rank_costs(Q, B, D)
    nbytes += Q * B * (row_bytes(dtype, D) - 4 * D) + 8 * Q * B
    flops += Q * B * D if dtype == "int8" else 0
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
    # every net of DEEPFM_NETS at the Ms of SCORE_MS, and the plans
    net_worst, by_net, plans = check_deepfm_score_nets(torch, dev, mlp,
                                                       fm_dim, fused=False)
    c, q = rows(256, D), rows(256, D)
    nbytes, flops = deepfm_costs(256, D, fm_dim, H0, H1, True, False)
    report["deepfm_score"] = dict(
        plan=plans[DEEPFM_NETS[0]], err=max(worst, net_worst),
        err_by_net=by_net,
        ms=time_ms(lambda: deepfm_score(c, q, mlp, fm_dim)),
        plain_ms=time_ms(lambda: plain_score(c, q)),
        host_us=host_us(lambda: deepfm_score(c, q, mlp, fm_dim)),
        bound=bound_ms(nbytes, flops))

    # -- deepfm_grad: every net of DEEPFM_NETS at the Q of GRAD_QS (main
    #    path Q = 32), both query forms
    worst, by_net = check_deepfm_grad_nets(torch, dev, mlp, fm_dim,
                                           fused=False)
    c, q = rows(32, D), rows(32, D)
    nbytes, flops = deepfm_costs(32, D, fm_dim, H0, H1, True, True)
    report["deepfm_grad"] = dict(
        err=worst, err_by_net=by_net,
        ms=time_ms(lambda: deepfm_value_and_grad(c, q, mlp, fm_dim)),
        plain_ms=time_ms(lambda: plain_grad(c, q)),
        host_us=host_us(lambda: deepfm_value_and_grad(c, q, mlp, fm_dim)),
        bound=bound_ms(nbytes, flops))

    # -- neighbor_rank: main path (Q, B, D) = (32, 48, D), and every shape
    #    of RANK_SHAPES, both rank modes; gradients from the grad kernel's
    #    plain version at the serving width; the plans on the card
    alpha = 1.01
    worst = 0.0
    require(RANK_SHAPES[0][2] == D, "the serving shape's width")
    rank_plans = check_rank_plans()
    for Q, B, Dr in RANK_SHAPES:
        x = rows(Q, Dr)
        nv = x[:, None, :] + 0.5 * rows(Q, B, Dr)
        g = plain_grad(x, rows(Q, D))[1].contiguous() if Dr == D else \
            rows(Q, Dr)
        valid = (torch.rand((Q, B), generator=gen) < 0.7).to(dev)
        valid[0] = False                                 # an all-invalid lane
        nv[1, 2] = x[1]                                  # a zero diff
        for rank_by in ("angle", "projection"):
            key, mask = neighbor_rank(x, g, nv, valid, alpha, rank_by)
            torch.cuda.synchronize()
            pk, pm = neighbor_rank_ref(x, g, nv, valid, alpha, rank_by)
            err, ratio, n_diff = rank_close(torch, key, mask, pk, pm, alpha,
                                            rank_by, "neighbor_rank")
            log(f"neighbor_rank Q={Q} B={B} D={Dr} {rank_by}: key "
                f"max_abs_err={err:.3e} (err/tol {ratio:.3f}) mask "
                f"mismatches away from the band edge: {n_diff}")
            require(ratio <= 1.0 and n_diff == 0, f"neighbor_rank {rank_by} "
                    f"mismatch at Q={Q} B={B} D={Dr}")
            worst = max(worst, err)
    Q, B = 32, 48
    x, gq = rows(Q, D), rows(Q, D)
    nv = x[:, None, :] + 0.5 * rows(Q, B, D)
    g = plain_grad(x, gq)[1].contiguous()
    valid = (torch.rand((Q, B), generator=gen) < 0.7).to(dev)
    nbytes, flops = rank_costs(Q, B, D)
    report["neighbor_rank"] = dict(
        plan=rank_plans[(B, D)], err=worst,
        ms=time_ms(lambda: neighbor_rank(x, g, nv, valid, alpha)),
        plain_ms=time_ms(lambda: neighbor_rank_ref(x, g, nv, valid, alpha)),
        host_us=host_us(lambda: neighbor_rank(x, g, nv, valid, alpha)),
        bound=bound_ms(nbytes, flops))
    return report


# the shapes the rank pair is checked at: (Q, B, D). The first is the
# serving shape (the copy compiled for D = 40); then a ragged B, rows that
# are not 16-byte aligned (4-byte copies; bf16 and int8 rows through
# registers; the run-time-width copy), more rows than one pass takes (2
# passes), a wider D (16 threads per row) and more columns than one chunk
# (2 passes of 2 chunks).
RANK_SHAPES = ((32, 48, 40), (5, 37, 40), (3, 17, 33), (2, 300, 40),
               (4, 48, 128), (2, 20, 1100))


def check_rank_plans() -> dict:
    """The plan the rank pair launches at each (B, D) of RANK_SHAPES on the
    card (``neighbor_rank_plan_info``) must equal ``neighbor_rank_plan``'s,
    the serving width run by the copy compiled for it; logs each with its
    blocks per SM. Returns the plans by (B, D)."""
    import ctypes
    from repro_torch.kernels import _lib
    from repro_torch.kernels.neighbor_rank.ops import neighbor_rank_plan
    keys = ("threads_per_row", "lanes", "rows", "cols", "pitch", "threads",
            "smem_bytes", "blocks_per_sm", "serving_width")
    plans = {}
    for _, B, D in RANK_SHAPES:
        info = (ctypes.c_int * len(keys))()
        _lib.check(_lib.load().neighbor_rank_plan_info(B, D, info),
                   "neighbor_rank_plan_info")
        p = plans[(B, D)] = dict(zip(keys, info))
        m = neighbor_rank_plan(B, D)
        require(all(p[k] == m[k] for k in keys[:7]), f"neighbor_rank B={B} "
                f"D={D}: the plan {p} differs from kernels/neighbor_rank/"
                f"ops.py's {m}")
        require(p["serving_width"] == int(D == RANK_SHAPES[0][2]),
                f"neighbor_rank B={B} D={D}: serving width "
                f"{p['serving_width']}")
    log("neighbor_rank plans (threads per row x rows per pass, lanes per "
        "CTA, threads, shared memory per CTA, blocks per SM, copy): "
        + "; ".join(
            f"B={B} D={D} {p['threads_per_row']} x {p['rows']}, "
            f"{p['lanes']}, {p['threads']}, {p['smem_bytes']} B, "
            f"{p['blocks_per_sm']}, "
            + ("RankServing" if p["serving_width"] else "run-time width")
            for (B, D), p in plans.items()))
    return plans


def prefix_mask(torch, lanes, C, gen):
    """The adaptive engine's mask shape: per lane a prefix of its C
    candidates, of random length; lane 0 is masked entirely, lane 1 not."""
    n = torch.randint(0, C + 1, (lanes,), generator=gen)
    n[0], n[1] = 0, C
    return (torch.arange(C)[None, :] < n[:, None]).reshape(-1)


def check_fused_kernels(torch, dev, measure, fm_dim):
    """The index-fused kernels at each residency against their plain
    versions (both query forms, with and without a mask, -1 ids), and at
    float32 bit for bit against the pre-gathered kernels on the gathered
    rows; ``x`` of the grad form must equal ``store.take`` exactly. Times
    each at f32, bf16 and int8."""
    from repro_torch.core import make_corpus_store
    from repro_torch.kernels import (deepfm_grad_fused, deepfm_score,
                                     deepfm_score_fused, neighbor_rank,
                                     neighbor_rank_fused)
    from repro_torch.kernels.deepfm_grad.ref import deepfm_value_and_grad_ref
    from repro_torch.kernels.deepfm_grad_fused.ref import \
        deepfm_grad_fused_ref
    from repro_torch.kernels.deepfm_score_fused.ref import \
        deepfm_score_fused_ref
    from repro_torch.kernels.neighbor_rank_fused.ref import \
        neighbor_rank_fused_ref

    mlp = measure.params["mlp"]
    w, b = mlp["w"], mlp["b"]
    wb = [t for pair in zip(w, b) for t in pair]
    D = w[0].shape[0] // 2 + fm_dim
    H0, H1 = w[0].shape[1], w[1].shape[1]
    N = 5000
    gen = torch.Generator(device="cpu").manual_seed(321)
    base = torch.randn((N, D), generator=gen)
    stores = {dt: make_corpus_store(base, dt, device=dev)
              for dt in RESIDENCIES}
    neg_inf = float("-inf")

    def rows(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def ids_of(*shape):
        i = torch.randint(0, N, shape, generator=gen)
        i.view(-1)[::13] = -1                 # padding, clamped in-kernel
        return i.to(dev)

    report = {}
    # -- deepfm_score_fused: main path M = Q*C = 256 (C = 8) and 512
    #    (adaptive c_max = 16), 32 at init, a ragged M
    worst = 0.0
    for dt, store in stores.items():
        worst_dt = 0.0
        for M, C in ((256, 8), (512, 16), (32, None), (77, None)):
            for shared in (False, True):
                for masked in (False, True):
                    idx = ids_of(M)
                    q = rows(D) if shared else rows(M, D)
                    mask = None
                    if masked:
                        mask = (prefix_mask(torch, M // C, C, gen) if C
                                else torch.rand(M, generator=gen) < 0.5)
                        mask = mask.to(dev)
                    got = deepfm_score_fused(store, idx, q, mlp, fm_dim,
                                             mask=mask)
                    torch.cuda.synchronize()
                    want = deepfm_score_fused_ref(store, idx, q, *wb, fm_dim,
                                                  mask)
                    label = (f"deepfm_score_fused {dt} M={M} shared={shared}"
                             f" masked={masked}")
                    require(torch.equal(torch.isneginf(got),
                                        torch.isneginf(want)),
                            f"{label}: masked rows differ")
                    fin = torch.isfinite(want)
                    if bool(fin.any()):
                        err, ratio = close_err(got[fin], want[fin],
                                               SCORE_RTOL, SCORE_ATOL)
                        require(ratio <= 1.0, f"{label}: {err:.3e}")
                        worst_dt = max(worst_dt, err)
                    if dt == "float32":
                        unf = deepfm_score(store.take(idx.clamp_min(0)), q,
                                           mlp, fm_dim)
                        if mask is not None:
                            unf = unf.masked_fill(~mask, neg_inf)
                        require(torch.equal(got, unf), f"{label}: differs "
                                f"from deepfm_score on the gathered rows")
        log(f"deepfm_score_fused {dt}: 32 cases, max_abs_err {worst_dt:.3e}"
            + (", equal to deepfm_score bit for bit" if dt == "float32"
               else ""))
        worst = max(worst, worst_dt)
    M = 256
    idx, q = ids_of(M), rows(M, D)
    idx_a, q_a = ids_of(512), rows(512, D)
    mask_a = prefix_mask(torch, 32, 16, gen).to(dev)
    # every net of DEEPFM_NETS at each residency (drawn from their own
    # stream, after the cases above)
    net_worst, by_net, _ = check_deepfm_score_nets(torch, dev, mlp, fm_dim,
                                                   fused=True)
    r = report["deepfm_score_fused"] = {"err": max(worst, net_worst),
                                        "err_by_net": by_net, "ms": {},
                                        "plain_ms": {}, "bound": {}}
    for dt, st in stores.items():
        r["ms"][dt] = time_ms(lambda: deepfm_score_fused(st, idx, q, mlp,
                                                         fm_dim))
        r["plain_ms"][dt] = time_ms(lambda: deepfm_score_fused_ref(
            st, idx, q, *wb, fm_dim))
        r["bound"][dt] = bound_ms(*fused_deepfm_costs(dt, M, D, fm_dim, H0,
                                                      H1, True, False))
    st8 = stores["int8"]
    r["host_us"] = host_us(lambda: deepfm_score_fused(st8, idx, q, mlp,
                                                      fm_dim))
    r["adaptive_int8"] = {
        "M": 512, "live_rows": int(mask_a.sum()),
        "ms": time_ms(lambda: deepfm_score_fused(st8, idx_a, q_a, mlp,
                                                 fm_dim, mask=mask_a)),
        "ms_unmasked": time_ms(lambda: deepfm_score_fused(st8, idx_a, q_a,
                                                          mlp, fm_dim))}

    # -- deepfm_grad_fused: every net of DEEPFM_NETS at the Q of GRAD_QS
    #    (main path Q = 32), both query forms, each residency
    worst, by_net = check_deepfm_grad_nets(torch, dev, mlp, fm_dim,
                                           fused=True)
    M = 32
    idx, q = ids_of(M), rows(M, D)
    r = report["deepfm_grad_fused"] = {"err": worst, "err_by_net": by_net,
                                       "ms": {}, "plain_ms": {}, "bound": {}}
    for dt, st in stores.items():
        r["ms"][dt] = time_ms(lambda: deepfm_grad_fused(st, idx, q, mlp,
                                                        fm_dim))
        r["plain_ms"][dt] = time_ms(lambda: deepfm_grad_fused_ref(
            st, idx, q, *wb, fm_dim))
        r["bound"][dt] = bound_ms(*fused_deepfm_costs(dt, M, D, fm_dim, H0,
                                                      H1, True, True))
    r["host_us"] = host_us(lambda: deepfm_grad_fused(st8, idx, q, mlp,
                                                     fm_dim))

    # -- neighbor_rank_fused: main path (Q, B) = (32, 48), and every shape
    #    of RANK_SHAPES, both rank modes; frontier rows and gradients as
    #    the engine has them at the serving width
    alpha = 1.01
    worst = 0.0
    base_of = {D: base}
    for dt, store in stores.items():
        worst_dt = 0.0
        for Q, B, Dr in RANK_SHAPES:
            st = store
            if Dr != D:
                if Dr not in base_of:
                    base_of[Dr] = torch.randn((N, Dr), generator=gen)
                st = make_corpus_store(base_of[Dr], dt, device=dev)
            x = st.take(ids_of(Q).clamp_min(0))
            g = deepfm_value_and_grad_ref(x, rows(Q, D), *wb,
                                          fm_dim)[1].contiguous() \
                if Dr == D else rows(Q, Dr)
            idx = ids_of(Q, B)
            valid = (torch.rand((Q, B), generator=gen) < 0.7).to(dev) \
                & (idx >= 0)
            valid[0] = False                    # an all-invalid lane
            for rank_by in ("angle", "projection"):
                key, mask = neighbor_rank_fused(x, g, st, idx, valid,
                                                alpha, rank_by)
                torch.cuda.synchronize()
                pk, pm = neighbor_rank_fused_ref(x, g, st, idx, valid,
                                                 alpha, rank_by)
                label = (f"neighbor_rank_fused {dt} Q={Q} B={B} D={Dr} "
                         f"{rank_by}")
                err, ratio, n_diff = rank_close(torch, key, mask, pk, pm,
                                                alpha, rank_by, label)
                require(ratio <= 1.0 and n_diff == 0,
                        f"{label}: key {err:.3e}, {n_diff} mask mismatches")
                worst_dt = max(worst_dt, err)
                if dt == "float32":
                    uk, um = neighbor_rank(x, g, st.take(idx.clamp_min(0)),
                                           valid, alpha, rank_by)
                    require(torch.equal(key, uk) and torch.equal(mask, um),
                            f"{label}: differs from neighbor_rank on the "
                            f"gathered rows")
        log(f"neighbor_rank_fused {dt}: {2 * len(RANK_SHAPES)} cases, key "
            f"max_abs_err {worst_dt:.3e}, no mask mismatch away from the "
            f"band edge"
            + (", equal to neighbor_rank bit for bit" if dt == "float32"
               else ""))
        worst = max(worst, worst_dt)
    Q, B = 32, 48
    x = stores["float32"].take(ids_of(Q).clamp_min(0))
    g = deepfm_value_and_grad_ref(x, rows(Q, D), *wb, fm_dim)[1].contiguous()
    idx = ids_of(Q, B)
    valid = (torch.rand((Q, B), generator=gen) < 0.7).to(dev) & (idx >= 0)
    r = report["neighbor_rank_fused"] = {"err": worst, "ms": {},
                                         "plain_ms": {}, "bound": {}}
    for dt, st in stores.items():
        r["ms"][dt] = time_ms(lambda: neighbor_rank_fused(x, g, st, idx,
                                                          valid, alpha))
        r["plain_ms"][dt] = time_ms(lambda: neighbor_rank_fused_ref(
            x, g, st, idx, valid, alpha))
        r["bound"][dt] = bound_ms(*fused_rank_costs(dt, Q, B, D))
    r["host_us"] = host_us(lambda: neighbor_rank_fused(x, g, st8, idx, valid,
                                                       alpha))
    return report


# the MLP networks the MLP kernels are checked at: (label, Dx, Dq, hidden).
# The first is the serving width, make_family_measure('mlp', ..., 40); the
# rest cover one and two hidden layers, mlp_measure's default width (about
# 129 KB of shared memory), Dq != Dx, a backward through two hidden
# layers below the top one, a net with no hidden layer, and widths that
# are not multiples of 4 (the grad kernel's 4-byte copies, zero pads and
# partial slices).
MLP_NETS = (
    ("80-64-64-1", 40, 40, (64, 64)),
    ("80-32-1", 40, 40, (32,)),
    ("80-128-128-1", 40, 40, (128, 128)),
    ("64-64-64-1 (Dq=24)", 40, 24, (64, 64)),
    ("64-48-32-24-1 (Dq=24)", 40, 24, (48, 32, 24)),
    ("80-1", 40, 40, ()),
    ("70-30-17-1 (Dx=37)", 37, 33, (30, 17)),
)

# the DeepFM nets the DeepFM grad pair is checked at: (D, fm, H0, H1). The
# first is the serving measure, make_family_measure('deepfm', ..., 40)
# (configs/guitar_deepfm.py; checked with that measure's weights); the
# rest narrower and unequal hidden widths, widths that are not multiples
# of 4 (the grad kernel's 4-byte copies, zero pads and partial slices), a
# wide and a narrow net.
DEEPFM_NETS = (
    (40, 8, 64, 64),
    (40, 8, 32, 32),
    (40, 8, 64, 16),
    (37, 5, 30, 18),
    (72, 8, 128, 128),
    (16, 8, 8, 8),
)


# DeepFM nets (D, fm, H0, H1) whose cluster plan does not fit a CTA: the
# score's plan stages the tile's x[:fm] and q[:fm] beside the deep part,
# the grad's the W slices of two 512-wide layers
DEEPFM_SCORE_REFUSED = (2485, 1008, 1, 556)
DEEPFM_GRAD_REFUSED = (40, 8, 512, 512)


def check_deepfm_refusals(torch, dev) -> None:
    """Each of the four DeepFM wrappers, given a net its cluster plan
    cannot place, raises before any launch the ValueError that names the
    generic stages, not the C launcher's bare CUDA error."""
    from repro_torch.core import make_corpus_store
    from repro_torch.kernels import (deepfm_grad_fused, deepfm_score,
                                     deepfm_score_fused,
                                     deepfm_value_and_grad, launch_counts)
    gen = torch.Generator(device="cpu").manual_seed(246)
    before = launch_counts()
    calls = {}
    for pair, (D, fm, H0, H1) in (("score", DEEPFM_SCORE_REFUSED),
                                  ("grad", DEEPFM_GRAD_REFUSED)):
        mlp = random_mlp(torch, dev, 2 * (D - fm), (H0, H1), gen)
        c = torch.randn((8, D), generator=gen).to(dev)
        store = make_corpus_store(torch.randn((16, D), generator=gen),
                                  "int8", device=dev)
        idx = torch.arange(8, device=dev)
        unfused, fused = ((deepfm_score, deepfm_score_fused) if pair ==
                          "score" else (deepfm_value_and_grad,
                                        deepfm_grad_fused))
        calls[unfused.__name__] = (unfused, (c, c, mlp, fm))
        calls[fused.__name__] = (fused, (store, idx, c, mlp, fm))
    for name, (fn, args) in calls.items():
        try:
            fn(*args)
        except ValueError as e:
            require("measure_impl='vmap'" in str(e), f"{name}: refused "
                    f"without naming the generic stages: {e}")
        else:
            raise SmokeFailure(f"{name}: a net its plan cannot place was "
                               f"not refused")
    require(launch_counts() == before, "a refused DeepFM call launched")
    nets = ["D={} fm={} {}x{}".format(*n)
            for n in (DEEPFM_SCORE_REFUSED, DEEPFM_GRAD_REFUSED)]
    log(f"deepfm kernels: {', '.join(calls)} refuse {nets[0]} (score) and "
        f"{nets[1]} (grad) before any launch, naming EngineOptions("
        f"measure_impl='vmap', grad_impl='vmap')")


def mlp_costs(M, Dx, Dq, dims, per_row_query, grad):
    """Bytes (each input read once, each output written once) and FLOPs
    of one MLP kernel call over M rows; dims = [Dx + Dq, ..., 1]."""
    L = len(dims) - 1
    weights = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(L))
    rows_in = M * Dx + (M * Dq if per_row_query else Dq)
    rows_out = M + (M * Dx if grad else 0)
    nbytes = 4 * (rows_in + weights + rows_out)
    hidden = dims[1:L]
    fwd = sum(2 * dims[i] * dims[i + 1] + dims[i + 1] for i in range(L)) \
        + sum(hidden) + 4
    if L == 1:
        bwd = 2 + Dx
    else:
        bwd = 2 + dims[L - 1] + sum(2 * dims[i] * dims[i + 1] + dims[i]
                                    for i in range(1, L - 1)) \
            + 2 * Dx * dims[1]
    return nbytes, M * (fwd + (bwd if grad else 0))


def fused_mlp_costs(dtype, M, Dx, Dq, dims, per_row_query, grad):
    """mlp_costs with the rows read from the corpus in residency format by
    int64 id, the x rows the grad form writes, and the int8 dequant."""
    nbytes, flops = mlp_costs(M, Dx, Dq, dims, per_row_query, grad)
    nbytes += M * (row_bytes(dtype, Dx) - 4 * Dx) + 8 * M
    nbytes += 4 * M * Dx if grad else 0
    flops += M * Dx if dtype == "int8" else 0
    return nbytes, flops


def random_mlp(torch, dev, d_in, hidden, gen):
    """An MLP of the measure's init (``init_mlp``) with non-zero biases,
    so the checks exercise every bias path."""
    from repro_torch.models.layers import init_mlp
    p = init_mlp(gen, [d_in, *hidden, 1], device="cpu")
    p["b"] = [0.1 * torch.randn(b.shape, generator=gen) for b in p["b"]]
    return {k: [t.to(dev) for t in v] for k, v in p.items()}


# the frontier sizes the grad pairs are checked at (their clusters take
# tiles of 4 rows): the serving Q, a small one with a ragged tile, many
# tiles with a ragged last one, and a large one
GRAD_QS = (32, 7, 77, 256)


def check_deepfm_grad_nets(torch, dev, serving_mlp, fm_dim, fused):
    """deepfm_grad (or, ``fused``, deepfm_grad_fused) against its plain
    version at every net of DEEPFM_NETS (the serving one with the
    measure's weights ``serving_mlp``, the rest random), the Q of GRAD_QS
    and both query forms; the fused form at each residency with -1 ids,
    ``x`` equal to ``CorpusStore.take``, and at float32 bit for bit
    against deepfm_grad on the gathered rows. Returns the largest error
    and each net's."""
    from repro_torch.core import make_corpus_store
    from repro_torch.kernels import deepfm_grad_fused, deepfm_value_and_grad
    from repro_torch.kernels.deepfm_grad.ref import deepfm_value_and_grad_ref
    from repro_torch.kernels.deepfm_grad_fused.ref import \
        deepfm_grad_fused_ref

    N = 5000
    gen = torch.Generator(device="cpu").manual_seed(789 + int(fused))
    name = "deepfm_grad_fused" if fused else "deepfm_grad"
    require(DEEPFM_NETS[0][1] == fm_dim, "the serving net's fm")

    def rows(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def ids_of(M):
        i = torch.randint(0, N, (M,), generator=gen)
        i[::13] = -1                          # padding, clamped in-kernel
        return i.to(dev)

    worst, by_net = 0.0, {}
    for D, fm, H0, H1 in DEEPFM_NETS:
        label = f"D={D} fm={fm} {H0}x{H1}"
        mlp = serving_mlp if (D, fm, H0, H1) == DEEPFM_NETS[0] else \
            random_mlp(torch, dev, 2 * (D - fm), (H0, H1), gen)
        wb = [t for pair in zip(mlp["w"], mlp["b"]) for t in pair]
        stores = {"float32": None}
        if fused:
            base = torch.randn((N, D), generator=gen)
            stores = {dt: make_corpus_store(base, dt, device=dev)
                      for dt in RESIDENCIES}
        n_cases, worst_net = 0, 0.0
        for dt, store in stores.items():
            for M in GRAD_QS:
                for shared in (False, True):
                    q = rows(D) if shared else rows(M, D)
                    tag = f"{name} {label} {dt} M={M} shared={shared}"
                    if fused:
                        idx = ids_of(M)
                        v, g, x = deepfm_grad_fused(store, idx, q, mlp, fm)
                        torch.cuda.synchronize()
                        pv, pg, px = deepfm_grad_fused_ref(store, idx, q,
                                                           *wb, fm)
                        require(torch.equal(x, px), f"{tag}: x differs from "
                                f"CorpusStore.take")
                    else:
                        c = rows(M, D)
                        v, g = deepfm_value_and_grad(c, q, mlp, fm)
                        torch.cuda.synchronize()
                        pv, pg = deepfm_value_and_grad_ref(
                            c, q.expand(M, -1) if shared else q, *wb, fm)
                    ev, rv = close_err(v, pv, SCORE_RTOL, SCORE_ATOL)
                    eg, rg = close_err(g, pg, GRAD_RTOL, GRAD_ATOL)
                    require(rv <= 1.0 and rg <= 1.0,
                            f"{tag}: vals {ev:.3e} grads {eg:.3e}")
                    worst_net = max(worst_net, ev, eg)
                    if fused and dt == "float32":
                        uv, ug = deepfm_value_and_grad(px, q, mlp, fm)
                        require(torch.equal(v, uv) and torch.equal(g, ug),
                                f"{tag}: differs from deepfm_grad on the "
                                f"gathered rows")
                    n_cases += 1
        log(f"{name} {label}: {n_cases} cases match the plain version, "
            f"max_abs_err {worst_net:.3e}" + (
                "; x equal to CorpusStore.take, equal to deepfm_grad bit "
                "for bit at float32" if fused else ""))
        worst = max(worst, worst_net)
        by_net[label] = worst_net
    return worst, by_net


def deepfm_score_plan_on_card(net) -> dict:
    """The plan the DeepFM score kernels launch for ``net`` = (D, fm, H0,
    H1) on the card (``deepfm_score_plan_info``): rows and CTAs per
    cluster, shared memory per CTA, ``cudaOccupancyMaxActiveClusters`` of
    the kernel, and whether the copy compiled for the serving widths runs
    it."""
    import ctypes
    from repro_torch.kernels import _lib
    info = (ctypes.c_int * 5)()
    _lib.check(_lib.load().deepfm_score_plan_info(*net, info),
               "deepfm_score_plan_info")
    return dict(zip(("rows", "ctas", "smem_bytes", "max_active_clusters",
                     "serving_widths"), info))


def check_deepfm_score_nets(torch, dev, serving_mlp, fm_dim, fused):
    """deepfm_score (or, ``fused``, deepfm_score_fused) against its plain
    version at every net of DEEPFM_NETS (the serving one with the
    measure's weights ``serving_mlp``, the rest random) and both query
    forms: the score at M = 256, 512, 77, 1 and 8 tiles of its plan and 3
    rows; the fused form at each residency with -1 ids, with and without
    a prefix mask, at M = 512 also with every row masked (all -inf), and
    at float32 bit for bit against deepfm_score on the gathered rows. The
    card's plans must equal ``deepfm_score_plan``'s, the serving net's run
    by the copy compiled for its widths. Returns the largest error, each
    net's, and each net's plan on the card."""
    from repro_torch.core import make_corpus_store
    from repro_torch.kernels import deepfm_score, deepfm_score_fused
    from repro_torch.kernels.deepfm_score.ops import deepfm_score_plan
    from repro_torch.kernels.deepfm_score.ref import deepfm_score_ref
    from repro_torch.kernels.deepfm_score_fused.ref import \
        deepfm_score_fused_ref

    N = 5000
    gen = torch.Generator(device="cpu").manual_seed(987 + int(fused))
    name = "deepfm_score_fused" if fused else "deepfm_score"
    neg_inf = float("-inf")
    require(DEEPFM_NETS[0][1] == fm_dim, "the serving net's fm")
    plans = {net: deepfm_score_plan_on_card(net) for net in DEEPFM_NETS}
    for net, p in plans.items():             # the CPU tests' mirror
        m = deepfm_score_plan(*net)
        require(m is not None and (p["rows"], p["ctas"], p["smem_bytes"]) ==
                (m["rows"], m["n"], m["smem_bytes"]), f"deepfm_score {net}: "
                f"the plan {p} differs from kernels/deepfm_score/ops.py's {m}")
        require(p["serving_widths"] == int(net == DEEPFM_NETS[0]),
                f"deepfm_score {net}: serving widths {p['serving_widths']}")
    if not fused:
        log("deepfm_score plans (rows x CTAs per cluster, shared memory per "
            "CTA, cudaOccupancyMaxActiveClusters, copy): " + "; ".join(
                f"D={D} fm={fm} {H0}x{H1} {p['rows']} x {p['ctas']}, "
                f"{p['smem_bytes']} B, {p['max_active_clusters']}, "
                + ("DeepFMScoreServing" if p["serving_widths"]
                   else "run-time widths")
                for (D, fm, H0, H1), p in plans.items()))

    def rows(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def ids_of(M):
        i = torch.randint(0, N, (M,), generator=gen)
        i[::13] = -1                          # padding, clamped in-kernel
        return i.to(dev)

    worst, by_net = 0.0, {}
    for D, fm, H0, H1 in DEEPFM_NETS:
        label = f"D={D} fm={fm} {H0}x{H1}"
        mlp = serving_mlp if (D, fm, H0, H1) == DEEPFM_NETS[0] else \
            random_mlp(torch, dev, 2 * (D - fm), (H0, H1), gen)
        wb = [t for pair in zip(mlp["w"], mlp["b"]) for t in pair]
        ragged = 8 * plans[(D, fm, H0, H1)]["rows"] + 3
        Ms = ((256, 8), (512, 16), (77, None), (1, None), (ragged, None))
        stores = {"float32": None}
        if fused:
            base = torch.randn((N, D), generator=gen)
            stores = {dt: make_corpus_store(base, dt, device=dev)
                      for dt in RESIDENCIES}
        n_cases, worst_net = 0, 0.0
        for dt, store in stores.items():
            for M, C in Ms:
                for shared in (False, True):
                    for masked in ((False, True) if fused else (False,)):
                        q = rows(D) if shared else rows(M, D)
                        tag = (f"{name} {label} {dt} M={M} shared={shared}"
                               f" masked={masked}")
                        if not fused:
                            c = rows(M, D)
                            got = deepfm_score(c, q, mlp, fm)
                            torch.cuda.synchronize()
                            want = deepfm_score_ref(
                                c, q.expand(M, -1) if shared else q, *wb, fm)
                        else:
                            idx, mask = ids_of(M), None
                            if masked:
                                mask = (prefix_mask(torch, M // C, C, gen)
                                        if C else
                                        torch.rand(M, generator=gen) < 0.5)
                                mask = mask.to(dev)
                            got = deepfm_score_fused(store, idx, q, mlp, fm,
                                                     mask=mask)
                            torch.cuda.synchronize()
                            want = deepfm_score_fused_ref(store, idx, q, *wb,
                                                          fm, mask)
                            if dt == "float32":
                                unf = deepfm_score(store.take(
                                    idx.clamp_min(0)), q, mlp, fm)
                                if mask is not None:
                                    unf = unf.masked_fill(~mask, neg_inf)
                                require(torch.equal(got, unf), f"{tag}: "
                                        f"differs from deepfm_score on the "
                                        f"gathered rows")
                        require(torch.equal(torch.isneginf(got),
                                            torch.isneginf(want)),
                                f"{tag}: masked rows differ")
                        fin = torch.isfinite(want)
                        if bool(fin.any()):
                            err, ratio = close_err(got[fin], want[fin],
                                                   SCORE_RTOL, SCORE_ATOL)
                            require(ratio <= 1.0, f"{tag}: {err:.3e}")
                            worst_net = max(worst_net, err)
                        n_cases += 1
            if fused:    # every row masked: every tile skipped, all -inf
                got = deepfm_score_fused(
                    store, ids_of(512), rows(512, D), mlp, fm,
                    mask=torch.zeros(512, dtype=torch.bool, device=dev))
                torch.cuda.synchronize()
                require(bool(torch.isneginf(got).all()),
                        f"{name} {label} {dt} M=512 all masked: "
                        f"{int((~torch.isneginf(got)).sum())} rows not -inf")
                n_cases += 1
        log(f"{name} {label}: {n_cases} cases match the plain version, "
            f"max_abs_err {worst_net:.3e}" + (
                "; all-masked tiles -inf, equal to deepfm_score bit for bit "
                "at float32" if fused else ""))
        worst = max(worst, worst_net)
        by_net[label] = worst_net
    return worst, by_net, plans


def score_plan_on_card(dims, d_x) -> dict:
    """The plan the MLP score kernels launch at widths ``dims`` on the card
    (``mlp_score_plan_info``): rows and CTAs per cluster, shared memory per
    CTA and ``cudaOccupancyMaxActiveClusters`` of the kernel."""
    import ctypes
    from repro_torch.kernels import _lib
    L = len(dims) - 1
    info = (ctypes.c_int * 4)()
    _lib.check(_lib.load().mlp_score_plan_info(
        (ctypes.c_int * (L + 1))(*dims), L, d_x, dims[0] - d_x, info),
        "mlp_score_plan_info")
    return dict(zip(("rows", "ctas", "smem_bytes", "max_active_clusters"),
                    info))


def check_mlp_kernels(torch, dev):
    """The four MLP kernels against their plain versions at every net of
    MLP_NETS: mlp_score at M = 256, 512, 77, 1 and 8 tiles of its plan and
    3 rows, and mlp_grad at the Q of GRAD_QS, both query forms; the fused
    pair at each residency (with and without a prefix mask, -1 ids; the
    score at M = 512 also with every row masked, all -inf), ``x`` of the
    grad form equal to ``CorpusStore.take``, and at float32 bit for bit
    against the pre-gathered pair on the gathered rows. Times each at the
    serving net and shape."""
    from repro_torch.core import make_corpus_store
    from repro_torch.kernels import (mlp_grad_fused, mlp_score,
                                     mlp_score_fused, mlp_value_and_grad)
    from repro_torch.kernels.mlp_grad.ops import mlp_score_plan
    from repro_torch.kernels.mlp_grad.ref import mlp_value_and_grad_ref
    from repro_torch.kernels.mlp_grad_fused.ref import mlp_grad_fused_ref
    from repro_torch.kernels.mlp_score.ops import mlp_dims
    from repro_torch.kernels.mlp_score.ref import mlp_score_ref
    from repro_torch.kernels.mlp_score_fused.ref import mlp_score_fused_ref

    N = 5000
    gen = torch.Generator(device="cpu").manual_seed(456)
    # the score's ragged and all-masked cases draw from their own stream,
    # so every other case keeps its inputs
    extra = torch.Generator(device="cpu").manual_seed(457)
    neg_inf = float("-inf")

    def rows(*shape, g=gen):
        return torch.randn(shape, generator=g).to(dev)

    def ids_of(*shape, g=gen):
        i = torch.randint(0, N, shape, generator=g)
        i.view(-1)[::13] = -1                 # padding, clamped in-kernel
        return i.to(dev)

    def expand(q, M):
        return q.expand(M, -1) if q.dim() == 1 else q

    worst = {k: 0.0 for k in ("mlp_score", "mlp_grad", "mlp_score_fused",
                              "mlp_grad_fused")}
    by_net = {k: {} for k in worst}     # each kernel's largest error per net

    def note(kernel, label, *errs):
        worst[kernel] = max(worst[kernel], *errs)
        by_net[kernel][label] = max(by_net[kernel].get(label, 0.0), *errs)

    plans = {label: score_plan_on_card([Dx + Dq, *hidden, 1], Dx)
             for label, Dx, Dq, hidden in MLP_NETS}
    for label, Dx, Dq, hidden in MLP_NETS:     # the CPU tests' mirror
        p, m = plans[label], mlp_score_plan([Dx + Dq, *hidden, 1], Dx)
        require((p["rows"], p["ctas"], p["smem_bytes"]) == (
            m["rows"], m["n"], m["smem_bytes"]), f"mlp_score {label}: the "
            f"plan {p} differs from kernels/mlp_grad/ops.py's {m}")
    log("mlp_score plans (rows x CTAs per cluster, shared memory per CTA, "
        "cudaOccupancyMaxActiveClusters): " + "; ".join(
            f"{label} {p['rows']} x {p['ctas']}, {p['smem_bytes']} B, "
            f"{p['max_active_clusters']}" for label, p in plans.items()))
    serving = None
    for label, Dx, Dq, hidden in MLP_NETS:
        # a ragged M: 8 tiles of the net's plan and 3 rows
        ragged = 8 * plans[label]["rows"] + 3
        net = random_mlp(torch, dev, Dx + Dq, hidden, gen)
        w, b = net["w"], net["b"]
        base = torch.randn((N, Dx), generator=gen)
        stores = {dt: make_corpus_store(base, dt, device=dev)
                  for dt in RESIDENCIES}
        if serving is None:
            serving = (net, Dx, Dq, stores)
        n_cases = 0
        # -- mlp_score: M = Q*C = 256 (C = 8), 512 (adaptive c_max = 16),
        #    ragged Ms, one row
        for M in (256, 512, 77, 1, ragged):
            g = extra if M == ragged else gen
            for shared in (False, True):
                c = rows(M, Dx, g=g)
                q = rows(Dq, g=g) if shared else rows(M, Dq, g=g)
                got = mlp_score(c, q, net)
                torch.cuda.synchronize()
                err, ratio = close_err(got, mlp_score_ref(c, expand(q, M), w,
                                                          b),
                                       SCORE_RTOL, SCORE_ATOL)
                require(ratio <= 1.0, f"mlp_score {label} M={M} shared="
                        f"{shared}: {err:.3e}")
                note("mlp_score", label, err)
                n_cases += 1
        # -- mlp_grad: the frontier sizes of GRAD_QS
        for M in GRAD_QS:
            for shared in (False, True):
                c, q = rows(M, Dx), (rows(Dq) if shared else rows(M, Dq))
                v, g = mlp_value_and_grad(c, q, net)
                torch.cuda.synchronize()
                pv, pg = mlp_value_and_grad_ref(c, expand(q, M), w, b)
                ev, rv = close_err(v, pv, SCORE_RTOL, SCORE_ATOL)
                eg, rg = close_err(g, pg, GRAD_RTOL, GRAD_ATOL)
                require(rv <= 1.0 and rg <= 1.0, f"mlp_grad {label} M={M} "
                        f"shared={shared}: vals {ev:.3e} grads {eg:.3e}")
                note("mlp_grad", label, ev, eg)
                n_cases += 1
        for dt, store in stores.items():
            # -- mlp_score_fused: the same shapes, masked and not
            for M, C in ((256, 8), (512, 16), (77, None), (1, None),
                         (ragged, None)):
                g = extra if M == ragged else gen
                for shared in (False, True):
                    for masked in (False, True):
                        idx = ids_of(M, g=g)
                        q = rows(Dq, g=g) if shared else rows(M, Dq, g=g)
                        mask = None
                        if masked:
                            mask = (prefix_mask(torch, M // C, C, g) if C
                                    else torch.rand(M, generator=g) < 0.5)
                            mask = mask.to(dev)
                        got = mlp_score_fused(store, idx, q, net, mask=mask)
                        torch.cuda.synchronize()
                        want = mlp_score_fused_ref(store, idx, q, w, b, mask)
                        tag = (f"mlp_score_fused {label} {dt} M={M} shared="
                               f"{shared} masked={masked}")
                        require(torch.equal(torch.isneginf(got),
                                            torch.isneginf(want)),
                                f"{tag}: masked rows differ")
                        fin = torch.isfinite(want)
                        if bool(fin.any()):
                            err, ratio = close_err(got[fin], want[fin],
                                                   SCORE_RTOL, SCORE_ATOL)
                            require(ratio <= 1.0, f"{tag}: {err:.3e}")
                            note("mlp_score_fused", label, err)
                        if dt == "float32":
                            unf = mlp_score(store.take(idx.clamp_min(0)), q,
                                            net)
                            if mask is not None:
                                unf = unf.masked_fill(~mask, neg_inf)
                            require(torch.equal(got, unf), f"{tag}: differs "
                                    f"from mlp_score on the gathered rows")
                        n_cases += 1
            # every row masked: every tile skipped, all -inf
            got = mlp_score_fused(store, ids_of(512, g=extra),
                                  rows(512, Dq, g=extra), net,
                                  mask=torch.zeros(512, dtype=torch.bool,
                                                   device=dev))
            torch.cuda.synchronize()
            require(bool(torch.isneginf(got).all()),
                    f"mlp_score_fused {label} {dt} M=512 all masked: "
                    f"{int((~torch.isneginf(got)).sum())} rows not -inf")
            n_cases += 1
            # -- mlp_grad_fused: the same Q
            for M in GRAD_QS:
                for shared in (False, True):
                    idx = ids_of(M)
                    q = rows(Dq) if shared else rows(M, Dq)
                    v, g, x = mlp_grad_fused(store, idx, q, net)
                    torch.cuda.synchronize()
                    pv, pg, px = mlp_grad_fused_ref(store, idx, q, w, b)
                    tag = f"mlp_grad_fused {label} {dt} M={M} shared={shared}"
                    require(torch.equal(x, px), f"{tag}: x differs from "
                            f"CorpusStore.take")
                    ev, rv = close_err(v, pv, SCORE_RTOL, SCORE_ATOL)
                    eg, rg = close_err(g, pg, GRAD_RTOL, GRAD_ATOL)
                    require(rv <= 1.0 and rg <= 1.0,
                            f"{tag}: vals {ev:.3e} grads {eg:.3e}")
                    note("mlp_grad_fused", label, ev, eg)
                    if dt == "float32":
                        uv, ug = mlp_value_and_grad(px, q, net)
                        require(torch.equal(v, uv) and torch.equal(g, ug),
                                f"{tag}: differs from mlp_grad on the "
                                f"gathered rows")
                    n_cases += 1
        log(f"mlp kernels {label}: {n_cases} cases match their plain "
            f"versions; the fused pair equals the pre-gathered pair bit for "
            f"bit at float32, x equal to CorpusStore.take; max_abs_err "
            + ", ".join(f"{k} {by_net[k].get(label, 0.0):.3e}"
                        for k in by_net))
    # a network deeper than the kernels take, or too wide for the card's
    # shared memory, is refused with the way to the generic stages
    c, q = rows(8, 40), rows(8, 40)
    for label, hidden in (("9 layers", (16,) * 8), ("80-256-256-1", (256,
                                                                     256))):
        try:
            mlp_score(c, q, random_mlp(torch, dev, 80, hidden, gen))
        except ValueError as e:
            require("measure_impl='vmap'" in str(e),
                    f"mlp_score {label}: refused without naming the generic "
                    f"stages: {e}")
        else:
            raise SmokeFailure(f"mlp_score {label}: not refused")
    log("mlp kernels: a 9-layer and an 80-256-256-1 network are refused, "
        "naming EngineOptions(measure_impl='vmap', grad_impl='vmap')")

    # timing at the serving net: M = 256 candidates, Q = 32 frontier rows,
    # per-row queries (the engine's qs_flat)
    net, Dx, Dq, stores = serving
    w, b = net["w"], net["b"]
    dims = mlp_dims(w)
    report = {}
    c, q = rows(256, Dx), rows(256, Dq)
    report["mlp_score"] = dict(
        plan=plans[MLP_NETS[0][0]],
        err=worst["mlp_score"], ms=time_ms(lambda: mlp_score(c, q, net)),
        plain_ms=time_ms(lambda: mlp_score_ref(c, q, w, b)),
        host_us=host_us(lambda: mlp_score(c, q, net)),
        bound=bound_ms(*mlp_costs(256, Dx, Dq, dims, True, False)))
    cg, qg = rows(32, Dx), rows(32, Dq)
    report["mlp_grad"] = dict(
        err=worst["mlp_grad"], err_by_net=by_net["mlp_grad"],
        ms=time_ms(lambda: mlp_value_and_grad(cg, qg, net)),
        plain_ms=time_ms(lambda: mlp_value_and_grad_ref(cg, qg, w, b)),
        host_us=host_us(lambda: mlp_value_and_grad(cg, qg, net)),
        bound=bound_ms(*mlp_costs(32, Dx, Dq, dims, True, True)))
    idx = ids_of(256)
    r = report["mlp_score_fused"] = {"err": worst["mlp_score_fused"],
                                     "ms": {}, "plain_ms": {}, "bound": {}}
    for dt, st in stores.items():
        r["ms"][dt] = time_ms(lambda: mlp_score_fused(st, idx, q, net))
        r["plain_ms"][dt] = time_ms(lambda: mlp_score_fused_ref(st, idx, q,
                                                                w, b))
        r["bound"][dt] = bound_ms(*fused_mlp_costs(dt, 256, Dx, Dq, dims,
                                                   True, False))
    st8 = stores["int8"]
    r["host_us"] = host_us(lambda: mlp_score_fused(st8, idx, q, net))
    idx_a, q_a = ids_of(512), rows(512, Dq)
    mask_a = prefix_mask(torch, 32, 16, gen).to(dev)
    r["adaptive_int8"] = {
        "M": 512, "live_rows": int(mask_a.sum()),
        "ms": time_ms(lambda: mlp_score_fused(st8, idx_a, q_a, net,
                                              mask=mask_a)),
        "ms_unmasked": time_ms(lambda: mlp_score_fused(st8, idx_a, q_a,
                                                       net))}
    idx = ids_of(32)
    r = report["mlp_grad_fused"] = {"err": worst["mlp_grad_fused"],
                                    "err_by_net": by_net["mlp_grad_fused"],
                                    "ms": {}, "plain_ms": {}, "bound": {}}
    for dt, st in stores.items():
        r["ms"][dt] = time_ms(lambda: mlp_grad_fused(st, idx, qg, net))
        r["plain_ms"][dt] = time_ms(lambda: mlp_grad_fused_ref(st, idx, qg,
                                                               w, b))
        r["bound"][dt] = bound_ms(*fused_mlp_costs(dt, 32, Dx, Dq, dims,
                                                   True, True))
    r["host_us"] = host_us(lambda: mlp_grad_fused(st8, idx, qg, net))
    return report


# ---------------------------------------------------------------------------
# phase 3b: the library kernels (embedding_bag, decode_attn, flash_attn)
# ---------------------------------------------------------------------------

# kernel-vs-plain tolerances of the library kernels on the card. The bag
# sums slot by slot in float32 with product and add rounded separately,
# as its plain version does, so the two should agree to the bit in float32
# and after the one rounding to bf16; the tolerance allows one bf16 step.
# Attention: both sides compute in float32 from the same inputs, in
# another order (FMA chains and a chunk merge vs cuBLAS and softmax) over
# up to 524,288 positions.
BAG_TOL = {"float32": (1e-6, 1e-6), "bfloat16": (2.0 ** -7, 1e-6)}
ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-5

# Yi-9B (src/repro/configs/yi_9b.py) attention widths; LM_SHAPES lengths
YI_H, YI_KV, YI_HD = 32, 4, 128
# DLRM-RM2 (src/repro/configs/dlrm_rm2.py): 26 Criteo fields, one table of
# pad_vocab(sum of cardinalities) rows, embed dim 64
DLRM_D = 64
PAD_FRACTION = 0.05         # ids set to -1 (padding) in the bag inputs
BAG_ID_SETS = 64            # serve_p99 id sets the timed calls cycle through


def event_ms(fn, reps: int = 3, warm: int = 1) -> float:
    """Device time of one call for calls of a millisecond or more: ``warm``
    calls, then ``reps`` eager calls between two CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bag_costs(B, L, d, n_valid, n_rows, esize, idx_size, weighted):
    """Bytes: ids (and weights) read once, each distinct row the valid ids
    name read once (``n_rows``: ids repeat within the small Criteo fields),
    the (B, d) sums written once; FLOPs: one multiply-add per element of
    each of the ``n_valid`` valid ids."""
    nbytes = B * L * idx_size + (B * L * esize if weighted else 0) \
        + n_rows * d * esize + B * d * esize
    return nbytes, 2 * n_valid * d


def decode_costs(B, H, KV, hd, n, esize, qsize):
    """The valid prefix of K and V read once, q read and the float32 output
    written once; two products of 2 * hd FLOPs per (head, position)."""
    nbytes = B * H * hd * qsize + 2 * B * n * KV * hd * esize \
        + B * H * hd * 4
    return nbytes, 4 * B * H * n * hd


def flash_costs(B, S, H, hd, esize):
    """q, k, v read once, the float32 output written once; 4 * hd FLOPs per
    causal (query, key) pair."""
    nbytes = 3 * B * S * H * hd * esize + B * S * H * hd * 4
    return nbytes, 4 * B * H * hd * (S * (S + 1) // 2)


def drive_segment(torch, label, name, calls, expect, path=None):
    """One segment of the slice's main path: every launch count set to 0,
    ``calls`` run through the public wrapper, the counts read; the segment
    must launch ``name`` ``expect`` times and no other kernel, and with
    ``path`` every one of those launches must have taken that kernel
    (``"tensor_core"`` or ``"cuda_core"``)."""
    from repro_torch.kernels import (launch_counts, path_launch_counts,
                                     reset_launch_counts)
    reset_launch_counts()
    out = calls()
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"library {label}: kernel launches in the main-path run: "
        f"{ {k: v for k, v in counts.items() if v} }")
    for k, n in counts.items():
        require(n == (expect if k == name else 0),
                f"library {label}: kernel {k} launched {n} times; the "
                f"segment launches {name} {expect} times and nothing else")
    if path is not None:
        paths = path_launch_counts()[name]
        log(f"library {label}: {name} launches by path: {paths}")
        require(paths == {p: (expect if p == path else 0) for p in paths},
                f"library {label}: {name} launches by path {paths}; every "
                f"launch of the segment must take the {path} kernel")
    return out, counts[name]


def check_library_bag(torch, dev, report):
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models.layers import pad_vocab
    from repro_torch.models.recsys import CRITEO_CARDINALITIES, field_offsets
    gen = torch.Generator(device="cpu").manual_seed(11)
    worst = 0.0

    def close_bag(got, want, dt, label):
        nonlocal worst
        require(got.dtype == want.dtype and got.shape == want.shape,
                f"{label}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
                f"{tuple(want.shape)}")
        err, ratio = close_err(got.float(), want.float(), *BAG_TOL[dt])
        require(ratio <= 1.0, f"{label}: max_abs_err {err:.3e}")
        worst = max(worst, err)
        return err, bool(torch.equal(got, want))

    # -- the JAX test shapes (tests/test_kernels.py:83), the smoke width of
    #    DLRM-RM2 (26 x 50 rows, d = 8) and the edges
    n_cases, n_equal = 0, 0
    for r, d, b, l in ((100, 16, 8, 4), (500, 64, 33, 8), (64, 128, 16, 2),
                       (1300, 8, 26, 3)):
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            table = torch.randn((r, d), generator=gen).to(dev, tdt)
            idx = torch.randint(-1, r, (b, l), generator=gen,
                                dtype=torch.int32)
            w = torch.rand((b, l), generator=gen).to(dev, tdt)
            edge = idx.clone().long()
            edge[:, 0] = r                                  # out of range
            edge[0] = -1                                    # an empty bag
            edge[-1, -1] = -7                               # out of range
            for ids, ww in ((idx.to(dev), w), (idx.to(dev), None),
                            (edge.to(dev), w)):
                got = embedding_bag(table, ids, ww)
                torch.cuda.synchronize()
                _, eq = close_bag(got, embedding_bag_ref(table, ids, ww), dt,
                                  f"embedding_bag {dt} R={r} d={d} B={b} "
                                  f"L={l} ids {ids.dtype}")
                n_cases, n_equal = n_cases + 1, n_equal + eq
    log(f"embedding_bag: {n_cases} cases at the JAX test shapes and edges "
        f"(no weights, int64 ids, ids outside [-1, R), an empty bag) match "
        f"the plain version, {n_equal} bit for bit")

    # -- DLRM-RM2: one table of pad_vocab(sum(cardinalities)) x 64 rows
    card = torch.tensor(CRITEO_CARDINALITIES, dtype=torch.int64)
    offs = torch.from_numpy(field_offsets(CRITEO_CARDINALITIES)).long()
    R = pad_vocab(int(card.sum()))
    tables = {"float32": torch.randn(
        (R, DLRM_D), device=dev,
        generator=torch.Generator(device=dev).manual_seed(12))}
    tables["bfloat16"] = tables["float32"].to(torch.bfloat16)
    log(f"embedding_bag: DLRM-RM2 table {R} x {DLRM_D} resident in float32 "
        f"({tables['float32'].nbytes / 1e9:.2f} GB) and bfloat16 "
        f"({tables['bfloat16'].nbytes / 1e9:.2f} GB)")

    def ids_of(batch, L):
        """(batch * 26, L) int32 ids, each uniform in its field's range,
        PAD_FRACTION of them -1."""
        u = torch.rand((batch, 26, L), generator=gen, dtype=torch.float64)
        ids = (u * card[None, :, None]).long().clamp_max(
            card[None, :, None] - 1) + offs[None, :, None]
        ids[torch.rand(ids.shape, generator=gen) < PAD_FRACTION] = -1
        return ids.reshape(batch * 26, L).to(torch.int32).to(dev)

    shapes = {"serve_p99 L=1": (512, 1), "serve_p99 L=8": (512, 8),
              "train_batch L=1": (65536, 1)}
    inputs = {}
    for label, (batch, L) in shapes.items():
        ids = ids_of(batch, L)
        w = torch.rand(ids.shape, generator=gen).to(dev)
        inputs[label] = (ids, w)
        for dt, table in tables.items():
            wt = w.to(table.dtype)
            got = embedding_bag(table, ids, wt)
            torch.cuda.synchronize()
            err, eq = close_bag(got, embedding_bag_ref(table, ids, wt), dt,
                                f"embedding_bag DLRM-RM2 {label} {dt}")
            log(f"embedding_bag DLRM-RM2 {label} {dt} ({ids.shape[0]} "
                f"bags): max_abs_err {err:.3e}, equal bit for bit: {eq}")

    # -- the main path: the DLRM lookups at serve_p99 and train_batch
    def lookups():
        return [embedding_bag(t, ids, w.to(t.dtype))
                for ids, w in inputs.values() for t in tables.values()]
    _, launches = drive_segment(torch, "DLRM-RM2 lookups", "embedding_bag",
                                lookups, 2 * len(inputs))

    # -- times: kernel, plain version, F.embedding_bag (-1 mapped to row 0
    #    with weight 0, ids as int64; prepared outside the timed region).
    #    A serve_p99 call reads 1.6-26 MB of rows, inside the 50 MB L2, so
    #    one timed replay cycles through BAG_ID_SETS fresh id sets (at
    #    least 100 MB of rows), and the rows come from device memory as a
    #    server's would.
    r = report["embedding_bag"] = {"launches": launches, "shapes": {}}
    for label, (ids, w) in inputs.items():
        B, L = ids.shape
        batch = shapes[label][0]
        sets = [(ids, w)] + [(ids_of(batch, L), w)
                             for _ in range(BAG_ID_SETS - 1)] \
            if B < 100_000 else [(ids, w)]
        n_valid = sum(int((i >= 0).sum()) for i, _ in sets) / len(sets)
        n_rows = sum(int(torch.unique(i[i >= 0]).numel())
                     for i, _ in sets) / len(sets)
        for dt, table in tables.items():
            args = [(i, ww.to(table.dtype)) for i, ww in sets]
            lib_args = [(i.clamp_min(0).long(),
                         torch.where(i >= 0, ww, torch.zeros_like(ww)))
                        for i, ww in args]
            timer = (lambda f: time_ms(f, reps=len(sets))) \
                if len(sets) > 1 else (lambda f: event_ms(f, reps=20))
            turn = itertools.count()

            def cycled(fn, argl):
                return lambda: fn(*argl[next(turn) % len(argl)])
            r["shapes"][f"{label} {dt}"] = dict(
                bags=B, L=L, valid_ids=n_valid, distinct_rows=n_rows,
                id_sets=len(sets),
                ms=timer(cycled(lambda i, ww: embedding_bag(table, i, ww),
                                args)),
                plain_ms=timer(cycled(
                    lambda i, ww: embedding_bag_ref(table, i, ww), args)),
                library_ms=timer(cycled(lambda i, ww: F.embedding_bag(
                    i, table, mode="sum", per_sample_weights=ww), lib_args)),
                host_us=host_us(cycled(
                    lambda i, ww: embedding_bag(table, i, ww), args),
                    reps=50),
                bound=bound_ms(*bag_costs(
                    B, L, DLRM_D, n_valid, n_rows, table.element_size(), 4,
                    True), dt))
    r["err"] = worst
    del tables, inputs
    torch.cuda.empty_cache()


def check_library_decode(torch, dev, report):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, path_launch_counts
    from repro_torch.kernels.decode_attn.ops import _launch as decode_launch
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    gen = torch.Generator(device="cpu").manual_seed(21)
    worst = 0.0

    def check(got, want, label):
        nonlocal worst
        require(got.dtype == torch.float32 and got.shape == want.shape,
                f"{label}: {got.dtype} {tuple(got.shape)}")
        err, ratio = close_err(got, want, ATTN_RTOL, ATTN_ATOL)
        require(ratio <= 1.0, f"{label}: max_abs_err {err:.3e} (err/tol "
                f"{ratio:.3f})")
        worst = max(worst, err)
        return err

    # -- the JAX test shapes (tests/test_kernels.py:122), the smoke width
    #    of Yi-9B (H = 8, KV = 2, hd = 16), hd = 128 and 8, and the edges
    n_cases = 0
    for b, h, kv, hd, t, ln in ((2, 8, 2, 32, 128, 100),
                                (1, 4, 4, 64, 300, 300),
                                (3, 8, 4, 16, 1024, 77),
                                (2, 16, 8, 64, 512, 512),
                                (2, 8, 2, 16, 700, 513),
                                (2, 8, 2, 128, 700, 650),
                                (1, 8, 4, 8, 300, 200)):
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn((b, h, hd), generator=gen).to(dev, dt)
            kc = torch.randn((b, t, kv, hd), generator=gen).to(dev, dt)
            vc = torch.randn((b, t, kv, hd), generator=gen).to(dev, dt)
            dev_len = torch.tensor([ln], dtype=torch.int32, device=dev)
            for length in (ln, dev_len, 0, t + 5):
                want = decode_attention_ref(q, kc, vc, length)
                label = (f"decode_attention {dt} B={b} H={h} KV={kv} hd={hd}"
                         f" T={t} length={int(length)}")
                check(decode_attention(q, kc, vc, length), want, label)
                check(decode_launch(q, kc, vc, length, n_chunks=1)[0], want,
                      label + " (one chunk)")
                n_cases += 2
            if dt == torch.bfloat16:   # a float32 query over a bf16 cache
                check(decode_attention(q.float(), kc, vc, ln),
                      decode_attention_ref(q.float(), kc, vc, ln),
                      f"decode_attention f32 q, bf16 cache T={t}")
                n_cases += 1
    log(f"decode_attention: {n_cases} cases at the JAX test shapes (f32 and "
        f"bf16, hd 8-128, length as an int and as a device tensor, length 0 "
        f"-> zeros, length > T, split and one chunk) match the plain "
        f"version; launches by path {path_launch_counts()['decode_attention']}")

    # -- Yi-9B: decode_32k (bf16 at B=128, f32 at B=32) and long_500k
    cases = (("decode_32k bf16", 128, 32768, torch.bfloat16),
             ("decode_32k f32 B=32", 32, 32768, torch.float32),
             ("long_500k bf16", 1, 524288, torch.bfloat16))
    r = report["decode_attention"] = {"shapes": {}}
    for label, B, T, dt in cases:
        g = torch.Generator(device=dev).manual_seed(22)
        q = torch.randn((B, YI_H, YI_HD), device=dev, generator=g).to(dt)
        kc = torch.randn((B, T, YI_KV, YI_HD), device=dev, generator=g,
                         dtype=dt)
        vc = torch.randn((B, T, YI_KV, YI_HD), device=dev, generator=g,
                         dtype=dt)
        length = torch.tensor([T], dtype=torch.int32, device=dev)
        want = decode_attention_ref(q, kc, vc, length)
        err = check(decode_attention(q, kc, vc, length), want,
                    f"decode_attention Yi-9B {label}")
        del want
        log(f"decode_attention Yi-9B {label} (cache "
            f"{2 * kc.nbytes / 1e9:.2f} GB): max_abs_err {err:.3e}")
        if label == "decode_32k bf16":
            # the main path: four decode steps, the prefix growing on the
            # device (no host sync between steps)
            def steps():
                length.fill_(T - 4)
                outs = []
                for _ in range(4):
                    length.add_(1)
                    outs.append(decode_attention(q, kc, vc, length))
                return outs
            outs, launches = drive_segment(torch, "Yi-9B decode_32k",
                                           "decode_attention", steps, 4,
                                           path="tensor_core")
            check(outs[-1], decode_attention_ref(q, kc, vc, T),
                  "decode_attention main-path step at length T")
            del outs
            r["launches"] = launches
        # SDPA as the yardstick: the G heads of a kv head as G query rows
        # of one attention, over (B, KV, T, hd) copies made beforehand
        qg = q.reshape(B, YI_KV, YI_H // YI_KV, YI_HD)
        kt = kc.transpose(1, 2).contiguous()
        vt = vc.transpose(1, 2).contiguous()
        prefix = (torch.arange(T, device=dev) < length)[None, None, None, :]
        n = int(length)
        entry = r["shapes"][label] = dict(
            B=B, T=T, length=n,
            ms=event_ms(lambda: decode_attention(q, kc, vc, length),
                        reps=10),
            plain_ms=event_ms(lambda: decode_attention_ref(q, kc, vc,
                                                           length)),
            library_ms=event_ms(lambda: F.scaled_dot_product_attention(
                qg, kt, vt, attn_mask=prefix), reps=10),
            host_us=host_us(lambda: decode_attention(q, kc, vc, length),
                            reps=20),
            bound=bound_ms(*decode_costs(
                B, YI_H, YI_KV, YI_HD, n, kc.element_size(),
                q.element_size()),
                "bfloat16" if dt == torch.bfloat16 else "float32"))
        entry["gb_per_s"] = decode_costs(
            B, YI_H, YI_KV, YI_HD, n, kc.element_size(),
            q.element_size())[0] / entry["ms"] / 1e6
        if B == 1:
            entry["one_chunk_ms"] = event_ms(
                lambda: decode_launch(q, kc, vc, length, n_chunks=1)[0])
        del q, kc, vc, kt, vt, qg
        torch.cuda.empty_cache()
    r["err"] = worst


def check_library_flash(torch, dev, report):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, path_launch_counts
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    gen = torch.Generator(device="cpu").manual_seed(31)
    worst = {"float32": 0.0, "bfloat16": 0.0}   # by the inputs' dtype

    def check(got, want, label, dt):
        require(got.dtype == torch.float32 and got.shape == want.shape,
                f"{label}: {got.dtype} {tuple(got.shape)}")
        err, ratio = close_err(got, want, ATTN_RTOL, ATTN_ATOL)
        require(ratio <= 1.0, f"{label}: max_abs_err {err:.3e} (err/tol "
                f"{ratio:.3f})")
        key = str(dt).split(".")[-1]
        worst[key] = max(worst[key], err)
        return err

    # -- the JAX test shapes (tests/test_kernels.py:158), the smoke width
    #    of Yi-9B, ragged S, hd = 128, and a strided q
    n_cases = {torch.float32: 0, torch.bfloat16: 0}
    by_path = {dt: {} for dt in n_cases}
    for b, s, h, hd in ((2, 128, 4, 32), (1, 100, 2, 16), (2, 256, 2, 64),
                        (1, 64, 8, 8), (2, 77, 8, 16), (1, 300, 2, 128)):
        for dt in (torch.float32, torch.bfloat16):
            before = dict(path_launch_counts()["flash_attention"])
            q, k, v = (torch.randn((b, s, h, hd), generator=gen).to(dev, dt)
                       for _ in range(3))
            want = flash_attention_ref(q, k, v)
            check(flash_attention(q, k, v), want,
                  f"flash_attention {dt} B={b} S={s} H={h} hd={hd}", dt)
            qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                          for x in (q, k, v))
            check(flash_attention(qt, k, v), want,
                  f"flash_attention {dt} B={b} S={s} strided q", dt)
            check(flash_attention(q, kt, vt), want,
                  f"flash_attention {dt} B={b} S={s} strided k and v", dt)
            n_cases[dt] += 3
            for p, n in path_launch_counts()["flash_attention"].items():
                if n > before[p]:
                    by_path[dt][p] = by_path[dt].get(p, 0) + n - before[p]
    for dt, n in n_cases.items():
        log(f"flash_attention {dt}: {n} cases at the JAX test shapes (hd "
            f"8-128, ragged S, strided q, strided k and v) match the plain "
            f"version; launches by path {by_path[dt]}")
    require(by_path[torch.float32] == {"tensor_core_tf32":
                                       n_cases[torch.float32]},
            f"flash_attention float32 launches by path "
            f"{by_path[torch.float32]}: every float32 case must take the "
            f"3xTF32 tensor-core kernel")

    # -- Yi-9B: train_4k width (B=8 of 256; f32 at B=1) and one
    #    prefill_32k-long call; each train_4k case is driven once as a
    #    segment of the main path
    r = report["flash_attention"] = {"shapes": {}}
    cases = (("train_4k bf16 B=8", 8, 4096, torch.bfloat16, None),
             ("train_4k f32 B=1", 1, 4096, torch.float32, None),
             ("prefill_32k bf16 B=1", 1, 32768, torch.bfloat16, 256))
    segment_path = {"train_4k bf16 B=8": "tensor_core",
                    "train_4k f32 B=1": "tensor_core_tf32"}
    for label, B, S, dt, sample in cases:
        g = torch.Generator(device=dev).manual_seed(32)
        q, k, v = (torch.randn((B, S, YI_H, YI_HD), device=dev, generator=g,
                               dtype=dt) for _ in range(3))
        launches = None
        if label in segment_path:
            # the main path: one causal prefill through the public wrapper
            out, launches = drive_segment(
                torch, f"Yi-9B {label} prefill", "flash_attention",
                lambda: flash_attention(q, k, v), 1,
                path=segment_path[label])
            if label == "train_4k bf16 B=8":
                r["launches"] = launches
        else:
            out = flash_attention(q, k, v)
        rows = None
        if sample:
            rows = torch.randperm(S, generator=gen)[:sample].sort().values
            rows[-1] = S - 1
            rows = rows.to(dev)
            want = flash_attention_ref(q, k, v, q_rows=rows)
            got = out.index_select(1, rows)
        else:
            want, got = flash_attention_ref(q, k, v), out
        err = check(got, want, f"flash_attention Yi-9B {label}", dt)
        log(f"flash_attention Yi-9B {label}: max_abs_err {err:.3e}"
            + (f" over {sample} sampled query rows" if sample else ""))
        del out, want, got
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes, flops = flash_costs(B, S, YI_H, YI_HD, q.element_size())
        entry = r["shapes"][label] = dict(
            B=B, S=S, plain_rows=sample or S, dtype=str(dt).split(".")[-1],
            ms=event_ms(lambda: flash_attention(q, k, v),
                        reps=2 if S > 8192 else 5),
            plain_ms=event_ms(lambda: flash_attention_ref(
                q, k, v, q_rows=rows), reps=2),
            library_ms=event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), reps=10))
        entry["tflop_per_s"] = flops / entry["ms"] / 1e9
        # ``bound``: the function's own work at the card's fastest rate for
        # its input dtype (bf16 tensor peak for bf16, TF32 tensor peak for
        # float32); the split's extra work and the fp32 (FMA) peak are
        # side figures
        entry["bound"] = bound_ms(nbytes, flops, "bfloat16"
                                  if dt == torch.bfloat16 else "tf32")
        entry["bound_f32_peak"] = bound_ms(nbytes, flops, "float32")
        if launches is not None:
            entry["launches"] = launches
        if dt == torch.bfloat16:
            # the kernel splits P into bf16 hi + lo: its tensor cores do
            # 1.5x the function's FLOPs (two P V products beside one Q K^T)
            entry["bound_split_p"] = bound_ms(nbytes, 1.5 * flops,
                                              "bfloat16")
        else:
            # 3xTF32: every product taken three times on the TF32 tensor
            # cores
            entry["bound_split_tf32"] = bound_ms(nbytes, 3 * flops, "tf32")
        if S <= 8192:
            entry["host_us"] = host_us(lambda: flash_attention(q, k, v),
                                       reps=3)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    r["err"] = max(worst.values())
    r["err_by_dtype"] = worst


# the kernels whose SASS must hold given instructions: the tensor-core
# attention kernels, wgmma (HGMMA) for bf16 flash, mma.sync (HMMA) for
# decode, both for float32 flash (S by wgmma, P V by mma.sync, TF32); the
# cluster body's kernels, of the MLP and DeepFM grad and score pairs
# (every instantiation, MLPInput and DeepFMInput),
# their cluster barrier (UCGABAR_ARV), their st.async pushes into the
# other CTAs' shared memory (STAS) and their mbarrier waits
# (SYNCS.PHASECHK)
CLUSTER_SASS = ("UCGABAR_ARV", "STAS", "SYNCS.PHASECHK")
SASS_KERNELS = {"flash_tc_kernel": ("HGMMA",), "decode_tc_kernel": ("HMMA",),
                "flash_tf32_kernel": ("HGMMA", "HMMA"),
                "mlp_grad_cluster_kernel": CLUSTER_SASS,
                "mlp_score_cluster_kernel": CLUSTER_SASS}
# those whose every instantiation must build without a spill
NO_SPILL = ("flash_tf32_kernel", "mlp_grad_cluster_kernel",
            "mlp_score_cluster_kernel")


def check_kernel_build(lib_path):
    """The kernels of SASS_KERNELS as built: each instantiation's
    registers, shared memory and spills (``ptxas -v`` in build.log), and
    its count of each required instruction in the library's SASS
    (``cuobjdump -sass``), which must not be 0; a ``NO_SPILL`` kernel must
    report 0 bytes of spill stores and loads."""
    from repro_torch.kernels import _lib
    entry, ptxas = None, {}
    with open(os.path.join(os.path.dirname(lib_path), "build.log")) as f:
        for line in f:
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if any(
                    k in line for k in SASS_KERNELS) else None
            elif entry and ("registers" in line or "spill" in line):
                ptxas.setdefault(entry, []).append(
                    line.replace("ptxas info    :", "").strip())
    cuobjdump = os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            kind = next((k for k in SASS_KERNELS if k in fn), None)
            if kind:
                counts[fn] = dict.fromkeys(SASS_KERNELS[kind], 0)
        elif fn in counts:
            for instr in counts[fn]:
                # "HMMA" is not a substring of "HGMMA"
                counts[fn][instr] += instr in line
    for f, n in counts.items():
        log(f"sass: {f}: {n}; ptxas: "
            + " | ".join(ptxas.get(f, ["no ptxas line"])))
    for k, instrs in SASS_KERNELS.items():
        mine = {f: n for f, n in counts.items() if k in f}
        require(bool(mine) and all(all(n.values()) for n in mine.values()),
                f"SASS: {k} instantiations {mine} must each hold "
                f"{' and '.join(instrs)}")
    for f in counts:
        if any(k in f for k in NO_SPILL):
            spills = [x for x in ptxas.get(f, []) if "spill" in x]
            require(bool(spills) and all(
                "0 bytes spill stores, 0 bytes spill loads" in x
                for x in spills), f"ptxas: {f} spills ({spills})")
    return {"sass": counts, "ptxas": ptxas}


def check_library_kernels(torch, dev):
    """Kernels 11-13 against their plain versions at the JAX test shapes
    (f32 and bf16) and at DLRM-RM2 and Yi-9B widths, each driven once
    through its public wrapper as a segment of the slice's main path
    (launches counted per segment), then timed beside its plain version
    and one PyTorch call of the same function (``library_ms``)."""
    report = {}
    check_library_bag(torch, dev, report)
    check_library_decode(torch, dev, report)
    check_library_flash(torch, dev, report)
    return report


# the shape whose numbers each library kernel of the kernels line reports
LIBRARY_LINE_SHAPE = {"embedding_bag": "train_batch L=1 float32",
                      "decode_attention": "decode_32k bf16",
                      "flash_attention": "train_4k bf16 B=8",
                      "flash_attention_f32": "train_4k f32 B=1"}


def log_library(report) -> None:
    for name, r in report.items():
        for label, e in r["shapes"].items():
            extra = ""
            if "gb_per_s" in e:
                extra = f"; {e['gb_per_s']:.1f} GB/s"
            if "tflop_per_s" in e:
                extra = f"; {e['tflop_per_s']:.1f} TFLOP/s"
            if "one_chunk_ms" in e:
                extra += (f"; one chunk per (batch, kv head) "
                          f"{e['one_chunk_ms']:.4f}ms")
            if "bound_split_p" in e:
                extra += (f"; bound of the split-P work (1.5x) "
                          f"{e['bound_split_p'][0]:.4f}ms")
            if "bound_split_tf32" in e:
                extra += (f"; bound of the 3xTF32 work (3x) at the TF32 "
                          f"peak {e['bound_split_tf32'][0]:.4f}ms")
            if "bound_f32_peak" in e:
                extra += (f"; of the function at the fp32 peak "
                          f"{e['bound_f32_peak'][0]:.4f}ms")
            if "launches" in e:
                extra += f"; {e['launches']} launches on the main path"
            if "host_us" in e:
                extra += (f"; one eager call costs the host "
                          f"{e['host_us']:.1f}us")
            log(f"kernel {name} {label}: {e['ms']:.4f}ms (plain "
                f"{e['plain_ms']:.4f}ms, library {e['library_ms']:.4f}ms, "
                f"bound {e['bound'][0]:.4f}ms by {e['bound'][1]}){extra}")
        log(f"kernel {name}: max_abs_err {r['err']:.3e}; {r['launches']} "
            f"launches on the main path")

# ---------------------------------------------------------------------------
# phase 4: the engine on the card against the engine on the CPU
# ---------------------------------------------------------------------------

def plain_result_scores(torch, measure, store, queries_t, ids):
    """The plain score of the measure's family (DeepFM or MLP) of each
    returned id's resident row, as ``CorpusStore.take`` dequantizes it
    (-inf where id < 0)."""
    from repro_torch.kernels.deepfm_score.ref import deepfm_score_ref
    from repro_torch.kernels.mlp_score.ref import mlp_score_ref
    Q, k = ids.shape
    rows = store.take(ids.clamp_min(0).reshape(-1))
    qs = queries_t.repeat_interleave(k, dim=0)
    family = measure.meta[0]
    if family == "deepfm":
        mlp = measure.params["mlp"]
        s = deepfm_score_ref(rows, qs, *[t for pair in zip(mlp["w"],
                                                           mlp["b"])
                                         for t in pair], measure.meta[1])
    elif family == "mlp":
        s = mlp_score_ref(rows, qs, measure.params["w"], measure.params["b"])
    else:
        raise SmokeFailure(f"no plain score for the {family!r} family")
    return s.reshape(Q, k).masked_fill(ids < 0, float("-inf"))


def check_result(torch, measure, store, queries_t, res, k, label):
    ids, scores = res.ids, res.scores
    require(tuple(ids.shape) == (queries_t.shape[0], k), f"{label}: ids "
            f"shape {tuple(ids.shape)}")
    require(bool((ids >= 0).all()), f"{label}: a query returned < {k} ids")
    require(bool(torch.isfinite(scores).all()), f"{label}: non-finite "
            f"scores")
    srt = ids.sort(dim=1).values
    require(bool((srt[:, 1:] != srt[:, :-1]).all()), f"{label}: repeated "
            f"ids in a result row")
    want = plain_result_scores(torch, measure, store, queries_t, ids)
    err = float((scores - want).abs().max())
    log(f"{label}: returned scores vs plain {measure.meta[0]} score of the "
        f"returned ids: max_abs_err={err:.3e}")
    require(err <= RESULT_SCORE_ATOL, f"{label}: returned scores differ "
            f"from the plain score by {err:.3e}")


def same_result(torch, a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("ids", "scores", "n_eval", "n_grad", "n_iters"))


# the searches the engine phase holds against the CPU, per measure family
ENGINE_MODES = {"deepfm": ("unfused", "fused_int8"),
                "mlp": ("unfused", "fused_f32", "fused_int8")}


def check_engine(torch, np, dev, family, N=5000):
    """At N=5,000 with the ``family`` measure: the searches of
    ENGINE_MODES[family] agree with the same search on the CPU within 0.01
    recall@10, and the fused float32 search on the card returns the
    unfused one's ids, scores and counters (plain and adaptive)."""
    from repro_torch.core import (EngineOptions, SearchConfig,
                                  brute_force_topk, make_corpus_store,
                                  make_family_measure, recall, search_measure)
    from repro_torch.graph import build_l2_graph
    D, Q = 40, 256
    rng = np.random.default_rng(1)
    base = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    graph = build_l2_graph(base, m=24, k_construction=100, device=dev)
    cfg = SearchConfig(k=10, ef=64, budget=8, alpha=1.01, mode="guitar",
                       rank_by="angle")
    cpu = torch.device("cpu")
    ctx = {}
    for where in (dev, cpu):
        ctx[where.type] = (
            make_family_measure(family, torch.Generator().manual_seed(0), D,
                                device=where),
            torch.as_tensor(graph.neighbors, device=where),
            torch.as_tensor(queries, device=where),
            torch.full((Q,), graph.entry, device=where))

    def run(where, options, cfg=cfg):
        measure, nbrs, qt, entries = ctx[where.type]
        store = make_corpus_store(base, options.corpus_dtype, device=where)
        t0 = time.perf_counter()
        res = search_measure(measure, store, nbrs, qt, entries, cfg, options)
        if where.type == "cuda":
            torch.cuda.synchronize()
            check_result(torch, measure, store, qt, res, cfg.k,
                         f"engine {family} N={N} {options.corpus_dtype} fused="
                         f"{options.fused} adaptive={options.adaptive} on "
                         f"the card")
        return res, time.perf_counter() - t0

    m_cpu, _, q_cpu, _ = ctx["cpu"]
    true_ids, _ = brute_force_topk(m_cpu, torch.as_tensor(base), q_cpu,
                                   cfg.k)
    options_of = {"unfused": EngineOptions(),
                  "fused_f32": EngineOptions(fused=True),
                  "fused_int8": EngineOptions(fused=True,
                                              corpus_dtype="int8")}
    out = {"family": family, "n": N, "queries": Q}
    card = {}
    for label in ENGINE_MODES[family]:
        options = options_of[label]
        (r_card, s_card), (r_cpu, s_cpu) = run(dev, options), \
            run(cpu, options)
        rc, rp = recall(r_card.ids, true_ids), recall(r_cpu.ids, true_ids)
        same = float((r_card.ids.cpu() == r_cpu.ids).all(1).float().mean())
        log(f"engine {family} N={N} Q={Q} {label}: recall@10 card={rc:.4f} "
            f"cpu="
            f"{rp:.4f} (|diff| {abs(rc - rp):.4f} <= {RECALL_AGREE}); "
            f"identical result rows {same:.3f}; card {s_card:.3f}s, cpu "
            f"{s_cpu:.3f}s")
        require(abs(rc - rp) <= RECALL_AGREE,
                f"{label}: card/CPU recall disagree: {rc:.4f} vs {rp:.4f}")
        out[label] = {"recall_card": rc, "recall_cpu": rp,
                      "identical_rows": same, "card_s": s_card,
                      "cpu_s": s_cpu}
        card[label] = r_card
    fused_f32 = card["fused_f32"] if "fused_f32" in card \
        else run(dev, options_of["fused_f32"])[0]
    require(same_result(torch, fused_f32, card["unfused"]),
            f"engine {family}: the fused float32 search differs from the "
            f"unfused one")
    cfg_a = SearchConfig(k=10, ef=64, budget=8, alpha=1.2, mode="guitar",
                         rank_by="angle")
    adapt = dict(adaptive="angle", c_max=16, angle_tau=1.8)
    un_a, _ = run(dev, EngineOptions(**adapt), cfg_a)
    fu_a, _ = run(dev, EngineOptions(fused=True, **adapt), cfg_a)
    require(same_result(torch, un_a, fu_a), f"engine {family}: the fused "
            f"float32 adaptive search differs from the unfused one")
    log(f"engine {family} N={N}: fused float32 search = unfused search on "
        f"the card (ids, scores, counters), plain and adaptive angle")
    out["fused_f32_equals_unfused"] = True
    return out


# ---------------------------------------------------------------------------
# phase 4b: the engine's search as captured programs
# ---------------------------------------------------------------------------

def eager_step_sync_free(torch, eng, params, store, nbrs, qt, entries):
    """One eager ``step`` of ``eng`` under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync in it
    raises."""
    from repro_torch.core.engine import _repeat_rows
    state = eng.init_state(params, store, nbrs, qt, entries)
    qs_flat = _repeat_rows(qt, eng.n_candidates(nbrs.shape[1]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step(params, store, nbrs, qt, qs_flat, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def check_graph(torch, np, dev, family, N=5000):
    """At N=5,000 with the ``family`` measure, every ENGINE_MODES label
    and adaptive angle sizing, each without and with per-query iter_caps
    (and taus where adaptive): the captured search returns the eager
    ``search_debug``'s ids, scores and counters bit for bit (its first,
    capturing, call and a replay), and the eager host loop's too; the
    captured search's launch counts (replays x captured, warm-up apart)
    equal the eager host loop's, kernel by kernel; one eager step of each
    path makes no host sync."""
    from repro_torch.core import (EngineOptions, SearchConfig, build_engine,
                                  make_corpus_store, make_family_measure)
    from repro_torch.graph import build_l2_graph
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     warmup_launch_counts)
    D, Q = 40, 256
    rng = np.random.default_rng(2)
    base = rng.normal(size=(N, D)).astype(np.float32)
    qt = torch.as_tensor(rng.normal(size=(Q, D)).astype(np.float32),
                         device=dev)
    caps = torch.as_tensor(rng.integers(4, 200, size=Q).astype(np.int32))
    taus = torch.as_tensor(rng.uniform(1.2, 2.0, size=Q).astype(np.float32))
    graph = build_l2_graph(base, m=24, k_construction=100, device=dev)
    nbrs = torch.as_tensor(graph.neighbors, device=dev)
    entries = torch.full((Q,), graph.entry, device=dev)
    measure = make_family_measure(family, torch.Generator().manual_seed(0),
                                  D, device=dev)
    cfg = SearchConfig(k=10, ef=64, budget=8, alpha=1.01, mode="guitar",
                       rank_by="angle")
    cfg_a = SearchConfig(k=10, ef=64, budget=8, alpha=1.2, mode="guitar",
                         rank_by="angle")
    adapt = dict(adaptive="angle", c_max=16, angle_tau=1.8)
    modes = {"unfused": (cfg, EngineOptions()),
             "fused_f32": (cfg, EngineOptions(fused=True)),
             "fused_int8": (cfg, EngineOptions(fused=True,
                                               corpus_dtype="int8")),
             "adaptive_int8": (cfg_a, EngineOptions(
                 fused=True, corpus_dtype="int8", **adapt))}
    labels = ENGINE_MODES[family] + ("adaptive_int8",)
    out = {"family": family, "n": N, "queries": Q}
    for label in labels:
        c, options = modes[label]
        eng = build_engine(measure, c, options)
        store = make_corpus_store(base, options.corpus_dtype, device=dev)
        eager_step_sync_free(torch, eng, measure.params, store, nbrs, qt,
                             entries)
        for case, kw in (("plain", {}),
                         ("caps", {"iter_caps": caps,
                                   **({"taus": taus} if options.adaptive
                                      == "angle" else {})})):
            name = f"graph {family} N={N} {label} {case}"
            debug = eng.search_debug(measure.params, store, nbrs, qt,
                                     entries, **kw)
            reset_launch_counts()
            host = eng.search(measure.params, store, nbrs, qt, entries,
                              capture=False, **kw)
            torch.cuda.synchronize()
            host_counts = launch_counts()
            reset_launch_counts()
            t0 = time.perf_counter()
            first = eng.search(measure.params, store, nbrs, qt, entries,
                               **kw)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            cap_counts, warm = launch_counts(), warmup_launch_counts()
            prog = eng.search_program(measure.params, store, nbrs, qt)
            per_chunk = prog.captured_launches("chunk")
            replay = eng.search(measure.params, store, nbrs, qt, entries,
                                **kw)
            torch.cuda.synchronize()
            for lbl, r in (("eager host loop", host),
                           ("captured (capturing call)", first),
                           ("captured (replay)", replay)):
                require(same_result(torch, r, debug),
                        f"{name}: the {lbl} search differs from "
                        f"search_debug")
            require(cap_counts == host_counts,
                    f"{name}: captured launches {cap_counts} differ from "
                    f"the eager host loop's {host_counts}")
            require(any(host_counts.values()),
                    f"{name}: no kernel launched")
            log(f"{name}: captured search = search_debug = host loop bit "
                f"for bit (ids, scores, counters); launches {cap_counts} "
                f"= host loop's (warm-up apart: {warm}); one chunk "
                f"replays {per_chunk}; first call with capture "
                f"{capture_s:.2f}s; one eager step made no host sync")
            out[f"{label} {case}"] = {
                "launches": cap_counts, "warmup_launches": warm,
                "chunk_launches": per_chunk, "capture_s": capture_s,
                "n_iters_max": int(debug.n_iters.max())}
    return out


# ---------------------------------------------------------------------------
# phase 5: serve N = 100,000 through the oneshot path
# ---------------------------------------------------------------------------

# the kernels a serve run launches, by (measure family, fused); a run must
# launch each of its kernels and none of the others
KERNELS_OF = {
    ("deepfm", False): ("deepfm_score", "neighbor_rank",
                        "deepfm_value_and_grad"),
    ("deepfm", True): ("deepfm_score_fused", "neighbor_rank_fused",
                       "deepfm_grad_fused"),
    ("mlp", False): ("mlp_score", "neighbor_rank", "mlp_value_and_grad"),
    ("mlp", True): ("mlp_score_fused", "neighbor_rank_fused",
                    "mlp_grad_fused"),
}
ADAPTIVE_ARGS = ["--fused", "--corpus-dtype", "int8", "--adaptive", "angle",
                 "--c-max", "16"]
# (label, measure family, launcher flags)
SERVE_RUNS = (
    ("unfused float32", "deepfm", []),
    ("fused float32", "deepfm", ["--fused"]),
    ("fused bfloat16", "deepfm", ["--fused", "--corpus-dtype", "bfloat16"]),
    ("fused int8", "deepfm", ["--corpus-dtype", "int8"]),
    ("fused int8 adaptive", "deepfm", ADAPTIVE_ARGS),
    ("mlp unfused float32", "mlp", []),
    ("mlp fused int8", "mlp", ["--corpus-dtype", "int8"]),
    ("mlp fused int8 adaptive", "mlp", ADAPTIVE_ARGS),
)


def serve_common(items, dev) -> list:
    """The serve phase's launcher flags: the DeepFM model's width (D = 40,
    hidden 64x64) and corpus size (DeepFMConfig.n_items), the paper's
    search settings; 10 batches of 32 queries."""
    return ["--items", str(items), "--dim", "40", "--queries", "320",
            "--batch", "32", "--ef", "64", "--budget", "8", "--alpha",
            "1.01", "--k", "10", "--device", str(dev)]


def serve_stream(np, items, dim=40):
    """The serve phase's base and query stream: (base, rng, the rng's
    state after the base, where the launcher's queries start)."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(items, dim)).astype(np.float32)
    return base, rng, rng.bit_generator.state


def serve_compare(torch, np, serve, common, family, extra, graph, measure,
                  cfg, store, nbrs, base_t, rng, query_stream, qt, entries,
                  label):
    """The captured serve and the eager host-loop serve of one SERVE_RUNS
    run in turns (eager, captured, captured, eager) over the same query
    stream: QPS, p50/p95 per batch, host us per step and program runs per
    batch of each; each serve's launch counts equal the eager one's, and
    the 64 recall queries return the same ids, scores and counters in both
    loops."""
    from repro_torch.core import search_measure
    from repro_torch.kernels import launch_counts, reset_launch_counts
    turns = []
    for loop in ("host", "captured", "captured", "host"):
        flags = ["--host-loop"] if loop == "host" else []
        args = serve.parse_args(common + ["--measure", family] + extra
                                + flags)
        options = serve.engine_options(args)
        rng.bit_generator.state = query_stream
        reset_launch_counts()
        summ = serve.serve_oneshot(args, graph, measure, cfg, options, store,
                                   nbrs, base_t, rng, qt.device)
        c = launch_counts()
        if not turns:
            host_counts = c
        require(c == host_counts, f"serve {label}: the {loop} serve "
                f"launched {c}, the eager host loop {host_counts}")
        turns.append({k: summ[k] for k in (
            "loop", "qps", "p50_ms", "p95_ms", "host_us_per_step",
            "runs_per_batch", "steps_per_batch", "recall")})
    res = {loop: search_measure(measure, store, nbrs, qt, entries, cfg,
                                options, capture=(loop == "captured"))
           for loop in ("host", "captured")}
    require(same_result(torch, res["host"], res["captured"]),
            f"serve {label}: the captured search of the 64 recall queries "
            f"differs from the eager host loop's")
    for t in turns:
        log(f"serve {label} compare: {t['loop']:8s} QPS={t['qps']:.1f} "
            f"p50={t['p50_ms']:.3f}ms p95={t['p95_ms']:.3f}ms, "
            f"{t['host_us_per_step']:.1f}us host issue per step, "
            f"{t['runs_per_batch']:.1f} program runs per batch "
            f"({t['steps_per_batch']:.0f} steps), recall@10 (16) "
            f"{t['recall']:.4f}")
    require(len({t["recall"] for t in turns}) == 1,
            f"serve {label}: recall differs between the loops: {turns}")
    return {"turns": turns, "launches": host_counts}


def check_serve(torch, np, dev, items=100_000):
    """One graph at N=100,000, served through the launcher's oneshot path
    (captured programs) per SERVE_RUNS with the DeepFM and the MLP
    measure; each run must launch every kernel of its path and no other,
    each result must score its ids as the plain measure scores their
    resident rows, and recall is labelled on the float32 base. Then each
    run's captured and eager serves in turns (``serve_compare``)."""
    from repro_torch.core import (SearchConfig, brute_force_topk,
                                  make_corpus_store, make_family_measure,
                                  recall, search_measure)
    from repro_torch.graph import build_l2_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    # the paper's graph (M = 24, k_construction = 100)
    common = serve_common(items, dev)
    args = serve.parse_args(common)
    base, rng, query_stream = serve_stream(np, args.items, args.dim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = build_l2_graph(base, m=24, k_construction=100,
                           exact_threshold=args.items, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"serve: graph N={args.items} built on the card in {build_s:.2f}s "
        f"(avg degree {graph.avg_degree:.1f}, max {graph.max_degree})")
    # the launcher's measures: DeepFM and the MLP at the serving width
    measures = {fam: make_family_measure(fam,
                                         torch.Generator().manual_seed(0),
                                         args.dim, device=dev)
                for fam in ("deepfm", "mlp")}
    cfg = SearchConfig(k=args.k, ef=args.ef, mode=args.mode,
                       budget=args.budget, alpha=args.alpha)
    base_t = torch.as_tensor(base, device=dev)
    nbrs = torch.as_tensor(graph.neighbors, device=dev)
    # recall@10 on 64 more queries, labelled on the float32 base
    qt = torch.as_tensor(np.random.default_rng(7).normal(
        size=(64, args.dim)).astype(np.float32), device=dev)
    entries = torch.full((64,), graph.entry, device=dev)
    true_ids = {fam: brute_force_topk(m, base_t, qt, cfg.k)[0]
                for fam, m in measures.items()}

    out = {"graph_build_s": build_s}
    ctx = {}
    for label, family, extra in SERVE_RUNS:
        args = serve.parse_args(common + ["--measure", family] + extra)
        measure = measures[family]
        options = serve.engine_options(args)
        store = make_corpus_store(base_t, args.corpus_dtype, device=dev)
        rng.bit_generator.state = query_stream   # the same query stream
        reset_launch_counts()
        summary = serve.serve_oneshot(args, graph, measure, cfg, options,
                                      store, nbrs, base_t, rng, dev)
        counts = launch_counts()
        log(f"serve {label}: kernel launches in the serve run: {counts}")
        path = KERNELS_OF[(family, options.fused)]
        for name, n in counts.items():
            require(n > 0 if name in path else n == 0,
                    f"serve {label}: kernel {name} launched {n} times; the "
                    f"path's kernels are {path}")
        res = search_measure(measure, store, nbrs, qt, entries, cfg, options)
        check_result(torch, measure, store, qt, res, cfg.k,
                     f"serve {label} N={args.items}")
        rec = recall(res.ids, true_ids[family])
        cmp = serve_compare(torch, np, serve, common, family, extra, graph,
                            measure, cfg, store, nbrs, base_t, rng,
                            query_stream, qt, entries, label)
        require(cmp["launches"] == counts, f"serve {label}: the compare "
                f"phase's launches {cmp['launches']} differ from the serve "
                f"phase's {counts}")
        log(f"serve {label}: recall@10 on 64 queries = {rec:.4f} (labels on "
            f"the float32 base); evals/query "
            f"{float(res.n_eval.float().mean()):.1f}, iterations mean "
            f"{float(res.n_iters.float().mean()):.1f}")
        log(f"serve {label}: QPS={summary['qps']:.1f} p50="
            f"{summary['p50_ms']:.3f}ms p95={summary['p95_ms']:.3f}ms per "
            f"batch of {args.batch}; evals/query "
            f"{summary['evals_per_query']:.1f}, iterations mean "
            f"{summary['iters_mean']:.1f} max {summary['iters_max']:.0f}; "
            f"corpus {store.nbytes() / 2**20:.1f} MiB")
        out[label] = {**summary, "family": family, "recall64": rec,
                      "launches": counts,
                      "corpus_mib": store.nbytes() / 2**20,
                      "compare": cmp["turns"]}
        ctx[label] = (measure, store, nbrs, graph, cfg, options)
    return out, ctx


def device_busy_us(spans) -> float:
    """Microseconds covered by the union of (start, end) device spans."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return busy + cur_e - cur_s


def profile_serve(torch, np, dev, ctx, label, capture=False):
    """torch.profiler over one served batch of 32 at N=100,000, through
    the eager host loop or (``capture``) the captured programs: the share
    of the batch's wall time in which the card runs a kernel (against the
    profiled batch's wall and against the same batch's wall without the
    profiler), and device time by kernel and by kind (the port's kernels,
    copies, the PyTorch glue). It reports and checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import search_measure
    from repro_torch.kernels import (deepfm_grad_fused,
                                     deepfm_value_and_grad, mlp_grad_fused,
                                     mlp_value_and_grad)
    measure, store, nbrs, graph, cfg, options = ctx
    q = torch.as_tensor(np.random.default_rng(9).normal(
        size=(32, store.dim)).astype(np.float32), device=dev)
    entries = torch.full((32,), graph.entry, device=dev)

    def steps():        # one grad launch per engine step
        return sum(fn.launches for fn in (deepfm_value_and_grad,
                                          deepfm_grad_fused,
                                          mlp_value_and_grad,
                                          mlp_grad_fused))

    search_measure(measure, store, nbrs, q, entries, cfg, options,
                   capture=capture)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search_measure(measure, store, nbrs, q, entries, cfg, options,
                   capture=capture)
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    launches0 = steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search_measure(measure, store, nbrs, q, entries, cfg, options,
                       capture=capture)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n_steps = steps() - launches0
    loop = "captured" if capture else "host loop"
    label = f"{label} ({loop})"
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        log(f"profile {label}: the profiler recorded no device events")
        return {"wall_us": wall_us, "device_events": 0, "loop": loop}
    busy = device_busy_us((e.time_range.start, e.time_range.end)
                          for e in kern)
    by_name = {}
    for e in kern:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    kinds = {"port kernels": 0.0, "copies": 0.0, "PyTorch glue": 0.0}
    for name, (n, t) in by_name.items():
        kind = ("port kernels" if "repro::" in name else
                "copies" if "emcpy" in name or "memset" in name.lower()
                else "PyTorch glue")
        kinds[kind] += t
    log(f"profile {label}: one batch of 32 at N={store.n}: wall "
        f"{wall_us:.0f}us, device busy {busy:.0f}us ({busy / wall_us:.1%}), "
        f"idle {1 - busy / wall_us:.1%}; {len(kern)} device events over "
        f"{n_steps} engine steps ({len(kern) / max(n_steps, 1):.1f} per "
        f"step); without the profiler the batch takes {plain_wall_us:.0f}us "
        f"(busy {min(busy / plain_wall_us, 1.0):.1%}); device time "
        + ", ".join(f"{k} {t:.0f}us" for k, t in kinds.items()))
    for name, (n, t) in top:
        log(f"profile {label}:   {t:9.1f}us {n:6d}x  {name[:90]}")
    return {"wall_us": wall_us, "busy_us": busy, "device_events": len(kern),
            "idle_share": 1 - busy / wall_us, "steps": n_steps,
            "plain_wall_us": plain_wall_us,
            "plain_idle_share": max(1 - busy / plain_wall_us, 0.0),
            "kinds_us": kinds,
            "loop": loop, "top": [(name, n, t) for name, (n, t) in top],
            "by_name": {name: [n, t] for name, (n, t) in by_name.items()}}


# ---------------------------------------------------------------------------
# phase 7: the continuous runtime at N = 100,000
# ---------------------------------------------------------------------------

CONTINUOUS_RUNS = ("fused int8", "mlp fused int8")
CONTINUOUS_LANES, CONTINUOUS_SPT, CONTINUOUS_N = 32, 8, 320
CONTINUOUS_PARITY = 64      # requests held against the oneshot search


def check_continuous(torch, np, dev, ctx, label):
    """The continuous runtime over a SERVE_RUNS run's corpus, graph and
    engine: 32 lanes, 8 steps per tick, captured reset and tick. A backlog
    run (every request due at t=0) measures its capacity; then Poisson
    arrivals at 0.8x that capacity for 320 requests. Each run launches
    every kernel of its path and no other; every ok completion of the
    first 64 requests of each run equals the oneshot captured search of
    the same query bit for bit (ids, scores, counters)."""
    from repro_torch.core import build_engine, search_measure
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (ContinuousRuntime, Request,
                                     ServingMetrics, poisson_arrivals)
    measure, store, nbrs, graph, cfg, options = ctx
    family = measure.meta[0]
    path = KERNELS_OF[(family, options.fused)]
    queries = np.random.default_rng(11).normal(
        size=(CONTINUOUS_N, store.dim)).astype(np.float32)
    qt = torch.as_tensor(queries[:CONTINUOUS_PARITY], device=dev)
    ref = search_measure(measure, store, nbrs, qt,
                         torch.full((CONTINUOUS_PARITY,), graph.entry,
                                    device=dev), cfg, options)
    ref = {f: getattr(ref, f).cpu().numpy() for f in ref._fields}
    rt = ContinuousRuntime(build_engine(measure, cfg, options),
                           measure.params, store, nbrs,
                           n_lanes=CONTINUOUS_LANES, query_dim=store.dim,
                           entry=graph.entry,
                           steps_per_tick=CONTINUOUS_SPT, device=dev)
    t0 = time.perf_counter()
    rt.warmup(queries[0])
    warm_s = time.perf_counter() - t0
    out = {"lanes": CONTINUOUS_LANES, "steps_per_tick": CONTINUOUS_SPT,
           "requests": CONTINUOUS_N, "warmup_s": warm_s}
    capacity = None
    for run in ("backlog", "poisson"):
        offsets = (np.zeros(CONTINUOUS_N) if run == "backlog" else
                   poisson_arrivals(CONTINUOUS_N, 0.8 * capacity, seed=1))
        stream = [Request(rid=i, query=queries[i],
                          t_arrive=float(offsets[i]))
                  for i in range(CONTINUOUS_N)]
        rt.metrics = ServingMetrics(CONTINUOUS_LANES)
        reset_launch_counts()
        comps = rt.run_stream(stream)
        counts = launch_counts()
        for name, n in counts.items():
            require(n > 0 if name in path else n == 0,
                    f"continuous {label} {run}: kernel {name} launched {n} "
                    f"times; the path's kernels are {path}")
        by = {c.rid: c for c in comps}
        require(len(by) == CONTINUOUS_N and all(
            c.status == "ok" for c in comps),
            f"continuous {label} {run}: {len(by)} of {CONTINUOUS_N} "
            f"requests resolved, statuses "
            f"{sorted({c.status for c in comps})}")
        for i in range(CONTINUOUS_PARITY):
            c = by[i]
            got = (c.ids, c.scores, c.n_eval, c.n_grad, c.n_iters)
            want = tuple(ref[f][i] for f in ("ids", "scores", "n_eval",
                                              "n_grad", "n_iters"))
            require(all(np.array_equal(np.asarray(g), w)
                        for g, w in zip(got, want)),
                    f"continuous {label} {run}: request {i} differs from "
                    f"the oneshot captured search")
        m = rt.metrics.summary()
        if run == "backlog":
            capacity = m["qps"]
        out[run] = {"offered_qps": (None if run == "backlog"
                                    else 0.8 * capacity),
                    "launches": counts, **m}
        log(f"continuous {label} {run}: {CONTINUOUS_N} requests, "
            f"throughput {m['qps']:.1f} QPS"
            + ("" if run == "backlog" else
               f" at offered {0.8 * capacity:.1f}")
            + f", latency p50={m['p50_ms']:.3f}ms p95={m['p95_ms']:.3f}ms "
            f"p99={m['p99_ms']:.3f}ms, queue p50={m['queue_p50_ms']:.3f}ms "
            f"p95={m['queue_p95_ms']:.3f}ms, lane occupancy "
            f"{m['occupancy']:.3f}, evals/query {m['evals_per_query']:.1f}; "
            f"the first {CONTINUOUS_PARITY} requests = oneshot captured "
            f"search bit for bit; launches {counts}")
    out["capacity_qps"] = capacity
    return out


# ---------------------------------------------------------------------------
# phase 8: the index lifecycle (build, save, load, serve; sharded search)
# ---------------------------------------------------------------------------

# Twitch's item count (configs/guitar_deepfm.py, Table 1) at the DeepFM
# width; above exact_threshold, so the build takes NN-descent
INDEX_N = 739_991
# NN-descent on the card against the port's CPU path (held against the JAX
# nn_descent by tests/test_torch_graph.py) from the same seed, just above
# exact_threshold
PARITY_N = 61_000
KNN_SAMPLE = 1000
# Floors on the build's quality: the values measured on an H100 less a
# margin, so that a collapse of the build fails. (The 0.6 floor of
# tests/test_graph_and_data.py holds at N=800, D=16, k=10; NN-descent as
# the JAX package runs it, 8 iterations of 10 samples, stays below it at
# k=100 over N(0,1) items of D=40 beyond a few thousand items, in both
# packages: tools/nn_descent_recall.py.)
PARITY_RECALL_MIN = 0.28        # recall@100 at PARITY_N; measured 0.3205
INDEX_RECALL_MIN = 0.08         # recall@100 at INDEX_N; measured 0.0956
INDEX_SERVE_RECALL_MIN = 0.04   # recall@10 over its graph; 0.0547-0.0625
# (label, saved corpus dtype, launcher flags): the serves from the index
INDEX_RUNS = (
    ("unfused float32", "float32", []),
    ("fused int8 adaptive", "int8", ADAPTIVE_ARGS),
)
SHARDS, SHARD_BATCHES = 4, 10


def check_nn_descent_parity(torch, np, dev, n=PARITY_N):
    """NN-descent (k 100, seed 0) over n N(0,1) items of D=40 on the card
    and through the port's CPU path: recall@100 on 1,000 sampled rows
    within RECALL_AGREE of each other (the two sum distances in other
    orders, so near-ties may part), and at least PARITY_RECALL_MIN."""
    from repro_torch.graph import knn_recall, nn_descent
    base = np.random.default_rng(0).normal(size=(n, 40)).astype(np.float32)
    rows = np.sort(np.random.default_rng(1).choice(n, KNN_SAMPLE,
                                                   replace=False))
    out = {"n": n}
    lists = {}
    for where, on in (("card", dev), ("cpu", torch.device("cpu"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lists[where] = nn_descent(base, 100, device=on)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rk, r10 = knn_recall(base, lists[where], rows, device=dev)
        out[where] = {"s": secs, "recall": rk, "recall_10nn": r10}
    same = float((lists["card"] == lists["cpu"]).all(axis=1).mean())
    c, h = out["card"], out["cpu"]
    log(f"index NN-descent parity N={n}: card {c['s']:.2f}s, CPU "
        f"{h['s']:.2f}s; recall@100 card {c['recall']:.4f}, CPU "
        f"{h['recall']:.4f}; 10-NN recall card {c['recall_10nn']:.4f}, CPU "
        f"{h['recall_10nn']:.4f}; rows identical {same:.4f}")
    require(abs(c["recall"] - h["recall"]) <= RECALL_AGREE,
            f"index: NN-descent recall on the card {c['recall']:.4f}, on the "
            f"CPU {h['recall']:.4f}")
    require(c["recall"] >= PARITY_RECALL_MIN, f"index: NN-descent recall@100 "
            f"{c['recall']:.4f} at N={n} < {PARITY_RECALL_MIN}")
    out["rows_identical"] = same
    return out


def check_index_build(torch, np, dev, n=INDEX_N):
    """Build the l2 graph of n N(0,1) items of D=40 (seed 0) with the
    paper's M=24, k_construction=100 at the default exact_threshold, so
    through NN-descent; log each stage's seconds (NN-descent per iteration,
    host and device apart); check the graph (ids in range, no self loops,
    no repeats in a row, degree <= 48, entry = medoid) and, on 1,000
    sampled rows, NN-descent's lists (no self, no repeat, nearest first)
    and their recall against the exact kNN, at least INDEX_RECALL_MIN.
    Then, for comparison, the
    exact kNN build of the same items. Returns (graph, exact graph,
    numbers)."""
    from repro_torch.graph import build_l2_graph, knn_recall, medoid
    base = np.random.default_rng(0).normal(size=(n, 40)).astype(np.float32)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = build_l2_graph(base, m=24, k_construction=100, device=dev,
                           stats=stats)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nd = stats.get("nn_descent")
    require(nd is not None, f"index: N={n} did not build through NN-descent")
    log(f"index build N={n}: {build_s:.2f}s in all: kNN (NN-descent) "
        f"{stats['knn_s']:.2f}s, prune {stats['prune_s']:.2f}s, symmetrize "
        f"{stats['symmetrize_s']:.2f}s; NN-descent start: host "
        f"{nd['init_host_s']:.2f}s, device {nd['init_device_s']:.2f}s")
    for i, it in enumerate(nd["iters"]):
        log(f"index build: NN-descent iteration {i}: host {it['host_s']:.3f}s"
            f", device {it['device_s']:.3f}s, {it['changed']} list entries "
            f"changed")
    nb = graph.neighbors
    require(nb.shape == (n, 48) and nb.dtype == np.int32,
            f"index: neighbors {nb.shape} {nb.dtype}")
    require(int(nb.min()) >= -1 and int(nb.max()) < n,
            "index: neighbor ids out of range")
    require(not (nb == np.arange(n)[:, None]).any(), "index: a self loop")
    srt = np.sort(np.where(nb >= 0, nb, -1 - np.arange(48)[None, :]), axis=1)
    require(bool((srt[:, 1:] != srt[:, :-1]).all()),
            "index: a neighbor repeated in a row")
    require(graph.entry == medoid(base), "index: entry is not the medoid")
    knn = stats["knn"]
    rows = np.sort(np.random.default_rng(1).choice(n, KNN_SAMPLE,
                                                   replace=False))
    lists = knn[rows]
    require(not (lists == rows[:, None]).any() and bool(
        (np.diff(np.sort(lists, axis=1), axis=1) != 0).all()),
        "index: an NN-descent list holds its own row or a repeat")
    d = np.linalg.norm(base[lists] - base[rows][:, None, :], axis=2)
    require(bool((np.diff(d, axis=1) >= -1e-5 * d[:, 1:]).all()),
            "index: an NN-descent list is not nearest first")
    rk, r10 = knn_recall(base, knn, rows, device=dev)
    log(f"index build: NN-descent kNN against the exact kNN of "
        f"{KNN_SAMPLE} sampled rows: recall@{knn.shape[1]} {rk:.4f}, 10-NN "
        f"recall {r10:.4f}; degree avg {graph.avg_degree:.1f}, max "
        f"{graph.max_degree}")
    require(rk >= INDEX_RECALL_MIN, f"index: NN-descent recall@"
            f"{knn.shape[1]} {rk:.4f} at N={n} < {INDEX_RECALL_MIN}")
    # for comparison: the exact kNN build of the same items
    xstats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = build_l2_graph(base, m=24, k_construction=100, exact_threshold=n,
                           device=dev, stats=xstats)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    log(f"index build N={n} with exact kNN (exact_threshold=N), for "
        f"comparison: {exact_s:.2f}s in all: kNN {xstats['knn_s']:.2f}s, "
        f"prune {xstats['prune_s']:.2f}s, symmetrize "
        f"{xstats['symmetrize_s']:.2f}s; degree avg {exact.avg_degree:.1f}")
    return graph, exact, {
        "n": n, "build_s": build_s, "knn_s": stats["knn_s"],
        "prune_s": stats["prune_s"], "symmetrize_s": stats["symmetrize_s"],
        "nn_descent": nd, "knn_recall": rk, "knn_recall_10nn": r10,
        "avg_degree": graph.avg_degree,
        "exact": {"build_s": exact_s, "knn_s": xstats["knn_s"],
                  "prune_s": xstats["prune_s"],
                  "symmetrize_s": xstats["symmetrize_s"],
                  "avg_degree": exact.avg_degree}}


def check_index_files(torch, np, dev, graph, root):
    """Save the index in each residency (v3) under ``root``; each loads
    back with the same neighbors and entry, a base that equals its
    residency's dequantized payload (float32: the base itself), and a
    ``load_corpus_store`` that holds the bytes ``make_corpus_store`` makes
    of the same base in that dtype."""
    from repro_torch.core import make_corpus_store
    from repro_torch.graph import load_corpus_store, load_index, save_index
    dirs, out = {}, {}
    base_t = torch.as_tensor(graph.base, device=dev)
    for dtype in RESIDENCIES:
        path = os.path.join(root, dtype)
        t0 = time.perf_counter()
        save_index(path, graph, corpus_dtype=dtype,
                   extra_meta={"graph_kind": "l2"})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        g2 = load_index(path)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        store = load_corpus_store(path, device=dev)
        torch.cuda.synchronize()
        store_s = time.perf_counter() - t0
        want = make_corpus_store(base_t, dtype, device=dev)
        require(np.array_equal(g2.neighbors, graph.neighbors)
                and g2.entry == graph.entry,
                f"index {dtype}: neighbors or entry differ after the round "
                f"trip")
        require(store.dtype == dtype and store.data.dtype == want.data.dtype
                and torch.equal(store.data, want.data)
                and (store.scales is None or torch.equal(store.scales,
                                                         want.scales)),
                f"index {dtype}: the loaded store's payload differs from "
                f"make_corpus_store's")
        deq = want.dequantize().cpu().numpy()
        require(np.array_equal(g2.base, deq if dtype != "float32"
                               else graph.base),
                f"index {dtype}: the loaded base differs from the "
                f"dequantized payload")
        mib = sum(os.path.getsize(os.path.join(path, f))
                  for f in os.listdir(path)) / 2**20
        log(f"index files {dtype}: saved in {save_s:.2f}s ({mib:.1f} MiB on "
            f"disk), load_index {load_s:.2f}s, load_corpus_store "
            f"{store_s:.2f}s ({store.nbytes() / 2**20:.1f} MiB resident); "
            f"round trip exact")
        dirs[dtype] = path
        out[dtype] = {"save_s": save_s, "load_s": load_s,
                      "store_s": store_s, "disk_mib": mib}
    return dirs, out


def check_index_serve(torch, np, dev, graph, dirs, exact):
    """``serve --index DIR`` on the card through the captured programs per
    INDEX_RUNS (ef 64, C 8, alpha 1.01, k 10, 10 batches of 32): each
    batch's ids and scores equal, bit for bit, the launcher's serve of the
    same in-memory graph and a store made from the base; each launches its
    path's kernels and no other, as many times as the in-memory serve;
    each result scores its ids as the plain measure scores their resident
    rows; recall@10 on 64 queries against the exact top-10 on the float32
    base, at least INDEX_SERVE_RECALL_MIN, beside the same search's over
    the exact-kNN graph ``exact``."""
    from repro_torch.core import (SearchConfig, brute_force_topk,
                                  make_corpus_store, make_family_measure,
                                  recall, search_measure)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    common = ["--queries", "320", "--batch", "32", "--ef", "64", "--budget",
              "8", "--alpha", "1.01", "--k", "10", "--device", str(dev)]
    base_t = torch.as_tensor(graph.base, device=dev)
    nbrs = torch.as_tensor(graph.neighbors, device=dev)
    measure = make_family_measure("deepfm", torch.Generator().manual_seed(0),
                                  40, device=dev)
    qt = torch.as_tensor(np.random.default_rng(7).normal(
        size=(64, 40)).astype(np.float32), device=dev)
    entries = torch.full((64,), graph.entry, device=dev)
    exact_nbrs = torch.as_tensor(exact.neighbors, device=dev)
    exact_entries = torch.full((64,), exact.entry, device=dev)
    true_ids = brute_force_topk(measure, base_t, qt, 10)[0]
    out = {}
    for label, dtype, extra in INDEX_RUNS:
        argv = common + ["--index", dirs[dtype]] + extra
        args = serve.parse_args(argv)
        args.items, args.dim = graph.base.shape     # as --index sets them
        require(args.corpus_dtype == dtype, f"index serve {label}: flags "
                f"ask for {args.corpus_dtype}, the index holds {dtype}")
        options = serve.engine_options(args)
        got = []
        reset_launch_counts()
        summary = serve.main(argv, results=got)
        counts = launch_counts()
        path = KERNELS_OF[("deepfm", options.fused)]
        for name, n in counts.items():
            require(n > 0 if name in path else n == 0,
                    f"index serve {label}: kernel {name} launched {n} "
                    f"times; the path's kernels are {path}")
        cfg = SearchConfig(k=args.k, ef=args.ef, mode=args.mode,
                           budget=args.budget, alpha=args.alpha)
        store = make_corpus_store(base_t, dtype, device=dev)
        mem = []
        reset_launch_counts()
        serve.serve_oneshot(args, graph, measure, cfg, options, store, nbrs,
                            base_t, np.random.default_rng(0), dev,
                            results=mem)
        mem_counts = launch_counts()
        require(len(got) == len(mem) == 10 and all(
            torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
            for a, b in zip(got, mem)),
            f"index serve {label}: results differ from the in-memory "
            f"serve's")
        require(mem_counts == counts, f"index serve {label}: launches "
                f"{counts}, the in-memory serve's {mem_counts}")
        res = search_measure(measure, store, nbrs, qt, entries, cfg, options)
        check_result(torch, measure, store, qt, res, cfg.k,
                     f"index serve {label} N={graph.n}")
        rec = recall(res.ids, true_ids)
        res_x = search_measure(measure, store, exact_nbrs, qt, exact_entries,
                               cfg, options)
        rec_x = recall(res_x.ids, true_ids)
        log(f"index serve {label} N={graph.n} (from {dtype} v3 files): "
            f"QPS={summary['qps']:.1f} p50={summary['p50_ms']:.3f}ms "
            f"p95={summary['p95_ms']:.3f}ms per batch of 32, recall@10 on "
            f"64 queries = {rec:.4f} (labels on the float32 base; "
            f"{rec_x:.4f} over the exact-kNN graph), evals/"
            f"query {summary['evals_per_query']:.1f}, iterations mean "
            f"{summary['iters_mean']:.1f} max {summary['iters_max']:.0f}, "
            f"{summary['runs_per_batch']:.1f} program runs per batch; = the "
            f"in-memory serve bit for bit; launches {counts}")
        require(rec >= INDEX_SERVE_RECALL_MIN, f"index serve {label}: "
                f"recall@10 {rec:.4f} < {INDEX_SERVE_RECALL_MIN}")
        out[label] = {**summary, "recall64": rec,
                      "recall64_exact_graph": rec_x, "launches": counts}
    return out


def check_sharded(torch, np, dev, ctx, unsharded_recall):
    """``build_sharded_index`` with S=4 over the serve phase's N=100,000
    base (M=24, k_construction=100, 4 x 25,000 exact builds) and
    ``sharded_search_host`` on the one card, DeepFM fused int8, 10 batches
    of 32 after a warm-up batch: merged rows duplicate-free with no -1 id,
    each merged score the plain measure's score on its row within
    RESULT_SCORE_ATOL; each kernel of the fused DeepFM path launched and
    no other, as many times as the four shards' single-partition searches
    of the same batches launch them in all (the one route the engine
    takes: the equality shows that the merge launches nothing of its
    own); recall@10 on 64
    queries beside the unsharded serve's, QPS, p50/p95, program runs and
    new programs per batch. Then a padded index (N=10,001 over 4 shards:
    3 padded rows) returns no padded row."""
    from repro_torch.core import (brute_force_topk, build_engine,
                                  build_sharded_index, make_corpus_store,
                                  recall, sharded_search_host)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    measure, _, _, graph, cfg, options = ctx
    base = graph.base
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = build_sharded_index(base, SHARDS, m=24, k_construction=100,
                              device=dev)
    build_s = time.perf_counter() - t0
    require(bool((idx.global_ids >= 0).all()) and idx.base.shape[:2] == (
        SHARDS, base.shape[0] // SHARDS), f"sharded: unexpected layout "
        f"{idx.base.shape}")
    eng = build_engine(measure, cfg, options)
    whole = make_corpus_store(torch.as_tensor(base, device=dev), "int8",
                              device=dev)
    rng = np.random.default_rng(0)
    batches = [torch.as_tensor(rng.normal(size=(32, 40)).astype(np.float32),
                               device=dev) for _ in range(SHARD_BATCHES + 1)]
    sharded_search_host(measure, idx, batches[0], cfg, devices=[dev],
                        options=options)            # warm-up: captures
    st0 = dict(eng.stats)
    lat = []
    reset_launch_counts()
    results = []
    for q in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sharded_search_host(measure, idx, q, cfg, devices=[dev],
                                  options=options)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
    counts = launch_counts()
    path = KERNELS_OF[("deepfm", options.fused)]
    for name, n in counts.items():
        require(n > 0 if name in path else n == 0,
                f"sharded: kernel {name} launched {n} times; the path's "
                f"kernels are {path}")
    runs = (eng.stats["runs"] - st0["runs"]) / SHARD_BATCHES
    new_programs = eng.stats["programs"] - st0["programs"]
    for q, res in zip(batches[1:], results):
        ids = res.ids
        require(bool((ids >= 0).all()), "sharded: a -1 id in a merged row")
        srt = ids.sort(dim=1).values
        require(bool((srt[:, 1:] != srt[:, :-1]).all()),
                "sharded: an id twice in a merged row")
        want = plain_result_scores(torch, measure, whole, q, ids)
        err = float((res.scores - want).abs().max())
        require(err <= RESULT_SCORE_ATOL, f"sharded: merged scores differ "
                f"from the plain score by {err:.3e}")
    stores = idx.stores(options.corpus_dtype, [dev])
    reset_launch_counts()
    for q in batches[1:]:
        for s, store in enumerate(stores):
            eng.search(measure.params, store, idx.placed(s, dev)[0], q,
                       torch.full((32,), int(idx.entries[s]), device=dev))
    shard_counts = launch_counts()
    require(shard_counts == counts, f"sharded: launches {counts}, the four "
            f"shards' searches {shard_counts}")
    qt = torch.as_tensor(np.random.default_rng(7).normal(
        size=(64, 40)).astype(np.float32), device=dev)
    true_ids = brute_force_topk(measure, torch.as_tensor(base, device=dev),
                                qt, cfg.k)[0]
    rec = recall(sharded_search_host(measure, idx, qt, cfg, devices=[dev],
                                     options=options).ids, true_ids)
    lat_s = sorted(lat)
    qps = 32 * SHARD_BATCHES / (sum(lat) / 1e3)
    p50 = statistics.median(lat)
    p95 = lat_s[min(len(lat_s) - 1, int(round(0.95 * (len(lat_s) - 1))))]
    log(f"sharded S={SHARDS} x {idx.base.shape[1]} rows (built in "
        f"{build_s:.2f}s), DeepFM fused int8 on one card: QPS={qps:.1f} "
        f"p50={p50:.3f}ms p95={p95:.3f}ms per batch of 32, recall@10 on 64 "
        f"queries = {rec:.4f} (unsharded serve {unsharded_recall:.4f}), "
        f"{runs:.1f} program runs per batch, {new_programs} programs built "
        f"in the timed batches (PROGRAM_CACHE holds the {SHARDS} shards' "
        f"programs); launches {counts} = the four shards' searches")
    # padded rows: N = 10,001 over 4 shards leaves 3 padded rows
    small = build_sharded_index(base[:10_001], SHARDS, m=24,
                                k_construction=100, device=dev)
    pad = int((small.global_ids < 0).sum())
    res = sharded_search_host(measure, small, batches[1], cfg,
                              devices=[dev], options=options)
    srt = res.ids.sort(dim=1).values
    require(pad == 3 and bool((res.ids >= 0).all())
            and bool((srt[:, 1:] != srt[:, :-1]).all()),
            f"sharded padded: {pad} padded rows; ids {res.ids.tolist()}")
    log(f"sharded padded N=10,001: {pad} padded rows, none returned, rows "
        f"duplicate-free")
    return {"build_s": build_s, "qps": qps, "p50_ms": p50, "p95_ms": p95,
            "recall64": rec, "unsharded_recall64": unsharded_recall,
            "runs_per_batch": runs, "new_programs": new_programs,
            "launches": counts}, idx


def check_index(torch, np, dev, serve_ctx, serve_out, n=INDEX_N):
    """Phase 8: NN-descent on the card against the CPU, a build at Twitch
    scale through NN-descent, the index files round-tripped in every
    residency, served from, and the serve phase's corpus searched in four
    shards; then, in the same temporary directory, phase 10 (paged
    residency over those files and shards, mutation of the serve graph).
    Returns (phase 8's numbers, the 4-shard index, phase 10's numbers)."""
    import tempfile
    parity = check_nn_descent_parity(torch, np, dev)
    graph, exact, build = check_index_build(torch, np, dev, n)
    with tempfile.TemporaryDirectory(prefix="index-") as root:
        dirs, files = check_index_files(torch, np, dev, graph, root)
        served = check_index_serve(torch, np, dev, graph, dirs, exact)
        sharded, idx = check_sharded(torch, np, dev, serve_ctx["fused int8"],
                                     serve_out["fused int8"]["recall64"])
        paged = check_paged(torch, np, dev, graph, dirs, idx,
                            serve_ctx["unfused float32"][3], root)
    return {"nn_descent_parity": parity, "build": build, "files": files,
            "serve": served, "sharded": sharded}, idx, paged


# ---------------------------------------------------------------------------
# phase 9: fault-domain serving (sharded continuous runtime, chaos plans,
# tracing and the metric registry, index epochs, the launcher's flags)
# ---------------------------------------------------------------------------

FD_LANES, FD_SPT, FD_N, FD_PARITY = 32, 8, 320, 64
FD_RUNS = ("fused int8", "mlp fused int8")
FD_DEADLINE_S = 0.25        # tick deadline of the chaos run (b)
FD_PER_ROUND = 2            # requests submitted per round in (b) and (c)


def fd_drive(rt, queries, per_round=FD_PER_ROUND, first_rid=0,
             max_rounds=100_000, on_round=None):
    """Submit ``per_round`` requests per round until every rid resolved;
    each rid must resolve exactly once, within ``max_rounds`` rounds.
    ``on_round(rt)`` runs after each round."""
    i, done = 0, {}
    for _ in range(max_rounds):
        if not (i < len(queries) or rt.in_flight or rt.queued
                or rt._partial or any(r.completions for r in rt.runtimes)):
            return done
        for _ in range(per_round):
            if i < len(queries):
                rt.submit(queries[i], rid=first_rid + i)
                i += 1
        for c in rt.step_once():
            require(c.rid not in done, f"fault domain: rid {c.rid} "
                    f"resolved twice")
            done[c.rid] = c
        if on_round is not None:
            on_round(rt)
    raise SmokeFailure(f"fault domain: {len(done)} of {len(queries)} rids "
                       f"resolved in {max_rounds} rounds")


STRAGGLER = "persistent straggler"    # the straggler monitor's strike


def fd_strike_log(rt) -> list:
    """Every strike of ``rt``'s shard health from now on, as (round,
    shard, reason): a tick error, the tick deadline, or the straggler
    monitor's escalation (``STRAGGLER``)."""
    health, log_ = rt.health, []
    record = health.record_failure

    def logged(shard, reason=""):
        log_.append((rt.n_rounds, shard, reason))
        return record(shard, reason)
    health.record_failure = logged
    return log_


def fd_fresh_metrics(rt):
    from repro_torch.serving import ServingMetrics
    for r in rt.runtimes:
        r.metrics = ServingMetrics(r.n_lanes)
    rt.metrics = ServingMetrics(rt.n_lanes * len(rt.runtimes))


def fd_runs(rt) -> int:
    return sum(r.program.runs["reset"] + r.program.runs["tick"]
               for r in rt.runtimes)


def fd_same(np, c, ref, i) -> bool:
    return (np.array_equal(c.ids, ref["ids"][i])
            and np.array_equal(c.scores, ref["scores"][i])
            and (c.n_eval, c.n_grad, c.n_iters) == tuple(
                int(ref[f][i]) for f in ("n_eval", "n_grad", "n_iters")))


def fd_oneshot(torch, np, dev, measure, idx, queries, cfg, options):
    """The one-shot sharded search of ``queries`` in batches of
    FD_PARITY, as host arrays."""
    from repro_torch.core import sharded_search_stores
    stores = idx.stores(options.corpus_dtype, [dev])
    out = {}
    for b in range(0, len(queries), FD_PARITY):
        res = sharded_search_stores(
            measure, stores, idx,
            torch.as_tensor(queries[b:b + FD_PARITY], device=dev), cfg,
            options)
        for f in res._fields:
            out.setdefault(f, []).append(getattr(res, f).cpu().numpy())
    return {f: np.concatenate(v) for f, v in out.items()}


def fd_healthy(torch, np, dev, ctx, idx, label, queries):
    """(a) A backlog run (capacity) and Poisson arrivals at 0.8x of it,
    every rid ok, the first FD_PARITY the one-shot sharded search's bit for
    bit, no strike, the path's kernels launched as often as the four
    shards' captured tick and reset times their replays."""
    from repro_torch.core import build_engine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (Request, ShardedContinuousRuntime,
                                     poisson_arrivals)
    measure, _, _, _, cfg, options = ctx
    path = KERNELS_OF[(measure.meta[0], options.fused)]
    ref = fd_oneshot(torch, np, dev, measure, idx, queries[:FD_PARITY], cfg,
                     options)
    rt = ShardedContinuousRuntime(build_engine(measure, cfg, options),
                                  measure.params, idx, FD_LANES,
                                  queries.shape[1], steps_per_tick=FD_SPT,
                                  devices=[dev])
    t0 = time.perf_counter()
    rt.warmup(queries[0])
    out = {"warmup_s": time.perf_counter() - t0}
    strikes = fd_strike_log(rt)
    capacity, comps = None, None
    for run in ("backlog", "poisson"):
        offsets = (np.zeros(FD_N) if run == "backlog" else
                   poisson_arrivals(FD_N, 0.8 * capacity, seed=2))
        fd_fresh_metrics(rt)
        runs0 = [dict(r.program.runs) for r in rt.runtimes]
        rounds0, total0 = rt.n_rounds, fd_runs(rt)
        reset_launch_counts()
        del strikes[:]
        got = rt.run_stream([Request(rid=i, query=queries[i],
                                     t_arrive=float(offsets[i]))
                             for i in range(FD_N)])
        counts = launch_counts()
        want = {}
        for r, r0 in zip(rt.runtimes, runs0):
            for name in ("reset", "tick"):
                n = r.program.runs[name] - r0.get(name, 0)
                for k, v in r.program.captured_launches(name).items():
                    want[k] = want.get(k, 0) + v * n
        require({k: v for k, v in counts.items() if v} == want,
                f"fault domain {label} {run}: launches {counts}, the "
                f"shards' captured reset and tick x replays {want}")
        for name, n in counts.items():
            require(n > 0 if name in path else n == 0,
                    f"fault domain {label} {run}: kernel {name} launched "
                    f"{n} times; the path's kernels are {path}")
        by = {c.rid: c for c in got}
        require(len(by) == FD_N and all(c.status == "ok" for c in got),
                f"fault domain {label} {run}: {len(by)} rids, statuses "
                f"{sorted({c.status for c in got})}")
        bad = [i for i in range(FD_PARITY) if not fd_same(np, by[i], ref, i)]
        require(not bad, f"fault domain {label} {run}: rids {bad[:8]} "
                f"differ from the one-shot sharded search")
        require(rt.health.n_opened == 0 and not strikes,
                f"fault domain {label} {run}: strikes {strikes}")
        m = rt.metrics.summary()
        rounds = rt.n_rounds - rounds0
        per_round = (fd_runs(rt) - total0) / rounds
        if run == "backlog":
            capacity, comps = m["qps"], by
        out[run] = {"offered_qps": None if run == "backlog"
                    else 0.8 * capacity, "rounds": rounds,
                    "runs_per_round": per_round, "launches": counts, **m}
        log(f"fault domain {label} {run}: {FD_N} requests over "
            f"{len(rt.runtimes)} shards x {FD_LANES} lanes, throughput "
            f"{m['qps']:.1f} QPS" + ("" if run == "backlog" else
                                     f" at offered {0.8 * capacity:.1f}")
            + f", latency p50={m['p50_ms']:.3f}ms p95={m['p95_ms']:.3f}ms "
            f"p99={m['p99_ms']:.3f}ms, {per_round:.2f} program runs per "
            f"round ({rounds} rounds), occupancy {m['occupancy']:.3f}; "
            f"no strike; the first {FD_PARITY} = one-shot sharded search "
            f"bit for bit; launches {counts} = captured x replays")
    out["capacity_qps"] = capacity
    return out, comps, rt


def fd_chaos(torch, np, dev, ctx, idx, queries, healthy, root):
    """(b) A FaultPlan JSON: shard 1 crashes three ticks running (its
    breaker opens, cools down, re-admits), shard 2 ticks slow (a
    straggler, no strike), shard 3 stalls once under the tick deadline (a
    strike, retried). Every rid resolves once; ok ones equal (a) bit for
    bit; partial ones hold only the live shards' ids."""
    from repro_torch.core import build_engine
    from repro_torch.serving import (FaultEvent, FaultPlan,
                                     ShardedContinuousRuntime)
    measure, _, _, _, cfg, options = ctx
    plan_path = os.path.join(root, "chaos.json")
    FaultPlan([FaultEvent("shard_crash", site="shard:1/tick", start=4,
                          count=3),
               FaultEvent("slow_tick", site="shard:2/tick", start=6,
                          count=3, seconds=0.05),
               FaultEvent("shard_stall", site="shard:3/tick", start=10,
                          count=1)], seed=0).save(plan_path)
    rt = ShardedContinuousRuntime(build_engine(measure, cfg, options),
                                  measure.params, idx, FD_LANES,
                                  queries.shape[1], steps_per_tick=FD_SPT,
                                  tick_deadline_s=FD_DEADLINE_S,
                                  k_failures=3, cooldown_rounds=4,
                                  fault_plan=FaultPlan.load(plan_path),
                                  devices=[dev])
    rt.warmup(queries[0])
    strikes = fd_strike_log(rt)
    states = []         # shard 1's state after each round
    t0 = time.perf_counter()
    got = fd_drive(rt, queries,
                   on_round=lambda r: states.append(r.health.state(1)))
    wall = time.perf_counter() - t0
    opened = states.index("open")
    recovery = states.index("healthy", opened) - opened
    require(sorted(got) == list(range(FD_N)), f"fault domain chaos: "
            f"{len(got)} of {FD_N} rids resolved")
    statuses = collections.Counter(c.status for c in got.values())
    require(statuses["partial"] > 0 and statuses["ok"] > 0
            and set(statuses) <= {"ok", "partial"},
            f"fault domain chaos: statuses {dict(statuses)}")
    final = rt.health.states()
    faults = sorted({s for _, s, r in strikes if r != STRAGGLER})
    drained = [s for _, s, r in strikes if r == STRAGGLER]
    require(rt.health.n_opened >= 1 and final == ["healthy"] * 4,
            f"fault domain chaos: {rt.health.n_opened} breaker opens, "
            f"states {final}, strikes {strikes}")
    require(faults == [1, 3], f"fault domain chaos: error or deadline "
            f"strikes on shards {faults}, expected 1 and 3 ({strikes})")
    dead = idx.global_ids[1]
    for rid, c in got.items():
        if c.status == "ok":
            require(np.array_equal(c.ids, healthy[rid].ids)
                    and np.array_equal(c.scores, healthy[rid].scores),
                    f"fault domain chaos: ok rid {rid} differs from (a)")
        else:
            live = c.ids[c.ids >= 0]
            require(live.size > 0 and not np.isin(live, dead).any(),
                    f"fault domain chaos: partial rid {rid} holds ids "
                    f"of the failed shard: {c.ids}")
    m = rt.metrics.summary()
    out = {"statuses": dict(statuses), "breaker_opens": rt.health.n_opened,
           "partial_share": statuses["partial"] / FD_N,
           "strikes": strikes, "final_states": final,
           "rounds": rt.n_rounds, "open_at_round": opened + 1,
           "recovery_rounds": recovery, "wall_s": wall, **m}
    log(f"fault domain chaos ({plan_path}: shard 1 crashes ticks 4-6, "
        f"shard 2 ticks 6-8 slow by 50 ms, shard 3 stalls at tick 10; "
        f"deadline {FD_DEADLINE_S}s, k_failures 3, cooldown 4 rounds): "
        f"{dict(statuses)}, partial share {out['partial_share']:.3f}, "
        f"{rt.health.n_opened} breaker open(s) (shard 1 open at round "
        f"{opened + 1}, healthy {recovery} rounds later), error or "
        f"deadline strikes on shards {faults}, straggler strikes on "
        f"{drained}, all shards {final[0]} at the end; "
        f"{FD_PER_ROUND} submits per round, {rt.n_rounds} rounds in "
        f"{wall:.2f}s, latency p50={m['p50_ms']:.3f}ms "
        f"p99={m['p99_ms']:.3f}ms; ok = (a) bit for bit, partial rids "
        f"hold no id of shard 1")
    return out


def fd_all_down(torch, np, dev, ctx, idx, queries):
    """(c) Every shard crashes every tick: every rid resolves failed with
    ids -1, and the run ends."""
    from repro_torch.core import build_engine
    from repro_torch.serving import (FaultEvent, FaultPlan,
                                     ShardedContinuousRuntime)
    measure, _, _, _, cfg, options = ctx
    plan = FaultPlan([FaultEvent("shard_crash", site=f"shard:{s}/tick",
                                 start=0, count=10 ** 6)
                      for s in range(idx.n_shards)])
    rt = ShardedContinuousRuntime(build_engine(measure, cfg, options),
                                  measure.params, idx, FD_LANES,
                                  queries.shape[1], steps_per_tick=FD_SPT,
                                  k_failures=1, cooldown_rounds=1000,
                                  fault_plan=plan, devices=[dev])
    rt.warmup(queries[0])
    got = fd_drive(rt, queries[:FD_LANES])
    require(len(got) == FD_LANES and all(
        c.status == "failed" and (c.ids == -1).all()
        and np.isneginf(c.scores).all() for c in got.values()),
        f"fault domain all down: statuses "
        f"{collections.Counter(c.status for c in got.values())}")
    require(rt.health.states() == ["open"] * idx.n_shards,
            f"fault domain all down: states {rt.health.states()}")
    log(f"fault domain all down: {len(got)} rids failed with ids -1 in "
        f"{rt.n_rounds} rounds, every breaker open")
    return {"failed": len(got), "rounds": rt.n_rounds}


def fd_traced(torch, np, dev, ctx, idx, queries, healthy, untraced_qps):
    """(d) A traced backlog run (every rid sampled) with the registry
    bound: bit for bit (a), attribution >= 0.95 for every ok rid (the
    phase spans with the runtime's own site spans; the phase spans alone
    are reported beside), the registry's text carries the ok count and
    four shard states."""
    from repro_torch.core import build_engine
    from repro_torch.obs import Registry, Tracer, attribution
    from repro_torch.serving import Request, ShardedContinuousRuntime
    from repro_torch.serving.runtime import TRACE_SITES
    measure, _, _, _, cfg, options = ctx
    tracer = Tracer(sample=1, capacity=1 << 20)
    rt = ShardedContinuousRuntime(build_engine(measure, cfg, options),
                                  measure.params, idx, FD_LANES,
                                  queries.shape[1], steps_per_tick=FD_SPT,
                                  tracer=tracer, devices=[dev])
    rt.warmup(queries[0])
    registry = rt.bind_registry(Registry())
    got = {c.rid: c for c in rt.run_stream(
        [Request(rid=i, query=queries[i]) for i in range(FD_N)])}
    qps = rt.metrics.summary()["qps"]
    for rid in range(FD_N):
        c, h = got[rid], healthy[rid]
        require(c.status == "ok" and np.array_equal(c.ids, h.ids)
                and np.array_equal(c.scores, h.scores)
                and (c.n_eval, c.n_iters) == (h.n_eval, h.n_iters),
                f"fault domain traced: rid {rid} differs from (a)")
    spans = tracer.spans()
    require(tracer.n_emitted == len(spans), f"fault domain traced: the "
            f"ring dropped {tracer.n_emitted - len(spans)} spans")
    by_rid = collections.defaultdict(list)
    for sp in spans:
        by_rid[sp.rid].append(sp)
    sited = [sp for sp in by_rid[None] if sp.site in TRACE_SITES]
    cover = [attribution(by_rid[rid] + sited, rid, TRACE_SITES)["coverage"]
             for rid in range(FD_N)]
    phases = [attribution(by_rid[rid], rid)["coverage"]
              for rid in range(FD_N)]
    require(min(cover) >= 0.95, f"fault domain traced: attribution "
            f"{min(cover):.4f} < 0.95 for rid {int(np.argmin(cover))}")
    text = registry.render_text()
    require(f'repro_serving_requests_total{{status="ok"}} {FD_N}' in text
            and text.count("repro_health_shard_state{") == idx.n_shards,
            "fault domain traced: the registry lacks the ok count or the "
            "shard states")
    log(f"fault domain traced (sample 1, {len(spans)} spans): "
        f"{qps:.1f} QPS traced against {untraced_qps:.1f} untraced "
        f"(ratio {qps / untraced_qps:.3f}); bit for bit (a); attribution "
        f"min {min(cover):.4f} median {statistics.median(cover):.4f} (the "
        f"phase spans alone: min {min(phases):.4f} median "
        f"{statistics.median(phases):.4f}; the site spans "
        f"{len(sited)}); "
        f"registry: {FD_N} ok, {idx.n_shards} shard-state series")
    return {"qps_traced": qps, "qps_untraced": untraced_qps,
            "ratio": qps / untraced_qps, "spans": len(spans),
            "coverage_min": min(cover),
            "coverage_median": statistics.median(cover),
            "phase_coverage_min": min(phases),
            "phase_coverage_median": statistics.median(phases)}


def fd_epochs(torch, np, dev, ctx, idx, queries, healthy, rt):
    """(e) A second 4-shard index of the same corpus (another partition
    seed) installed mid-stream on (a)'s runtime: the 32 rids admitted
    before the install finish on epoch 0 as in (a), the rest run on epoch 1
    as the one-shot sharded search of the new index; each epoch captures
    its shards' reset and tick once; two more swaps (back, and to the new
    index again) leave the device memory where the first left it, within
    one epoch's buffers."""
    import gc
    from repro_torch.core import build_sharded_index
    measure, _, _, graph, cfg, options = ctx
    t0 = time.perf_counter()
    idx2 = build_sharded_index(graph.base, SHARDS, m=24, k_construction=100,
                               seed=1, device=dev)
    build_s = time.perf_counter() - t0
    ref2 = fd_oneshot(torch, np, dev, measure, idx2, queries, cfg, options)
    for i in range(FD_LANES):
        rt.submit(queries[i], rid=i)
    rt.step_once()          # every shard admits the 32
    require(rt.install_index(idx2) == 1, "fault domain epochs: staged "
            "epoch is not 1")
    got = {c.rid: c for c in rt.pop_completions()}
    got.update(fd_drive(rt, queries[FD_LANES:], per_round=FD_N,
                        first_rid=FD_LANES))
    while rt.in_flight or rt._partial or any(r.completions
                                              for r in rt.runtimes):
        got.update({c.rid: c for c in rt.step_once()})
    require(sorted(got) == list(range(FD_N)), "fault domain epochs: rids "
            "missing")
    for rid, c in got.items():
        if rid < FD_LANES:
            ok = c.epoch == 0 and np.array_equal(c.ids, healthy[rid].ids) \
                and np.array_equal(c.scores, healthy[rid].scores)
        else:
            ok = c.epoch == 1 and fd_same(np, c, ref2, rid)
        require(c.status == "ok" and ok, f"fault domain epochs: rid {rid} "
                f"(epoch {c.epoch}) differs from its epoch's search")
    pairs = ("reset", "tick")
    require(all(r.epoch_captures == [pairs] and r.program.captured == pairs
                for r in rt.runtimes), f"fault domain epochs: captures "
            f"{[(r.epoch_captures, r.program.captured) for r in rt.runtimes]}")

    def settle():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(dev)

    def epoch_bytes():
        return sum(t.numel() * t.element_size() for r in rt.runtimes
                   for t in list(r.program.state)
                   + list(r.program.buffers.values()))

    mem = [settle()]
    for target in (idx, idx2):
        rt.install_index(target)
        fd_drive(rt, queries[:FD_PARITY], per_round=FD_PARITY,
                 first_rid=FD_N)
        mem.append(settle())
    slack = epoch_bytes()
    require(mem[2] <= mem[0] + slack, f"fault domain epochs: device memory "
            f"{mem[0]} after the first swap, {mem[2]} after the third "
            f"(one epoch's buffers {slack})")
    require(all(r.epoch == 3 and len(r.epoch_captures) == 3
                and all(c == pairs for c in r.epoch_captures)
                for r in rt.runtimes), "fault domain epochs: captures per "
            "epoch")
    log(f"fault domain epochs: second index built in {build_s:.2f}s; "
        f"epochs 0/1 in one stream ({FD_LANES} rids on epoch 0 = (a), "
        f"{FD_N - FD_LANES} on epoch 1 = one-shot on the new index, bit "
        f"for bit); reset + tick captured once per shard per epoch; device "
        f"memory after swaps 1/2/3: {mem[0]}/{mem[1]}/{mem[2]} bytes (one "
        f"epoch's buffers {slack})")
    return {"build_s": build_s, "memory_after_swaps": mem,
            "epoch_buffer_bytes": slack}


def fd_launcher(torch, np, dev, root, items=100_000):
    """(f) ``serve --runtime continuous --fused --corpus-dtype int8`` at the
    serve phase's settings with a chaos plan, tracing, the registry, the
    health line and the profiler: every output file exists and parses."""
    from repro_torch.launch import serve
    from repro_torch.serving import FaultEvent, FaultPlan
    plan = os.path.join(root, "serve_chaos.json")
    FaultPlan([FaultEvent("slow_tick", site="tick", start=3, count=2,
                          seconds=0.001)]).save(plan)
    paths = {k: os.path.join(root, v) for k, v in (
        ("trace", "spans.jsonl"), ("prom", "metrics.prom"),
        ("json", "metrics.json"), ("prof", "profile"))}
    t0 = time.perf_counter()
    summary = serve.main([
        "--runtime", "continuous", "--fused", "--corpus-dtype", "int8",
        "--items", str(items), "--dim", "40", "--queries", str(FD_N),
        "--ef", "64", "--budget", "8", "--alpha", "1.01", "--k", "10",
        "--lanes", str(FD_LANES), "--steps-per-tick", str(FD_SPT),
        "--offered-qps", "1000", "--device", str(dev), "--chaos", plan,
        "--health-every", "0.1", "--trace-sample", "4",
        "--trace-out", paths["trace"], "--metrics-out", paths["prom"],
        "--metrics-json", paths["json"], "--profile-dir", paths["prof"]])
    wall = time.perf_counter() - t0
    spans = [json.loads(line) for line in open(paths["trace"])]
    prom = open(paths["prom"]).read()
    metrics = json.load(open(paths["json"]))
    trace = json.load(open(os.path.join(paths["prof"], "trace.json")))
    names = {e.get("name") for e in trace["traceEvents"]}
    roots = {sp["rid"] for sp in spans if sp["name"] == "request"}
    require(summary["statuses"] == {"ok": FD_N} and roots == set(
        range(0, FD_N, 4)) and f'repro_serving_requests_total{{status='
            f'"ok"}} {FD_N}' in prom and metrics["n_completed"] == FD_N
            and {"repro/tick", "repro/reset"} <= names,
            f"fault domain launcher: statuses {summary['statuses']}, "
            f"{len(roots)} traced roots, {metrics.get('n_completed')} in "
            f"the metrics json, profile names repro/* "
            f"{sorted(n for n in names if str(n).startswith('repro/'))}")
    kernels = sum(1 for e in trace["traceEvents"]
                  if e.get("cat") == "kernel")
    log(f"fault domain launcher: serve --runtime continuous --fused "
        f"--corpus-dtype int8 at N=100,000 with --chaos, --trace-*, "
        f"--metrics-*, --health-every, --profile-dir in {wall:.1f}s: "
        f"{summary['qps']:.1f} QPS at offered 1000, p99 "
        f"{summary['p99_ms']:.3f}ms, recall@10 {summary['recall']:.4f}; "
        f"{len(spans)} spans, {len(prom.splitlines())} Prometheus lines, "
        f"profiler trace {len(trace['traceEvents'])} events "
        f"({kernels} device kernels)")
    return {"wall_s": wall, "qps": summary["qps"],
            "p99_ms": summary["p99_ms"], "recall": summary["recall"],
            "spans": len(spans), "profile_events": len(trace["traceEvents"]),
            "profile_kernels": kernels}


def check_fault_domain(torch, np, dev, ctx, idx):
    """Phase 9: the sharded continuous runtime over the index phase's
    4-shard index of the serve corpus (N=100,000), 32 lanes per shard, 8
    steps per tick, 320 requests: (a) healthy, DeepFM and MLP fused int8;
    (b) a chaos plan; (c) every shard down; (d) traced with the registry;
    (e) index epochs; (f) the launcher's telemetry and chaos flags."""
    import tempfile
    queries = np.random.default_rng(13).normal(
        size=(FD_N, 40)).astype(np.float32)
    t_phase = time.perf_counter()
    out, healthy, rts, secs = {}, {}, {}, {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        secs[name] = time.perf_counter() - t0

    for label in FD_RUNS:
        part(label, fd_healthy, torch, np, dev, ctx[label], idx, label,
             queries)
        out[label], healthy[label], rts[label] = out[label]
    deepfm = ctx[FD_RUNS[0]]
    with tempfile.TemporaryDirectory(prefix="fault-domain-") as root:
        part("chaos", fd_chaos, torch, np, dev, deepfm, idx, queries,
             healthy[FD_RUNS[0]], root)
        part("all_down", fd_all_down, torch, np, dev, deepfm, idx, queries)
        part("traced", fd_traced, torch, np, dev, deepfm, idx, queries,
             healthy[FD_RUNS[0]], out[FD_RUNS[0]]["capacity_qps"])
        del rts[FD_RUNS[1]]
        part("epochs", fd_epochs, torch, np, dev, deepfm, idx, queries,
             healthy[FD_RUNS[0]], rts.pop(FD_RUNS[0]))
        part("launcher", fd_launcher, torch, np, dev, root)
    out["seconds"] = time.perf_counter() - t_phase
    out["seconds_by_part"] = secs
    log(f"fault domain: phase 9 passed in {out['seconds']:.1f}s ("
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# phase 10: paged corpus residency and streaming index mutation
# ---------------------------------------------------------------------------

PAGED_ROWS, PAGED_MB = 64, 16       # 64-row pages, a 16 MiB host budget
PAGED_GATHER = 10_000               # ids of the gather check (a)
# (label, saved dtype, launcher flags, page rows, cache MiB): the one-shot
# serves (b), DeepFM unless --measure says otherwise
PAGED_RUNS = (
    ("unfused float32", "float32", [], PAGED_ROWS, PAGED_MB),
    ("fused float32", "float32", ["--fused"], PAGED_ROWS, PAGED_MB),
    ("fused bfloat16", "bfloat16", ["--fused", "--corpus-dtype",
                                    "bfloat16"], PAGED_ROWS, PAGED_MB),
    ("fused int8", "int8", ["--corpus-dtype", "int8"], PAGED_ROWS, PAGED_MB),
    ("mlp unfused float32", "float32", ["--measure", "mlp"], PAGED_ROWS,
     PAGED_MB),
    ("unfused float32 at the defaults", "float32", [], 4096, 64),
)
# the sharded checks (d): a budget below a 25,000-row partition's int8
# payload (1.1 MB), so pages keep faulting after the warm-up
SHARD_PAGED_KB = 256
PAGED_SHARD_N = 64                  # requests of each sharded run
MUTATE_ROWS = 8192                  # rows inserted (e)
MUTATE_QUERIES = 64


def peak_reset(torch, dev) -> int:
    """Reset the card's peak-memory counter; returns the bytes allocated
    now (what the measured work's peak is taken above)."""
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return int(torch.cuda.memory_allocated(dev))


def peak_bytes(torch, dev, before: int) -> int:
    """The card's peak allocated bytes since ``peak_reset`` above
    ``before``."""
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev)) - before


def paged_policy(page_rows=PAGED_ROWS, cache_bytes=PAGED_MB << 20, **kw):
    from repro_torch.core import ResidencyPolicy
    return ResidencyPolicy("paged", page_rows, cache_bytes, **kw)


def paged_gather(torch, np, dev, dirs):
    """(a) In each residency, a paged store over the memory-mapped v3
    files gathers PAGED_GATHER seeded ids equal, bit for bit, to the whole
    store loaded from the same files."""
    from repro_torch.graph import load_corpus_store
    out = {}
    for dtype in RESIDENCIES:
        paged = load_corpus_store(dirs[dtype], residency=paged_policy(),
                                  device=dev)
        whole = load_corpus_store(dirs[dtype], device=dev)
        ids = torch.as_tensor(np.random.default_rng(3).integers(
            0, whole.n, PAGED_GATHER), device=dev)
        t0 = time.perf_counter()
        rows = paged.take(ids)
        gather_s = time.perf_counter() - t0
        require(torch.equal(rows, whole.take(ids)), f"paged gather "
                f"{dtype}: rows differ from the whole store's")
        st = paged.stats_snapshot()
        out[dtype] = {"gather_s": gather_s, "faults": st.faults,
                      "peak_resident_bytes": st.peak_resident_bytes}
        log(f"paged (a) {dtype}: {PAGED_GATHER} ids from the memory-mapped "
            f"files = the whole store bit for bit; gather {gather_s * 1e3:.1f}"
            f"ms, {st.faults} faults, peak resident "
            f"{st.peak_resident_bytes / 2**20:.2f} MiB")
    return out


def paged_serve(torch, np, dev, graph, dirs):
    """(b) ``serve --index DIR --residency paged`` per PAGED_RUNS at the
    serve phase's settings: each run's ids, scores and counters equal, bit
    for bit, the whole-resident serve of the same files on the unfused
    path at its dtype (and, at float32, the fused one); against the whole
    fused serve at bf16/int8 the share of equal ids and recall are logged.
    Each run launches its family's pre-gathered kernels only: the rank
    and grad kernels once per step, the score kernel once per step and
    once per batch (init). The pager's peak footprint stays within its
    budget plus one gather's pages (Q x (1+B) ids)."""
    from repro_torch.core import (EngineOptions, SearchConfig,
                                  make_family_measure)
    from repro_torch.graph import load_corpus_store
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    common = ["--queries", "320", "--batch", "32", "--ef", "64", "--budget",
              "8", "--alpha", "1.01", "--k", "10", "--device", str(dev)]
    base_t = torch.as_tensor(graph.base, device=dev)
    nbrs = torch.as_tensor(graph.neighbors, device=dev)
    gather_ids = 32 * (1 + graph.max_degree)
    out = {}
    for label, dtype, extra, rows, mb in PAGED_RUNS:
        argv = (common + ["--index", dirs[dtype]] + extra
                + ["--residency", "paged", "--page-rows", str(rows),
                   "--cache-mb", str(mb)])
        args = serve.parse_args(argv)
        args.items, args.dim = graph.base.shape
        options = serve.engine_options(args)
        family = args.measure
        got = []
        before = peak_reset(torch, dev)
        reset_launch_counts()
        summary = serve.main(argv, results=got)
        counts = launch_counts()
        mem_paged = peak_bytes(torch, dev, before)
        path = KERNELS_OF[(family, False)]
        score, rank, grad = path
        for name, n in counts.items():
            require(n > 0 if name in path else n == 0,
                    f"paged serve {label}: kernel {name} launched {n} "
                    f"times; the pre-gathered path's kernels are {path}")
        require(counts[rank] == counts[grad] == counts[score] - len(got),
                f"paged serve {label}: launches {counts} are not one per "
                f"step (+1 score per batch of {len(got)})")
        # the whole-resident serve of the same files with the same flags
        whole_argv = argv[:argv.index("--residency")]
        same_flags = []
        before = peak_reset(torch, dev)
        w_summ = serve.main(whole_argv, results=same_flags)
        mem_whole = peak_bytes(torch, dev, before)
        if options.fused:
            # the unfused path at this dtype, the one a paged store runs
            measure = make_family_measure(
                family, torch.Generator().manual_seed(0), 40, device=dev)
            cfg = SearchConfig(k=args.k, ef=args.ef, mode=args.mode,
                               budget=args.budget, alpha=args.alpha)
            unfused = []
            serve.serve_oneshot(
                args, graph, measure, cfg,
                EngineOptions(fused=False, corpus_dtype=dtype),
                load_corpus_store(dirs[dtype], device=dev), nbrs, base_t,
                np.random.default_rng(0), dev, results=unfused)
        else:
            unfused = same_flags
        require(len(got) == len(unfused) == 10 and all(
            same_result(torch, a, b) for a, b in zip(got, unfused)),
            f"paged serve {label}: results differ from the whole unfused "
            f"serve of the same files")
        entry = {**summary, "launches": counts,
                 "device_bytes": mem_paged, "whole_device_bytes": mem_whole,
                 "whole_qps": w_summ["qps"], "whole_p50_ms": w_summ["p50_ms"]}
        vs_fused = ""
        if options.fused:
            agree = float(np.mean([
                float((a.ids == b.ids).float().mean())
                for a, b in zip(got, same_flags)]))
            exact = all(same_result(torch, a, b)
                        for a, b in zip(got, same_flags))
            if dtype == "float32":
                require(exact, f"paged serve {label}: results differ from "
                        f"the whole fused serve at float32")
            entry.update(fused_equal=exact, fused_ids_agree=agree,
                         fused_recall=w_summ["recall"])
            vs_fused = (f"; against the whole fused serve: "
                        f"{'bit for bit' if exact else 'differs'}, ids "
                        f"agree {agree:.4f}, recall@10 {w_summ['recall']:.4f}"
                        f" vs {summary['recall']:.4f}")
        pg = summary["pager"]
        page_bytes = rows * row_bytes(dtype, 40)
        budget = mb << 20
        require(pg["peak_resident_bytes"] <= budget + gather_ids * page_bytes,
                f"paged serve {label}: peak resident "
                f"{pg['peak_resident_bytes']} B > budget {budget} + one "
                f"gather's {gather_ids} pages of {page_bytes} B")
        us = summary["paged_us_per_step"]
        hit_rate = pg["hits"] / max(1, pg["hits"] + pg["faults"])
        log(f"paged (b) {label} ({dtype} files, {rows}-row pages, {mb} MiB):"
            f" QPS={summary['qps']:.1f} p50={summary['p50_ms']:.3f}ms "
            f"p95={summary['p95_ms']:.3f}ms per batch of 32 (whole "
            f"{w_summ['qps']:.1f} QPS, p50 {w_summ['p50_ms']:.3f}ms), "
            f"{summary['steps_per_batch']:.1f} steps per batch; host us per "
            f"step: replays {us['replay']:.1f}, ids sync {us['sync']:.1f}, "
            f"pager gather {us['gather']:.1f}, tile copy {us['h2d']:.1f}; "
            f"pager hits {pg['hits']} faults {pg['faults']} evictions "
            f"{pg['evictions']} hit rate {hit_rate:.4f} peak resident "
            f"{pg['peak_resident_bytes'] / 2**20:.2f} MiB; device memory "
            f"the serve allocates (max_memory_allocated above what was "
            f"allocated before it) paged {mem_paged / 2**20:.1f} MiB, whole "
            f"{mem_whole / 2**20:.1f} MiB; = the whole unfused serve bit for "
            f"bit{vs_fused}; launches {counts}")
        out[label] = entry
    return out


def paged_continuous(torch, np, dev, graph, dirs):
    """(c) ContinuousRuntime over the paged int8 store of the saved files
    (32 lanes, 8 steps per tick, 320 requests: a backlog, then Poisson at
    0.8x its throughput): every completion equals the whole-resident int8
    runtime's (unfused: the path a paged store runs) bit for bit."""
    from repro_torch.core import EngineOptions, build_engine
    from repro_torch.graph import load_corpus_store
    from repro_torch.serving import (ContinuousRuntime, Request,
                                     ServingMetrics, poisson_arrivals)
    from repro_torch.core import SearchConfig, make_family_measure
    measure = make_family_measure("deepfm", torch.Generator().manual_seed(0),
                                  40, device=dev)
    cfg = SearchConfig(k=10, ef=64, budget=8, alpha=1.01)
    eng = build_engine(measure, cfg, EngineOptions(corpus_dtype="int8"))
    queries = np.random.default_rng(11).normal(
        size=(CONTINUOUS_N, 40)).astype(np.float32)

    def runtime(store):
        rt = ContinuousRuntime(eng, measure.params, store, graph.neighbors,
                               n_lanes=CONTINUOUS_LANES, query_dim=40,
                               entry=graph.entry,
                               steps_per_tick=CONTINUOUS_SPT, device=dev)
        rt.warmup(queries[0])
        return rt
    whole_rt = runtime(load_corpus_store(dirs["int8"], device=dev))
    want = {c.rid: c for c in whole_rt.run_stream(
        [Request(rid=i, query=queries[i]) for i in range(CONTINUOUS_N)])}
    rt = runtime(load_corpus_store(dirs["int8"], residency=paged_policy(),
                                   device=dev))
    out, capacity = {}, None
    for run in ("backlog", "poisson"):
        offsets = (np.zeros(CONTINUOUS_N) if run == "backlog" else
                   poisson_arrivals(CONTINUOUS_N, 0.8 * capacity, seed=1))
        rt.metrics = ServingMetrics(CONTINUOUS_LANES)
        runs0, ticks0 = sum(rt.program.runs.values()), rt._n_ticks
        comps = rt.run_stream([Request(rid=i, query=queries[i],
                                       t_arrive=float(offsets[i]))
                               for i in range(CONTINUOUS_N)])
        by = {c.rid: c for c in comps}
        require(len(by) == CONTINUOUS_N and all(c.status == "ok"
                                                 for c in comps),
                f"paged continuous {run}: {len(by)} resolved, statuses "
                f"{sorted({c.status for c in comps})}")
        for i in range(CONTINUOUS_N):
            a, b = by[i], want[i]
            require(np.array_equal(a.ids, b.ids)
                    and np.array_equal(a.scores, b.scores)
                    and (a.n_eval, a.n_grad, a.n_iters)
                    == (b.n_eval, b.n_grad, b.n_iters),
                    f"paged continuous {run}: request {i} differs from the "
                    f"whole-resident runtime's")
        m = rt.metrics.summary()
        ticks = rt._n_ticks - ticks0
        runs = (sum(rt.program.runs.values()) - runs0) / max(1, ticks)
        if run == "backlog":
            capacity = m["qps"]
        st = rt.store.stats_snapshot()
        out[run] = {**m, "runs_per_tick": runs, "ticks": ticks,
                    "pager_hit_rate": st.hit_rate}
        log(f"paged (c) continuous int8 {run}: {CONTINUOUS_N} requests, "
            f"throughput {m['qps']:.1f} QPS"
            + ("" if run == "backlog" else
               f" at offered {0.8 * capacity:.1f}")
            + f", latency p50={m['p50_ms']:.3f}ms p99={m['p99_ms']:.3f}ms, "
            f"{runs:.2f} program runs per tick over {ticks} ticks, pager "
            f"hit rate {st.hit_rate:.4f}; every completion = the whole "
            f"int8 runtime's bit for bit")
    out["capacity_qps"] = capacity
    return out


def paged_sharded(torch, np, dev, idx):
    """(d) The phase 8 4-shard index (DeepFM int8 on the pre-gathered
    path): ``sharded_search_stores`` over paged shard stores = over whole
    ones bit for bit; then ``ShardedContinuousRuntime`` over paged shards
    (64-row pages, SHARD_PAGED_KB each) with page-read faults on shard 1
    (installed after the warm-up): transient errors absorbed by retries,
    persistent ones degrading to the whole host copy (answers unchanged
    bit for bit), and, with ``fallback_bytes`` below the payload, a
    ``CorpusUnavailableError`` that strikes shard 1 until its breaker
    opens, the partial answers free of its ids."""
    from repro_torch.core import (EngineOptions, SearchConfig, build_engine,
                                  make_family_measure, shard_stores,
                                  sharded_search_stores)
    from repro_torch.serving import (FaultEvent, FaultPlan,
                                     ShardedContinuousRuntime)
    measure = make_family_measure("deepfm", torch.Generator().manual_seed(0),
                                  40, device=dev)
    cfg = SearchConfig(k=10, ef=64, budget=8, alpha=1.01)
    options = EngineOptions(corpus_dtype="int8")
    queries = np.random.default_rng(13).normal(
        size=(PAGED_SHARD_N, 40)).astype(np.float32)
    paged = shard_stores(idx, "int8", devices=[dev], residency=paged_policy(
        cache_bytes=SHARD_PAGED_KB << 10))
    whole = idx.stores("int8", [dev])
    qt = torch.as_tensor(queries[:32], device=dev)
    a = sharded_search_stores(measure, paged, idx, qt, cfg, options)
    b = sharded_search_stores(measure, whole, idx, qt, cfg, options)
    require(same_result(torch, a, b), "paged sharded: sharded_search_stores "
            "over paged shards differs from over whole ones")
    log(f"paged (d) sharded_search_stores over {idx.n_shards} paged shards "
        f"= over whole ones bit for bit (32 queries)")
    eng = build_engine(measure, cfg, options)

    def run(name, events, fallback_bytes=None):
        pol = paged_policy(cache_bytes=SHARD_PAGED_KB << 10,
                           retry_backoff_s=0.0,
                           fallback_bytes=fallback_bytes)
        rt = ShardedContinuousRuntime(eng, measure.params, idx, FD_LANES,
                                      40, steps_per_tick=FD_SPT,
                                      k_failures=3, cooldown_rounds=4,
                                      devices=[dev], residency=pol)
        rt.warmup(queries[0])
        if events:
            rt.runtimes[1].store.set_read_hook(
                FaultPlan(events, seed=0).pager_hook("pager"))
        got = fd_drive(rt, queries)
        require(sorted(got) == list(range(PAGED_SHARD_N)),
                f"paged sharded {name}: {len(got)} rids resolved")
        st = rt.runtimes[1].store.stats_snapshot()
        return rt, got, st
    _, healthy, _ = run("healthy", [])
    require(all(c.status == "ok" for c in healthy.values()),
            "paged sharded healthy: not every rid ok")
    out = {}
    for name, events, fb in (
            ("transient", [FaultEvent("page_io_error", site="pager",
                                      start=0, count=2)], None),
            ("persistent", [FaultEvent("page_io_error", site="pager",
                                       start=0, count=10**9)], None),
            ("unavailable", [FaultEvent("page_io_error", site="pager",
                                        start=0, count=10**9)], 1)):
        rt, got, st = run(name, events, fb)
        statuses = collections.Counter(c.status for c in got.values())
        if name != "unavailable":
            require(all(c.status == "ok" for c in got.values()) and all(
                np.array_equal(c.ids, healthy[r].ids)
                and np.array_equal(c.scores, healthy[r].scores)
                for r, c in got.items()),
                f"paged sharded {name}: answers differ from the healthy "
                f"run ({dict(statuses)})")
        if name == "transient":
            require(st.retries > 0 and st.fallback == "",
                    f"paged sharded transient: {st}")
        elif name == "persistent":
            require(st.fallback == "whole" and st.io_errors > 0,
                    f"paged sharded persistent: {st}")
        else:
            dead = idx.global_ids[1]
            require(rt.health.n_opened >= 1 and statuses["partial"] > 0,
                    f"paged sharded unavailable: {rt.health.n_opened} "
                    f"opens, {dict(statuses)}")
            for c in got.values():
                live = c.ids[c.ids >= 0]
                require(c.status == "ok" or not np.isin(live, dead).any(),
                        f"paged sharded unavailable: rid {c.rid} "
                        f"({c.status}) holds ids of shard 1")
        out[name] = {"statuses": dict(statuses), "retries": st.retries,
                     "io_errors": st.io_errors, "fallback": st.fallback,
                     "breaker_opens": rt.health.n_opened}
        log(f"paged (d) sharded continuous, shard 1 {name}: "
            f"{dict(statuses)}, shard 1 pager retries {st.retries} "
            f"io_errors {st.io_errors} mode {st.fallback or 'paged'}, "
            f"breaker opens {rt.health.n_opened}"
            + ("" if name == "unavailable" else
               "; answers = the healthy run bit for bit"))
    return out


def paged_mutation(torch, np, dev, graph, root):
    """(e) Streaming mutation of the serve phase's N=100,000 graph:
    ``DurableIndex.create``, an insert of MUTATE_ROWS seeded N(0,1) rows
    (seconds, rows/s), a checkpoint; recall@10 of the grown index at least
    an exact rebuild's over the same rows less 0.01; the whole search's
    top-3 answers of MUTATE_QUERIES queries deleted, never returned by a
    paged search of the checkpoint; compact round-trips through v3; a kill
    at each of the four durability stages of the delete recovers exactly
    the uninterrupted index; ``install_index`` of the grown index into a
    running paged runtime: lanes in flight finish on epoch 0, epoch 1
    answers = the one-shot search of the new index bit for bit."""
    import shutil
    from repro_torch.core import (EngineOptions, SearchConfig,
                                  brute_force_topk, build_engine,
                                  make_corpus_store, make_family_measure,
                                  recall)
    from repro_torch.graph import (DurableIndex, build_l2_graph, compact,
                                   load_corpus_store, load_index, save_index)
    from repro_torch.serving import (ContinuousRuntime, FaultEvent,
                                     FaultPlan, InjectedKill)
    measure = make_family_measure("deepfm", torch.Generator().manual_seed(0),
                                  40, device=dev)
    cfg = SearchConfig(k=10, ef=64, budget=8, alpha=1.01)
    eng = build_engine(measure, cfg, EngineOptions())
    q = torch.as_tensor(np.random.default_rng(17).normal(
        size=(MUTATE_QUERIES, 40)).astype(np.float32), device=dev)
    new = np.random.default_rng(19).normal(
        size=(MUTATE_ROWS, 40)).astype(np.float32)

    def search(g, store=None):
        store = store if store is not None else make_corpus_store(
            g.base, device=dev, tombstones=g.tombstones)
        return eng.search(measure.params, store,
                          torch.as_tensor(g.neighbors, device=dev), q,
                          torch.full((q.shape[0],), g.entry, device=dev))

    path = os.path.join(root, "mutate")
    t0 = time.perf_counter()
    d = DurableIndex.create(path, graph, device=dev)
    create_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grown = d.insert(new)
    insert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d.checkpoint()
    ckpt_s = time.perf_counter() - t0
    require(grown.n == graph.n + MUTATE_ROWS, f"mutate: {grown.n} rows")
    t0 = time.perf_counter()
    rebuilt = build_l2_graph(grown.base, m=24, k_construction=100,
                             exact_threshold=grown.n, device=dev)
    rebuild_s = time.perf_counter() - t0
    base_t = torch.as_tensor(grown.base, device=dev)
    true_ids = brute_force_topk(measure, base_t, q, 10)[0]
    r_inc = recall(search(grown).ids, true_ids)
    r_reb = recall(search(rebuilt).ids, true_ids)
    log(f"paged (e) mutation N={graph.n}: create {create_s:.2f}s, insert "
        f"{MUTATE_ROWS} rows in {insert_s:.2f}s ({MUTATE_ROWS / insert_s:.0f}"
        f" rows/s), checkpoint {ckpt_s:.2f}s; recall@10 on "
        f"{MUTATE_QUERIES} queries: grown {r_inc:.4f}, exact rebuild "
        f"{r_reb:.4f} (built in {rebuild_s:.2f}s)")
    require(r_inc >= r_reb - 0.01, f"mutate: recall@10 of the grown index "
            f"{r_inc:.4f} < the exact rebuild's {r_reb:.4f} - 0.01")
    # the delete, under the kill matrix
    victims = np.unique(search(grown).ids[:, :3].cpu().numpy())
    victims = victims[victims >= 0]
    snapshot = os.path.join(root, "mutate-s0")
    shutil.copytree(path, snapshot)
    t0 = time.perf_counter()
    final = d.delete(victims)
    delete_s = time.perf_counter() - t0
    d.checkpoint()

    def same_index(a, b):
        ta = np.zeros(a.n, bool) if a.tombstones is None else a.tombstones
        tb = np.zeros(b.n, bool) if b.tombstones is None else b.tombstones
        return (np.array_equal(a.base, b.base)
                and np.array_equal(a.neighbors, b.neighbors)
                and a.entry == b.entry and np.array_equal(ta, tb))
    for stage in ("pre-journal", "post-journal", "pre-save", "post-save"):
        kdir = os.path.join(root, f"mutate-kill-{stage}")
        shutil.copytree(snapshot, kdir)
        plan = FaultPlan([FaultEvent("kill", site=f"mutate/{stage}")])
        k = DurableIndex.open(kdir, kill_hook=plan.kill_hook(), device=dev)
        try:
            k.delete(victims)
            k.checkpoint()
            raise SmokeFailure(f"mutate: no kill at {stage}")
        except InjectedKill:
            pass
        r = DurableIndex.open(kdir, device=dev)
        if len(r.journal.ops) < len(d.journal.ops):
            r.delete(victims)       # a pre-journal death lost the op
        require(same_index(r.index, final), f"mutate: recovery after a "
                f"kill at {stage} differs from the uninterrupted index")
        shutil.rmtree(kdir)
    # paged serve of the checkpoint never returns a deleted row
    paged = load_corpus_store(path, residency=paged_policy(), device=dev)
    ids = search(final, paged).ids.cpu().numpy()
    require(not np.isin(ids[ids >= 0], victims).any() and (ids >= 0).any(),
            "mutate: a deleted row surfaced in the paged search")
    # compact round-trips through v3
    small = compact(final)
    cdir = os.path.join(root, "mutate-compact")
    save_index(cdir, small)
    back = load_index(cdir)
    require(same_index(back, small) and small.n == final.n - victims.size,
            "mutate: compact did not round-trip through v3")
    # install_index of the grown index into a running paged runtime
    rt = ContinuousRuntime(eng, measure.params,
                           make_corpus_store(graph.base, device=dev,
                                             residency=paged_policy()),
                           graph.neighbors, n_lanes=CONTINUOUS_LANES,
                           query_dim=40, entry=graph.entry,
                           steps_per_tick=CONTINUOUS_SPT, device=dev)
    qn = q.cpu().numpy()
    for i in range(16):
        rt.submit(qn[i], rid=i)
    rt.step_once()
    in_flight = rt.in_flight
    grown_paged = load_corpus_store(path, residency=paged_policy(),
                                    device=dev).with_tombstones(None)
    rt.install_index(grown_paged, grown.neighbors, grown.entry)
    for i in range(16, MUTATE_QUERIES):
        rt.submit(qn[i], rid=i)
    comps = {}
    while len(comps) < MUTATE_QUERIES:
        for c in rt.step_once():
            comps[c.rid] = c
    ref = search(grown)
    require(in_flight > 0 and all(comps[i].epoch == 0 for i in range(16))
            and all(comps[i].epoch == 1
                    for i in range(16, MUTATE_QUERIES)),
            f"mutate: epochs {[comps[i].epoch for i in sorted(comps)]}")
    for i in range(16, MUTATE_QUERIES):
        require(np.array_equal(comps[i].ids, ref.ids[i].cpu().numpy())
                and np.array_equal(comps[i].scores,
                                   ref.scores[i].cpu().numpy()),
                f"mutate: epoch 1 request {i} differs from the one-shot "
                f"search of the grown index")
    log(f"paged (e) mutation: deleted {victims.size} rows (the top-3 "
        f"answers of {MUTATE_QUERIES} queries) in {delete_s * 1e3:.1f}ms, "
        f"none returned by the paged search of the checkpoint; kills at "
        f"the four stages recover the uninterrupted index exactly; compact "
        f"({small.n} rows) round-trips through v3; install_index into a "
        f"paged runtime: {in_flight} lanes in flight finished on epoch 0, "
        f"epoch 1 = the one-shot search of the grown index bit for bit")
    return {"create_s": create_s, "insert_s": insert_s,
            "insert_rows_per_s": MUTATE_ROWS / insert_s,
            "checkpoint_s": ckpt_s, "delete_s": delete_s,
            "recall_grown": r_inc, "recall_rebuild": r_reb,
            "rebuild_s": rebuild_s, "deleted": int(victims.size)}


def paged_launcher(torch, np, dev, dirs, root):
    """(f) ``serve --runtime continuous --index DIR --residency paged`` over
    the int8 files with a chaos plan of page-read faults (absorbed by retries), the health
    line, tracing at sample 1 and the registry: the health line carries
    ``pager(mode=...)``, the exposition the ``repro_pager_*`` families,
    the trace ``site="pager"`` spans."""
    import contextlib
    import io
    from repro_torch.launch import serve
    from repro_torch.serving import FaultEvent, FaultPlan
    plan = os.path.join(root, "pager-chaos.json")
    FaultPlan([FaultEvent("page_io_error", site="pager", start=5, count=2)],
              seed=0).save(plan)
    spans = os.path.join(root, "paged-spans.jsonl")
    prom = os.path.join(root, "paged-metrics.prom")
    argv = ["--runtime", "continuous", "--index", dirs["int8"],
            "--corpus-dtype", "int8", "--residency", "paged", "--page-rows", str(PAGED_ROWS),
            "--cache-mb", str(PAGED_MB), "--queries", "320",
            "--offered-qps", "200", "--lanes", "32", "--chaos", plan,
            "--health-every", "0.5", "--trace-sample", "1", "--trace-out",
            spans, "--metrics-out", prom, "--device", str(dev)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = serve.main(argv)
    text = buf.getvalue()
    health = [ln for ln in text.splitlines() if ln.startswith("[health]")]
    require(health and all("pager(mode=" in ln and "hit_rate=" in ln
                           for ln in health),
            f"paged launcher: health lines {health[-2:]}")
    with open(prom) as f:
        families = sorted({ln.split()[2] for ln in f
                           if ln.startswith("# TYPE repro_pager_")})
    require(len(families) == 8, f"paged launcher: pager families "
            f"{families}")
    with open(spans) as f:
        pager_spans = sum(json.loads(ln).get("site") == "pager" for ln in f)
    require(pager_spans > 0, "paged launcher: no site=pager span")
    h = summary["health"]["pager"]
    log(f"paged (f) launcher: serve --runtime continuous --index "
        f"--residency paged --chaos --health-every --trace-sample 1 "
        f"--trace-out --metrics-out: {summary['qps']:.1f} QPS at offered "
        f"200, p50={summary['p50_ms']:.3f}ms; {len(health)} health lines, "
        f"the last: {health[-1]}; {len(families)} repro_pager_* families; "
        f"{pager_spans} site=pager spans; pager retries {h['retries']}")
    require(h["retries"] > 0 and h["mode"] == "paged",
            f"paged launcher: pager health {h}")
    return {"qps": summary["qps"], "p50_ms": summary["p50_ms"],
            "health_lines": len(health), "pager_families": families,
            "pager_spans": pager_spans, "pager": h}


def check_paged(torch, np, dev, graph, dirs, idx, serve_graph, root):
    """Phase 10: paged residency over the index phase's N=739,991 files
    ((a)-(c), (f)), over its 4-shard index (d), and streaming mutation of
    the serve phase's N=100,000 graph (e)."""
    t_phase = time.perf_counter()
    out, secs = {}, {}
    for name, fn in (
            ("gather", lambda: paged_gather(torch, np, dev, dirs)),
            ("serve", lambda: paged_serve(torch, np, dev, graph, dirs)),
            ("continuous", lambda: paged_continuous(torch, np, dev, graph,
                                                    dirs)),
            ("sharded", lambda: paged_sharded(torch, np, dev, idx)),
            ("mutation", lambda: paged_mutation(torch, np, dev, serve_graph,
                                                root)),
            ("launcher", lambda: paged_launcher(torch, np, dev, dirs,
                                                root))):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    out["seconds_by_part"] = secs
    log(f"paged: phase 10 passed in {out['seconds']:.1f}s ("
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# phase 11: training (the trainer, AdamW and checkpoints): the paper's
# DeepFM measure learned at Twitch scale and served, test_system's claims
# on the card, restart, and the recsys nets at their published configs
# ---------------------------------------------------------------------------

TRAIN_STEPS = 60            # build_system's steps of 1,024 interactions
TRAIN_TIME_STEPS = 200      # further steps of a second run, timed
TRAIN_WARM_STEPS = 10       # its steps left out of the timing
TRAIN_PROFILE_STEPS = 20
LEARNED_QUERIES = 1000      # TWITCH.n_test_queries learned users
# (mode, ef) of the learned-measure serve runs: SL2G and GUITAR at the
# settings of test_system's claim (ef bumped for GUITAR's recall parity)
LEARNED_MODES = (("sl2g", 64), ("guitar", 96))
LEARNED_RESIDENCIES = (("unfused float32", False, "float32"),
                       ("fused int8", True, "int8"))
CKPT_EVERY, CKPT_CRASH = 20, 47     # (c): saves at 20 and 40, dies at 47
RECSYS_ARCHS = ("dlrm-rm2", "dcn-v2", "bst", "bert4rec")
RECSYS_STEPS = 5
RECSYS_PROFILE_STEPS = 2
# train_batch is 65,536 (configs/base.py RECSYS_SHAPES); BERT4Rec's is cut:
# at seq 200 and 2 heads each example keeps ~3.2 MB of attention and FFN
# activations for the backward (27.2 GB at 8,192 on the H100), so 65,536
# would need ~210 GB
RECSYS_BATCH = {"dlrm-rm2": 65536, "dcn-v2": 65536, "bst": 65536,
                "bert4rec": 16384}
RECSYS_SMOKE_BATCH = 16     # the launcher's default --batch
# one step at the smoke config, card against CPU from the same weights:
# tests/test_torch_recsys.py's step tolerance (rtol 1e-5, atol 1e-6 at lr
# 1e-3 with the warmup off); the gradients' atol is 1e-5 of each leaf's
# largest entry (the CPU tests' 1e-6 against XLA, ten times wider for
# cuBLAS's other blockings and orders of summation)
STEP_RTOL, STEP_ATOL, STEP_LR = 1e-5, 1e-6, 1e-3
SMOKE_GRAD_ATOL_OF_MAX = 1e-5


def load_example():
    """``examples/serve_ranking_torch.py`` as a module (its steps are the
    phase's training, indexing, labelling and serving)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "serve_ranking_torch",
        os.path.join(ROOT, "examples", "serve_ranking_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_steps(torch, label, step, n):
    """torch.profiler over ``n`` calls of ``step`` (each ends in a host
    sync): wall, the card's busy share, device events per step and device
    time by kernel. Reports and checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = device_busy_us((e.time_range.start, e.time_range.end)
                          for e in kern)
    by_name = {}
    for e in kern:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    log(f"train profile {label}: {n} steps, wall {wall_us / n:.0f}us a "
        f"step, device busy {busy / n:.0f}us ({busy / wall_us:.1%}), "
        f"{len(kern) / n:.0f} device events a step")
    for name, (c, t) in top:
        log(f"train profile {label}:   {t / n:9.1f}us {c / n:7.1f}x  "
            f"{name[:90]}")
    return {"wall_us_per_step": wall_us / n, "busy_us_per_step": busy / n,
            "busy_share": busy / wall_us if wall_us else 0.0,
            "events_per_step": len(kern) / n,
            "top": [(name, c / n, t / n) for name, (c, t) in top]}


def more_steps(tr, batch_fn):
    """A function that runs one more step of trainer ``tr`` (on batches
    from step 10**6 on, outside its run) and waits for its loss."""
    n = [0]

    def one_step():
        tr.params, tr.opt_state, m = tr.step_fn(
            tr.params, tr.opt_state, batch_fn(10**6 + n[0]))
        float(m["loss"])
        n[0] += 1

    return one_step


def step_ms(history, warm=1):
    """Median seconds of the trainer's steps after ``warm``, in ms."""
    return 1e3 * statistics.median(h["sec"] for h in history[warm:])


def same_tree(torch, a, b) -> bool:
    from repro_torch.tree import flatten_with_paths
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    return [k for k, _ in fa] == [k for k, _ in fb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def train_twitch(torch, np, dev, ex):
    """(a) The paper's DeepFM at Twitch's scale (TWITCH: 100,000 users and
    739,991 items x 40, make_interactions(n_inter = 20 x 739,991, seed 0))
    through the example's ``train_measure``: build_system's 60 steps of
    1,024 (the loss must fall), then a second run of 260 steps timed after
    its first 10 (ms per step, interactions/s, peak device memory) and
    profiled over 20 more."""
    from repro_torch.configs.guitar_deepfm import TWITCH
    from repro_torch.data import make_interactions
    t0 = time.perf_counter()
    data = make_interactions(TWITCH.n_queries, TWITCH.n_items,
                             n_inter=20 * TWITCH.n_items, seed=0)
    data_s = time.perf_counter() - t0
    before = peak_reset(torch, dev)
    t0 = time.perf_counter()
    tr, cfg, data, _ = ex.train_measure(TWITCH.n_queries, TWITCH.n_items,
                                        TRAIN_STEPS, device=dev, data=data)
    train_s = time.perf_counter() - t0
    peak = peak_bytes(torch, dev, before)
    losses = [h["loss"] for h in tr.history]
    require(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
            f"train: {len(losses)} losses, finite {np.isfinite(losses).all()}")
    head = float(np.mean(losses[:5]))
    tail = float(np.mean(losses[-5:]))
    require(tail < head, f"train: the Twitch loss did not fall: first five "
            f"{head:.4f}, last five {tail:.4f}")
    # the timed run: the same model and batches over more steps
    before = peak_reset(torch, dev)
    timed, _, _, batch_fn = ex.make_trainer(
        TWITCH.n_queries, TWITCH.n_items,
        TRAIN_STEPS + TRAIN_TIME_STEPS, device=dev, data=data)
    timed.run(batch_fn)
    timed_peak = peak_bytes(torch, dev, before)
    ms = step_ms(timed.history, TRAIN_WARM_STEPS)
    prof = profile_steps(torch, "DeepFM Twitch", more_steps(timed, batch_fn),
                         TRAIN_PROFILE_STEPS)
    out = {"n_users": TWITCH.n_queries, "n_items": TWITCH.n_items,
           "n_inter": int(data["user_ids"].shape[0]), "data_s": data_s,
           "train_s": train_s, "loss_first": losses[0],
           "loss_last": losses[-1], "loss_first5": head, "loss_last5": tail,
           "losses": losses, "ms_per_step": ms,
           "interactions_per_s": ex.TRAIN_BATCH / ms * 1e3,
           "first_step_ms": 1e3 * timed.history[0]["sec"],
           "peak_mb": peak / 2**20, "timed_peak_mb": timed_peak / 2**20,
           "profile": prof}
    log(f"train (a) DeepFM at Twitch scale ({TWITCH.n_queries} users, "
        f"{TWITCH.n_items} items, {out['n_inter']} interactions made in "
        f"{data_s:.1f}s): {TRAIN_STEPS} steps of {ex.TRAIN_BATCH} in "
        f"{train_s:.2f}s, loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
        f"the first five {head:.4f}, last five {tail:.4f}); timed run "
        f"{ms:.3f} ms a step (median of steps {TRAIN_WARM_STEPS}.."
        f"{len(timed.history) - 1}, first {out['first_step_ms']:.1f} ms), "
        f"{out['interactions_per_s']:.0f} interactions/s; peak device "
        f"memory {out['peak_mb']:.1f} MiB over the parameters and data "
        f"already held ({out['timed_peak_mb']:.1f} MiB in the timed run)")
    del timed
    return tr, cfg, data, out


def learned_serve(torch, np, dev, ex, tr, cfg):
    """(a) The index over the learned items as the reference builds it
    (M=24, k_construction=100: NN-descent above exact_threshold) and,
    beside it, the exact-kNN build; exact top-10 labels of the first 1,000
    learned users under the learned measure; then SL2G at ef 64 and GUITAR
    at ef 96, unfused float32 and fused int8, over both graphs: recall@10,
    Total = #NN + 2 #Grad, QPS, each run launching only its path's
    kernels (rows 1-6). test_system's claims are logged here, not
    required."""
    from repro_torch.configs.guitar_deepfm import TWITCH
    from repro_torch.core import (EngineOptions, SearchConfig,
                                  make_corpus_store, recall)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    measure, base, queries = ex.learned_system(tr, cfg, LEARNED_QUERIES)
    graphs, builds = {}, {}
    for name, kw in (("nn-descent", {}),
                     ("exact", {"exact_threshold": base.shape[0]})):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphs[name] = ex.build_index(base, m=TWITCH.m,
                                      k_construction=TWITCH.k_construction,
                                      device=dev, stats=stats, **kw)
        torch.cuda.synchronize()
        builds[name] = {"s": time.perf_counter() - t0,
                        "knn_s": stats["knn_s"], "prune_s": stats["prune_s"],
                        "symmetrize_s": stats["symmetrize_s"],
                        "avg_degree": graphs[name].avg_degree,
                        "nn_descent": "nn_descent" in stats}
        log(f"train (a) index over the learned items, {name}: "
            f"{builds[name]['s']:.2f}s (kNN {stats['knn_s']:.2f}s, prune "
            f"{stats['prune_s']:.2f}s, symmetrize "
            f"{stats['symmetrize_s']:.2f}s), degree avg "
            f"{graphs[name].avg_degree:.1f}")
    require(builds["nn-descent"]["nn_descent"]
            and not builds["exact"]["nn_descent"],
            "train: the learned index did not build through NN-descent")
    t0 = time.perf_counter()
    true_ids = ex.label(measure, base, queries, 10, device=dev)
    label_s = time.perf_counter() - t0
    log(f"train (a) labels: exact top-10 of {LEARNED_QUERIES} learned users "
        f"over {base.shape[0]} learned items in {label_s:.2f}s")
    base_t = torch.as_tensor(base, device=dev)
    runs = {}
    for res_label, fused, dtype in LEARNED_RESIDENCIES:
        options = EngineOptions(fused=fused, corpus_dtype=dtype)
        store = make_corpus_store(base_t, dtype, device=dev)
        path = KERNELS_OF[("deepfm", fused)]
        for gname, graph in graphs.items():
            for mode, ef in LEARNED_MODES:
                cfg_s = SearchConfig(k=10, ef=ef, mode=mode,
                                     budget=TWITCH.budget,
                                     alpha=TWITCH.alpha)
                reset_launch_counts()
                out = ex.serve(measure, graph, queries, cfg_s, options,
                               store=store, batch=32, device=dev)
                counts = launch_counts()
                key = f"{res_label} {gname} {mode} ef {ef}"
                for kname, c in counts.items():
                    require(c == 0 or kname in path,
                            f"train serve {key}: {kname} launched {c} times"
                            f"; the path's kernels are {path}")
                need = path if mode == "guitar" else path[:1]
                require(all(counts[k] > 0 for k in need),
                        f"train serve {key}: launches {counts}, the path "
                        f"needs {need}")
                rec = recall(out["ids"], true_ids)
                runs[key] = {"recall": rec, "n_eval": out["n_eval"],
                             "n_grad": out["n_grad"], "total": out["total"],
                             "qps": out["qps"], "p50_ms": out["p50_ms"],
                             "p95_ms": out["p95_ms"],
                             "launches": {k: c for k, c in counts.items()
                                          if c}}
                log(f"train serve {key}: recall@10 {rec:.4f}, #NN "
                    f"{out['n_eval']:.1f} #Grad {out['n_grad']:.1f} Total "
                    f"{out['total']:.1f}, QPS {out['qps']:.1f}, p50 "
                    f"{out['p50_ms']:.2f} ms per batch of 32")
    claims = {}
    for res_label, _, _ in LEARNED_RESIDENCIES:
        for gname in graphs:
            s = runs[f"{res_label} {gname} sl2g ef 64"]
            g = runs[f"{res_label} {gname} guitar ef 96"]
            claims[f"{res_label} {gname}"] = c = {
                "guitar_recall_minus_sl2g": g["recall"] - s["recall"],
                "total_ratio": g["total"] / s["total"]}
            log(f"train (a) test_system's claim at Twitch scale, "
                f"{res_label} {gname} (logged, not required): GUITAR ef 96 "
                f"recall {g['recall']:.4f} vs SL2G ef 64 {s['recall']:.4f}, "
                f"Total ratio {c['total_ratio']:.3f} (test_system wants "
                f"< 0.6 at recall >= SL2G's - 0.05)")
    return {"builds": builds, "label_s": label_s, "runs": runs,
            "claims": claims}


def system_claims(torch, np, dev):
    """(b) tests/test_system.py's claims on the card through the port:
    its fixture (N_ITEMS 3,000, N_USERS 256, 30,000 interactions of seed
    1, the model's own tables from the port's generator of seed 0, 40
    steps of 256 at lr 5e-3 over a cosine of 80, the graph at M=12,
    k_construction=32, the first 24 users as queries); SL2G recall >= 0.85
    at ef 96, GUITAR's Total < 0.6 x SL2G's (ef 96 against 64) at recall
    >= SL2G's - 0.05, alpha monotone in #eval, results sorted and
    unique."""
    from repro_torch.core import (SearchConfig, brute_force_topk,
                                  deepfm_measure, recall, search_measure)
    from repro_torch.data import make_interactions
    from repro_torch.graph import build_l2_graph
    from repro_torch.models import deepfm as F
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig
    n_items, n_users, n_q = 3000, 256, 24
    cfg = F.DeepFMConfig(n_users=n_users, n_items=n_items)
    params = F.init_model(torch.Generator().manual_seed(0), cfg, device=dev)
    data = make_interactions(n_users, n_items, 30_000, seed=1)

    def batch_fn(step):
        idx = np.random.default_rng(step).integers(0, 30_000, 256)
        return {k: torch.as_tensor(data[v][idx], device=dev) for k, v in (
            ("u", "user_ids"), ("i", "item_ids"), ("y", "labels"))}

    tr = Trainer(lambda p, b: F.interaction_loss(p, b["u"], b["i"], b["y"],
                                                 cfg),
                 params, OptimizerConfig(lr=5e-3, total_steps=80),
                 TrainerConfig(total_steps=40, ckpt_every=1000))
    tr.run(batch_fn)
    base = tr.params["items"].detach()
    queries = tr.params["users"][:n_q].detach()
    measure = deepfm_measure({"mlp": {k: [t.detach() for t in v] for k, v in
                                      tr.params["mlp"].items()}}, cfg)
    graph = build_l2_graph(base.cpu().numpy(), m=12, k_construction=32,
                           device=dev)
    true_ids, _ = brute_force_topk(measure, base, queries, 10)
    nbrs = torch.as_tensor(graph.neighbors, device=dev)
    entries = torch.full((n_q,), graph.entry, device=dev)

    def run(mode, ef=64, alpha=1.01, budget=8):
        res = search_measure(measure, base, nbrs, queries, entries,
                             SearchConfig(k=10, ef=ef, budget=budget,
                                          alpha=alpha, mode=mode))
        total = float(res.n_eval.float().mean()
                      + 2 * res.n_grad.float().mean())
        return recall(res.ids, true_ids), total, res

    r96, _, _ = run("sl2g", ef=96)
    r_s, total_s, _ = run("sl2g", ef=64)
    r_g, total_g, res_g = run("guitar", ef=96)
    evals = [float(run("guitar", alpha=a, budget=12)[2].n_eval.float()
                   .mean()) for a in (1.0, 1.1, 1.5)]
    out = {"loss_first": tr.history[0]["loss"],
           "loss_last": tr.history[-1]["loss"], "sl2g_ef96_recall": r96,
           "sl2g_ef64_recall": r_s, "sl2g_ef64_total": total_s,
           "guitar_ef96_recall": r_g, "guitar_ef96_total": total_g,
           "alpha_evals": evals}
    log(f"train (b) test_system on the card: loss {out['loss_first']:.4f} "
        f"-> {out['loss_last']:.4f}; SL2G ef 96 recall {r96:.4f}; SL2G ef "
        f"64 recall {r_s:.4f} Total {total_s:.1f}; GUITAR ef 96 recall "
        f"{r_g:.4f} Total {total_g:.1f} ({total_g / total_s:.3f}x); #eval "
        f"at alpha 1.0/1.1/1.5: {evals}")
    require(r96 >= 0.85, f"train (b): SL2G recall {r96:.4f} < 0.85 at ef 96")
    require(r_g >= r_s - 0.05, f"train (b): GUITAR recall {r_g:.4f} << SL2G "
            f"{r_s:.4f}")
    require(total_g < 0.6 * total_s, f"train (b): GUITAR Total {total_g:.1f}"
            f" not < 0.6 x SL2G's {total_s:.1f}")
    require(evals[0] <= evals[1] <= evals[2] * 1.05,
            f"train (b): #eval not monotone in alpha: {evals}")
    ids, scores = res_g.ids.cpu().numpy(), res_g.scores.cpu().numpy()
    for q in range(n_q):
        s = scores[q][np.isfinite(scores[q])]
        vid = ids[q][ids[q] >= 0]
        require(bool((np.diff(s) <= 1e-6).all())
                and len(set(vid.tolist())) == len(vid),
                f"train (b): query {q}'s results unsorted or repeated")
    return out


def checkpoint_restart(torch, np, dev, ex, tr_whole, data):
    """(c) The Twitch trainer with checkpoints every 20 steps dies at step
    47; a new trainer resumes from step 40 and finishes the 60: its
    parameters and optimizer state equal (a)'s uninterrupted run's bit for
    bit. Then ``launch/train.py --arch dcn-v2 --ckpt-dir`` trains 10 steps
    on the card and a second call with --steps 14 resumes at 10."""
    import shutil
    import tempfile
    from repro_torch.configs.guitar_deepfm import TWITCH
    from repro_torch.launch import train as train_launch
    root = tempfile.mkdtemp(prefix="ckpt-")
    try:
        d = os.path.join(root, "twitch")
        tr, _, _, batch_fn = ex.make_trainer(
            TWITCH.n_queries, TWITCH.n_items, TRAIN_STEPS, device=dev,
            data=data, ckpt_dir=d, ckpt_every=CKPT_EVERY)

        def crashing(step):
            if step == CKPT_CRASH:
                raise SmokeFailure("the injected crash")
            return batch_fn(step)

        t0 = time.perf_counter()
        try:
            tr.run(crashing)
            require(False, "train (c): the injected crash did not happen")
        except SmokeFailure as e:
            require("injected" in str(e), str(e))
        crashed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed, _, _, batch_fn = ex.make_trainer(
            TWITCH.n_queries, TWITCH.n_items, TRAIN_STEPS, device=dev,
            data=data, ckpt_dir=d, ckpt_every=CKPT_EVERY)
        restore_s = time.perf_counter() - t0
        require(resumed.start_step == 2 * CKPT_EVERY,
                f"train (c): resumed at {resumed.start_step}, not 40")
        resumed.run(batch_fn)
        same_p = same_tree(torch, resumed.params, tr_whole.params)
        same_o = same_tree(torch, resumed.opt_state, tr_whole.opt_state)
        require(same_p and same_o, f"train (c): the resumed run's params "
                f"(equal {same_p}) or optimizer state (equal {same_o}) "
                f"differ from the uninterrupted run's")
        ckpt_mb = sum(os.path.getsize(os.path.join(dp, f))
                      for dp, _, fs in os.walk(d) for f in fs) / 2**20
        log(f"train (c) restart: crashed at step {CKPT_CRASH} after saving "
            f"steps 20 and 40 ({crashed_s:.2f}s), restored step 40 in "
            f"{restore_s:.2f}s (trainer built, checkpoint read), finished "
            f"step 60: parameters and optimizer state = the uninterrupted "
            f"run's bit for bit; {ckpt_mb:.0f} MiB on disk")
        d2 = os.path.join(root, "dcn")
        first = train_launch.main(["--arch", "dcn-v2", "--steps", "10",
                                   "--ckpt-dir", d2, "--device", str(dev)])
        again = train_launch.main(["--arch", "dcn-v2", "--steps", "14",
                                   "--ckpt-dir", d2, "--device", str(dev)])
        require(first.start_step == 0 and again.start_step == 10
                and int(again.opt_state.step) == 14
                and len(again.history) == 4,
                f"train (c): the launcher resumed at {again.start_step}, "
                f"ran {len(again.history)} steps")
        losses = [h["loss"] for h in first.history + again.history]
        require(all(np.isfinite(losses)), "train (c): dcn-v2 loss not finite")
        return {"crashed_s": crashed_s, "restore_s": restore_s,
                "ckpt_mib": ckpt_mb, "bit_equal": True,
                "launcher_losses": losses}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def gather_grad_times(torch, dev, table_rows, d, ids):
    """The table gradient of a row gather at DLRM-RM2's train_batch: the
    port's deterministic segment sum (sorted ids, each run reduced in
    order) against the atomic ``index_add_`` (the default backward of
    ``index_select``), device ms of each, and whether each gives the same
    bits twice."""
    from repro_torch.models.layers import segment_sum_rows
    g = torch.randn((ids.numel(), d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))

    def det():
        return segment_sum_rows(g, ids, table_rows)

    def atomic():
        return torch.zeros((table_rows, d), device=dev).index_add_(0, ids, g)

    out = {"det_ms": event_ms(det), "atomic_ms": event_ms(atomic)}
    a, b = det(), det()
    out["det_repeats"] = bool(torch.equal(a, b))
    del a, b
    a, b = atomic(), atomic()
    out["atomic_repeats"] = bool(torch.equal(a, b))
    del a, b, g
    require(out["det_repeats"], "train (d): the deterministic table "
            "gradient changed between two runs")
    return out


def recsys_published(torch, np, dev):
    """(d) DLRM-RM2, DCN-v2, BST and BERT4Rec at their published configs
    (``config()``, every table at its full row count) through
    ``launch/train.py``'s ``recsys_setup``, a few AdamW steps each at
    train_batch (BERT4Rec at its named cut): finite losses, ms per step,
    examples/s, peak device memory, a profile of two more steps. Then one
    step of each smoke config on the card and on the CPU from the same
    weights (``smoke_step_card_vs_cpu``)."""
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import recsys_setup
    from repro_torch.models.recsys import _offsets
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves
    out = {}
    for name in RECSYS_ARCHS:
        arch = get_arch(name)
        cfg = arch.make_config()
        batch = RECSYS_BATCH[name]
        before = peak_reset(torch, dev)
        t0 = time.perf_counter()
        params, loss_fn, batch_fn = recsys_setup(arch, cfg, batch,
                                                 device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in tree_leaves(params))
        tr = Trainer(loss_fn, params, OptimizerConfig(
            lr=1e-3, total_steps=2 * RECSYS_STEPS),
            TrainerConfig(total_steps=RECSYS_STEPS, ckpt_every=10**9))
        tr.run(batch_fn)
        peak = peak_bytes(torch, dev, before) + before
        prof = profile_steps(torch, name, more_steps(tr, batch_fn),
                             RECSYS_PROFILE_STEPS)
        losses = [h["loss"] for h in tr.history]
        require(all(np.isfinite(losses)), f"train (d) {name}: a loss is not "
                f"finite: {losses}")
        ms = step_ms(tr.history)
        res = {"batch": batch, "n_params": n_params, "init_s": init_s,
               "losses": losses, "ms_per_step": ms,
               "first_step_ms": 1e3 * tr.history[0]["sec"],
               "examples_per_s": batch / ms * 1e3,
               "peak_gb": peak / 1e9, "profile": prof}
        if name == "dlrm-rm2":
            sparse = batch_fn(10**6)["sparse"]
            ids = (sparse + _offsets(cfg.cardinalities, dev)[None, :]
                   ).reshape(-1).long()
            res["gather_grad"] = gather_grad_times(
                torch, dev, tr.params["table"].shape[0], cfg.embed_dim, ids)
        out[name] = res
        log(f"train (d) {name} published config ({n_params / 1e6:.1f}M "
            f"parameters, built in {init_s:.2f}s), batch {batch}: losses "
            f"{', '.join(f'{v:.4f}' for v in losses)}; {ms:.2f} ms a step "
            f"(median of steps 1..{RECSYS_STEPS - 1}; first "
            f"{res['first_step_ms']:.0f} ms), {res['examples_per_s']:.0f} "
            f"examples/s; peak device memory {res['peak_gb']:.2f} GB")
        if "gather_grad" in res:
            gg = res["gather_grad"]
            log(f"train (d) dlrm-rm2 table gradient of {ids.numel()} ids: "
                f"deterministic segment sum {gg['det_ms']:.2f} ms (same "
                f"bits twice: {gg['det_repeats']}), atomic index_add_ "
                f"{gg['atomic_ms']:.2f} ms (same bits twice: "
                f"{gg['atomic_repeats']})")
        del tr, params, loss_fn, batch_fn
        gc.collect()
        torch.cuda.empty_cache()
    # one step of each smoke config: the card against the CPU
    for name in RECSYS_ARCHS:
        out[name]["smoke_step_card_vs_cpu"] = smoke_step_card_vs_cpu(
            torch, dev, name)
    return out


def _worst(torch, got, want, rtol, atol, atol_of_max=0.0):
    """Worst ``close_err`` ratio over two trees' leaves (got on any
    device), each leaf's atol raised by ``atol_of_max`` of its largest
    entry."""
    from repro_torch.tree import tree_leaves
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.detach().cpu(), b.detach().cpu()
        tol = atol + atol_of_max * float(b.abs().max())
        worst = max(worst, close_err(a, b, rtol, tol)[1])
    return worst


def smoke_step_card_vs_cpu(torch, dev, name):
    """(d) One AdamW step of ``name``'s smoke config (the launcher's batch
    of 16, lr 1e-3, warmup off) on the card and on the CPU from the same
    weights: the loss at rtol 1e-5, the gradients at rtol 1e-5 and an
    atol of SMOKE_GRAD_ATOL_OF_MAX of each leaf's largest entry, and the
    parameters after the update at STEP_RTOL / STEP_ATOL when both
    devices update from the card's gradients. Two independent steps'
    parameters are logged, not required: Adam's first step is g / (|g| +
    eps) x lr, so where |g| is near eps a gradient's last bits move the
    step by up to lr."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import recsys_setup
    from repro_torch.train import OptimizerConfig, adamw_init, adamw_update
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import tree_map
    arch = get_arch(name)
    cfg = arch.make_smoke_config()
    ocfg = OptimizerConfig(lr=STEP_LR, warmup_steps=0, total_steps=10)
    runs = {}
    for where in ("cpu", str(dev)):
        params, loss_fn, batch_fn = recsys_setup(
            arch, cfg, RECSYS_SMOKE_BATCH, device=where,
            generator=torch.Generator().manual_seed(0))
        loss, grads = value_and_grad(loss_fn, params, batch_fn(0))
        runs[where] = (params, float(loss), grads)
    (pc, lc, gc), (pd, ld, gd) = runs["cpu"], runs[str(dev)]
    g_worst = _worst(torch, gd, gc, STEP_RTOL, 0.0, SMOKE_GRAD_ATOL_OF_MAX)
    own = tree_map(lambda t: t.detach().clone(), pc)
    adamw_update(own, gc, adamw_init(own, ocfg), ocfg)
    adamw_update(pc, tree_map(lambda t: t.cpu(), gd), adamw_init(pc, ocfg),
                 ocfg)
    adamw_update(pd, gd, adamw_init(pd, ocfg), ocfg)
    p_worst = _worst(torch, pd, pc, STEP_RTOL, STEP_ATOL)
    own_worst = _worst(torch, pd, own, STEP_RTOL, STEP_ATOL)
    log(f"train (d) {name} smoke config, one step on the card against the "
        f"CPU from the same weights: loss {ld:.6f} / {lc:.6f}; gradients "
        f"{g_worst:.3f} of their tolerance; parameters updated from the "
        f"same gradients {p_worst:.3f} of theirs (rtol {STEP_RTOL}, atol "
        f"{STEP_ATOL}); two independent steps' parameters {own_worst:.3f} "
        f"(logged)")
    require(abs(ld - lc) <= STEP_RTOL * abs(lc) and g_worst <= 1.0
            and p_worst <= 1.0,
            f"train (d) {name}: the card's step differs from the CPU's "
            f"(loss {ld} / {lc}, gradients {g_worst:.3f}, parameters "
            f"{p_worst:.3f} of the tolerance)")
    return {"loss_cpu": lc, "loss_card": ld, "grad_worst": g_worst,
            "param_worst": p_worst, "independent_param_worst": own_worst}


def check_training(torch, np, dev):
    """Phase 11: (a) the DeepFM measure learned at Twitch scale, indexed,
    labelled and served; (b) test_system's claims on the card; (c)
    checkpoint and restart; (d) the recsys nets at their published
    configurations."""
    t_phase = time.perf_counter()
    ex = load_example()
    out, secs = {"tf32": bool(torch.backends.cuda.matmul.allow_tf32)}, {}
    log(f"train: phase 11, TF32 {'on' if out['tf32'] else 'off'} for "
        f"matrix products")
    t0 = time.perf_counter()
    tr, cfg, data, out["twitch_train"] = train_twitch(torch, np, dev, ex)
    out["twitch_serve"] = learned_serve(torch, np, dev, ex, tr, cfg)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["system"] = system_claims(torch, np, dev)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["restart"] = checkpoint_restart(torch, np, dev, ex, tr, data)
    secs["c"] = time.perf_counter() - t0
    del tr, data
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["recsys"] = recsys_published(torch, np, dev)
    secs["d"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    out["seconds_by_part"] = secs
    log(f"train: phase 11 passed in {out['seconds']:.1f}s ("
        + ", ".join(f"({k}) {v:.1f}s" for k, v in secs.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# phase 12: the tuning cache and the engine's tile plan; the legacy searcher
# ---------------------------------------------------------------------------

# the kernels the tile plan launches (pre-gathered) and the rowwise plan
# launches (fused), by (family, mode)
PLAN_KERNELS = {
    ("deepfm", "guitar", "tile"): ("deepfm_score", "neighbor_rank",
                                   "deepfm_value_and_grad"),
    ("deepfm", "sl2g", "tile"): ("deepfm_score",),
    ("mlp", "guitar", "tile"): ("mlp_score", "neighbor_rank",
                                "mlp_value_and_grad"),
    ("mlp", "sl2g", "tile"): ("mlp_score",),
    ("deepfm", "guitar", "rowwise"): KERNELS_OF[("deepfm", True)],
    ("deepfm", "sl2g", "rowwise"): ("deepfm_score_fused",),
    ("mlp", "guitar", "rowwise"): KERNELS_OF[("mlp", True)],
    ("mlp", "sl2g", "rowwise"): ("mlp_score_fused",),
}
# the N=100,000 serve runs whose fused step phase 12 (b) tunes
TUNE_RUNS = ("fused float32", "fused bfloat16", "fused int8",
             "mlp fused int8")
TUNE_CONTINUOUS = ["--runtime", "continuous", "--lanes", "32", "--queries",
                   "128", "--offered-qps", "100000"]
AUTOTUNE_FAMILIES = ("repro_autotune_lookup_hits_total",
                     "repro_autotune_lookup_misses_total",
                     "repro_autotune_sweeps_total",
                     "repro_autotune_sweep_cache_hits_total")


def check_plan_launches(counts, family, mode, plan, label, steps=None):
    """The plan's kernels launched and no other kernel; with ``steps``,
    each once per step (the score once more, at init)."""
    path = PLAN_KERNELS[(family, mode, plan)]
    for name, n in counts.items():
        if name not in path:
            require(n == 0, f"{label}: kernel {name} launched {n} times; "
                    f"the {plan} plan's kernels are {path}")
        elif steps is None:
            require(n > 0, f"{label}: kernel {name} never launched")
        else:
            want = steps + 1 if "score" in name else steps
            require(n == want, f"{label}: kernel {name} launched {n} "
                    f"times, not once per step ({steps} steps"
                    f"{', +1 at init' if 'score' in name else ''})")


def tile_plan_parity(torch, np, dev, N=5000):
    """(a) At N=5,000, DeepFM and MLP, GUITAR and SL2G, f32/bf16/int8:
    the captured search in the tile plan, the rowwise plan and unfused;
    each = its search_debug bit for bit; tile = rowwise = unfused bit for
    bit at f32, tile = unfused at bf16/int8 (both ``store.take``), tile =
    rowwise bit for bit or, if not, each at the plain score of its ids and
    recall@10 within 0.01; each plan launches only its kernels, once per
    step. Returns the numbers and the (base, graph) for (d)."""
    from repro_torch.core import (EngineOptions, SearchConfig,
                                  brute_force_topk, build_engine,
                                  make_corpus_store, make_family_measure,
                                  recall)
    from repro_torch.graph import build_l2_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    D, Q = 40, 32
    rng = np.random.default_rng(12)
    base = rng.normal(size=(N, D)).astype(np.float32)
    qt = torch.as_tensor(rng.normal(size=(Q, D)).astype(np.float32),
                         device=dev)
    graph = build_l2_graph(base, m=24, k_construction=100, device=dev)
    nbrs = torch.as_tensor(graph.neighbors, device=dev)
    entries = torch.full((Q,), graph.entry, device=dev)
    base_t = torch.as_tensor(base, device=dev)
    out = {}
    for family in ("deepfm", "mlp"):
        measure = make_family_measure(family, torch.Generator().manual_seed(0),
                                      D, device=dev)
        truth = brute_force_topk(measure, base_t, qt, 10)[0]
        for mode in ("guitar", "sl2g"):
            cfg = SearchConfig(k=10, ef=64, budget=8, alpha=1.01, mode=mode)
            for dtype in RESIDENCIES:
                store = make_corpus_store(base, dtype, device=dev)
                res = {}
                for plan in ("unfused", "rowwise", "tile"):
                    options = (EngineOptions(corpus_dtype=dtype)
                               if plan == "unfused" else
                               EngineOptions(fused=True, corpus_dtype=dtype,
                                             tile=plan))
                    eng = build_engine(measure, cfg, options)
                    name = f"tile plan {family} {mode} {dtype} {plan}"
                    steps0 = eng.stats["steps"]
                    reset_launch_counts()
                    r = eng.search(measure.params, store, nbrs, qt, entries)
                    torch.cuda.synchronize()
                    counts = launch_counts()
                    steps = eng.stats["steps"] - steps0
                    if plan != "unfused":
                        check_plan_launches(counts, family, mode, plan,
                                            name, steps)
                    debug = eng.search_debug(measure.params, store, nbrs, qt,
                                             entries)
                    require(same_result(torch, r, debug), f"{name}: the "
                            f"captured search differs from search_debug")
                    res[plan] = r
                tag = f"tile plan {family} {mode} {dtype}"
                require(same_result(torch, res["tile"], res["unfused"]),
                        f"{tag}: the tile plan differs from unfused")
                exact = same_result(torch, res["tile"], res["rowwise"])
                if dtype == "float32":
                    require(exact, f"{tag}: tile differs from rowwise")
                rec = {p: recall(r.ids, truth) for p, r in res.items()}
                if not exact:
                    for p in ("rowwise", "tile"):
                        check_result(torch, measure, store, qt, res[p], 10,
                                     f"{tag} {p}")
                    require(abs(rec["tile"] - rec["rowwise"])
                            <= RECALL_AGREE, f"{tag}: recall tile "
                            f"{rec['tile']:.4f} vs rowwise "
                            f"{rec['rowwise']:.4f}")
                log(f"{tag}: captured = search_debug in each plan; tile = "
                    f"unfused bit for bit; tile {'=' if exact else '!='} "
                    f"rowwise bit for bit; recall@10 " + ", ".join(
                        f"{p} {v:.4f}" for p, v in rec.items())
                    + f"; {int(res['tile'].n_iters.max())} iterations max")
                out[tag] = {"tile_equals_rowwise": exact, "recall": rec}
    return out, (base, graph)


def tune_serve(torch, np, dev, ctx, root, equal_plans):
    """(b) and (c): ``serve --autotune`` at N=100,000 for TUNE_RUNS, each
    family on its own cache file under ``root``: the first (oneshot, Q=32)
    run sweeps, the second (continuous, 32 lanes) is a cache hit; recall
    equals the run without --autotune; the continuous run of the first
    label writes --metrics-out with the four autotune families. Then
    --tile rowwise and --tile tile serve in turns (rowwise, tile, tile,
    rowwise): QPS, p50, host us per step, each run's kernels; results bit
    for bit equal where (a) found the plans equal."""
    from repro_torch.core import build_engine, make_family_measure
    from repro_torch.kernels import (autotune, launch_counts,
                                     reset_launch_counts)
    from repro_torch.launch import serve
    flags_of = {label: (family, extra) for label, family, extra in SERVE_RUNS}
    graph = ctx[TUNE_RUNS[0]][3]
    common = serve_common(graph.n, dev)
    _, rng, stream = serve_stream(np, graph.n)
    base_t = torch.as_tensor(graph.base, device=dev)
    out = {}
    for i, label in enumerate(TUNE_RUNS):
        measure, store, nbrs, _, cfg, _ = ctx[label]
        family, extra = flags_of[label]
        os.environ["REPRO_TORCH_TUNING_CACHE"] = os.path.join(
            root, f"{family}.json")
        # a fresh measure (the same weights): an engine that has resolved
        # no plan yet, as in a new launcher process
        fresh = make_family_measure(family, torch.Generator().manual_seed(0),
                                    40, device=dev)

        def run(m, flags, results=None):
            args = serve.parse_args(common + ["--measure", family] + extra
                                    + flags)
            options = serve.engine_options(args)
            rng.bit_generator.state = stream
            if args.autotune:
                before = dict(autotune.CACHE_STATS)
                serve.autotune_plan(args, graph, m, cfg, options, store,
                                    nbrs, dev)
                delta = {k: autotune.CACHE_STATS[k] - before[k]
                         for k in before}
            else:
                delta = None
            fn = (serve.serve_continuous if args.runtime == "continuous"
                  else serve.serve_oneshot)
            kw = {"results": results} if results is not None else {}
            return fn(args, graph, m, cfg, options, store, nbrs, base_t,
                      rng, dev, **kw), delta

        plain, _ = run(measure, [])
        tuned, d1 = run(fresh, ["--autotune"])
        require(d1["sweeps"] == 1 and d1["sweep_cache_hits"] == 0,
                f"autotune {label}: the first run did not sweep once: {d1}")
        key = autotune.make_key("engine_step", 32, nbrs.shape[1], 40,
                                store.dtype, dev.type)
        entry = autotune.load_cache()[key]
        cont_flags = TUNE_CONTINUOUS + (
            ["--metrics-out", os.path.join(root, "metrics.prom")]
            if i == 0 else [])
        cont_plain, _ = run(measure, TUNE_CONTINUOUS)
        cont, d2 = run(fresh, cont_flags + ["--autotune"])
        require(d2["sweeps"] == 0 and d2["sweep_cache_hits"] == 1,
                f"autotune {label}: the second run at Q=32 did not hit the "
                f"cache: {d2}")
        plain_plan = "tile" if build_engine(measure, cfg, ctx[label][5]) \
            ._use_tile_plan(store, nbrs.shape[1], 32) else "rowwise"
        exact = equal_plans[store.dtype] or entry["plan"] == plain_plan
        for a, b, what in ((plain, tuned, "oneshot"),
                           (cont_plain, cont, "continuous")):
            if exact:
                require(a["recall"] == b["recall"], f"autotune {label} "
                        f"{what}: recall {b['recall']} with --autotune, "
                        f"{a['recall']} without")
            else:
                require(abs(a["recall"] - b["recall"]) <= RECALL_AGREE,
                        f"autotune {label} {what}: recall {b['recall']} "
                        f"with --autotune, {a['recall']} without")
        if i == 0:
            with open(os.path.join(root, "metrics.prom")) as f:
                text = f.read()
            missing = [n for n in AUTOTUNE_FAMILIES if n not in text]
            require(not missing, f"--metrics-out lacks {missing}")
            log(f"autotune: --metrics-out holds the four autotune "
                f"families: " + ", ".join(
                    line for line in text.splitlines()
                    if line.startswith("repro_autotune_")))
        log(f"autotune {label}: swept " + ", ".join(
            f"{k}={v:.1f}us" for k, v in entry["swept_us"].items())
            + f" per search of Q=32 -> plan {entry['plan']} at {key} "
            f"(without "
            f"--autotune: {plain_plan}); the continuous "
            f"run at 32 lanes hit the cache; recall oneshot "
            f"{tuned['recall']:.4f} (without {plain['recall']:.4f}), "
            f"continuous {cont['recall']:.4f} (without "
            f"{cont_plain['recall']:.4f})")
        turns = []
        results = {}
        for plan in ("rowwise", "tile", "tile", "rowwise"):
            got = []
            reset_launch_counts()
            summ, _ = run(measure, ["--tile", plan], got)
            check_plan_launches(launch_counts(), family, "guitar", plan,
                                f"serve {label} --tile {plan}")
            results.setdefault(plan, got)
            turns.append({k: summ[k] for k in ("qps", "p50_ms", "p95_ms",
                                                "host_us_per_step",
                                                "recall")})
            turns[-1]["plan"] = plan
        same = all(same_result(torch, a, b) for a, b in
                   zip(results["rowwise"], results["tile"]))
        if exact or store.dtype == "float32":
            require(same, f"serve {label}: --tile tile and --tile rowwise "
                    f"serve different results")
        for t in turns:
            log(f"serve {label} --tile {t['plan']:7s}: QPS={t['qps']:.1f} "
                f"p50={t['p50_ms']:.3f}ms p95={t['p95_ms']:.3f}ms, "
                f"{t['host_us_per_step']:.1f}us host issue per step, "
                f"recall@10 (16) {t['recall']:.4f}")
        out[label] = {"swept_us": entry["swept_us"], "plan": entry["plan"],
                      "key": key, "plain_plan": plain_plan,
                      "recall": [plain["recall"], tuned["recall"],
                                 cont_plain["recall"], cont["recall"]],
                      "turns": turns, "results_equal": same}
    os.environ.pop("REPRO_TORCH_TUNING_CACHE", None)
    return out


def legacy_parity(torch, np, dev, base, graph):
    """(d) ``search_legacy`` at N=5,000 (DeepFM f32, GUITAR and SL2G):
    recall@10 on the card within 0.01 of the CPU's, the captured search =
    the eager one bit for bit, no port kernel launched."""
    from repro_torch.core import (SearchConfig, brute_force_topk,
                                  make_family_measure, recall,
                                  search_legacy)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    D, Q = base.shape[1], 64
    queries = np.random.default_rng(13).normal(size=(Q, D)).astype(
        np.float32)
    cpu = torch.device("cpu")
    out = {}
    for mode in ("guitar", "sl2g"):
        cfg = SearchConfig(k=10, ef=64, budget=8, alpha=1.01, mode=mode)
        res, truth = {}, None
        for side, where in (("card", dev), ("cpu", cpu)):
            m = make_family_measure("deepfm",
                                    torch.Generator().manual_seed(0), D,
                                    device=where)
            qt = torch.as_tensor(queries, device=where)
            base_t = torch.as_tensor(base, device=where)
            nbrs = torch.as_tensor(graph.neighbors, device=where)
            entries = torch.full((Q,), graph.entry, device=where)
            if truth is None:
                truth = brute_force_topk(m, base_t, qt, 10)[0].cpu()
            reset_launch_counts()
            t0 = time.perf_counter()
            res[side] = search_legacy(m.score_fn, m.params, base_t, nbrs,
                                      qt, entries, cfg)
            if side == "card":
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                eager = search_legacy(m.score_fn, m.params, base_t, nbrs, qt,
                                      entries, cfg, capture=False)
                replay = search_legacy(m.score_fn, m.params, base_t, nbrs,
                                       qt, entries, cfg)
                torch.cuda.synchronize()
                counts = launch_counts()
                require(not any(counts.values()), f"legacy {mode}: port "
                        f"kernels launched: {counts}")
                for lbl, r in (("eager", eager), ("replayed", replay)):
                    require(same_result(torch, res["card"], r),
                            f"legacy {mode}: the captured search differs "
                            f"from the {lbl} one")
        rc, rp = (recall(res[w].ids.cpu(), truth) for w in ("card", "cpu"))
        require(abs(rc - rp) <= RECALL_AGREE, f"legacy {mode} N="
                f"{base.shape[0]}: recall card {rc:.4f}, cpu {rp:.4f}")
        log(f"legacy {mode} N={base.shape[0]} Q={Q}: recall@10 card "
            f"{rc:.4f} cpu {rp:.4f}; captured = eager = replayed bit for "
            f"bit; no port kernel launched; first call with capture "
            f"{first_s:.2f}s")
        out[mode] = {"recall_card": rc, "recall_cpu": rp,
                     "capture_s": first_s}
    return out


def legacy_serve(torch, np, dev, ctx):
    """(e) ``serve --searcher legacy`` at N=100,000, DeepFM f32, GUITAR
    and SL2G: recall@10 on the serve phase's 64 recall queries within 0.01
    of the engine's at the same settings, no port kernel launched; the
    launcher's engine and legacy serves in turns (engine, legacy, legacy,
    engine): QPS, p50; the launcher's refusals."""
    from repro_torch.core import (EngineOptions, SearchConfig,
                                  brute_force_topk, recall, search_legacy,
                                  search_measure)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    measure, store, nbrs, graph, _, _ = ctx["unfused float32"]
    common = serve_common(graph.n, dev)
    _, rng, stream = serve_stream(np, graph.n)
    base_t = torch.as_tensor(graph.base, device=dev)
    qt = torch.as_tensor(np.random.default_rng(7).normal(
        size=(64, 40)).astype(np.float32), device=dev)
    entries = torch.full((64,), graph.entry, device=dev)
    truth = brute_force_topk(measure, base_t, qt, 10)[0]
    out = {}
    for mode in ("guitar", "sl2g"):
        cfg = SearchConfig(k=10, ef=64, budget=8, alpha=1.01, mode=mode)
        eng = search_measure(measure, store, nbrs, qt, entries, cfg,
                             EngineOptions())
        reset_launch_counts()
        leg = search_legacy(measure.score_fn, measure.params, base_t, nbrs,
                            qt, entries, cfg)
        torch.cuda.synchronize()
        require(not any(launch_counts().values()), f"legacy serve {mode}: "
                f"port kernels launched: {launch_counts()}")
        re_, rl = recall(eng.ids, truth), recall(leg.ids, truth)
        require(abs(re_ - rl) <= RECALL_AGREE, f"legacy serve {mode}: "
                f"recall@10 legacy {rl:.4f}, engine {re_:.4f}")
        turns = []
        for searcher in ("engine", "legacy", "legacy", "engine"):
            args = serve.parse_args(common + ["--mode", mode, "--searcher",
                                              searcher])
            rng.bit_generator.state = stream
            reset_launch_counts()
            summ = serve.serve_oneshot(args, graph, measure, cfg,
                                       serve.engine_options(args), store,
                                       nbrs, base_t, rng, dev)
            if searcher == "legacy":
                require(not any(launch_counts().values()), f"serve "
                        f"--searcher legacy --mode {mode} launched "
                        f"{launch_counts()}")
            turns.append({"searcher": searcher, **{k: summ[k] for k in (
                "qps", "p50_ms", "p95_ms", "host_us_per_step",
                "steps_per_batch", "evals_per_query", "recall")}})
        for t in turns:
            log(f"serve --searcher {t['searcher']:6s} --mode {mode}: "
                f"QPS={t['qps']:.1f} p50={t['p50_ms']:.3f}ms "
                f"p95={t['p95_ms']:.3f}ms, {t['host_us_per_step']:.1f}us "
                f"host issue per step, {t['steps_per_batch']:.0f} steps per "
                f"batch, evals/query {t['evals_per_query']:.1f}, recall@10 "
                f"(16) {t['recall']:.4f}")
        log(f"legacy serve {mode} N={graph.n}: recall@10 on 64 queries "
            f"legacy {rl:.4f}, engine {re_:.4f}; evals/query legacy "
            f"{float(leg.n_eval.float().mean()):.1f}, engine "
            f"{float(eng.n_eval.float().mean()):.1f}; no port kernel in "
            f"the legacy runs")
        out[mode] = {"recall_legacy": rl, "recall_engine": re_,
                     "turns": turns}
    refusals = (
        (["--searcher", "legacy", "--fused"], "no index-fused/quantized"),
        (["--searcher", "legacy", "--corpus-dtype", "int8"],
         "no index-fused/quantized"),
        (["--searcher", "legacy", "--runtime", "continuous"],
         "engine-only"))
    for flags, msg in refusals:
        try:
            serve.parse_args(common + flags)
        except SystemExit as e:
            require(msg in str(e), f"serve {flags}: refused with {e}")
        else:
            raise SmokeFailure(f"serve {flags} was not refused")
    log("legacy serve: the launcher refuses --searcher legacy with "
        "--fused, --corpus-dtype int8 and --runtime continuous")
    return out


def tune_context(torch, np, dev, items=100_000):
    """``--only tune``: the serve phase's N=100,000 graph and its run
    context for TUNE_RUNS and 'unfused float32', without the serve phase."""
    from repro_torch.core import (SearchConfig, make_corpus_store,
                                  make_family_measure)
    from repro_torch.graph import build_l2_graph
    from repro_torch.launch import serve
    base, _, _ = serve_stream(np, items)
    graph = build_l2_graph(base, m=24, k_construction=100,
                           exact_threshold=items, device=dev)
    base_t = torch.as_tensor(base, device=dev)
    nbrs = torch.as_tensor(graph.neighbors, device=dev)
    measures = {fam: make_family_measure(fam,
                                         torch.Generator().manual_seed(0),
                                         40, device=dev)
                for fam in ("deepfm", "mlp")}
    cfg = SearchConfig(k=10, ef=64, budget=8, alpha=1.01)
    ctx = {}
    for label, family, extra in SERVE_RUNS:
        if label in TUNE_RUNS + ("unfused float32",):
            args = serve.parse_args(serve_common(items, dev)
                                    + ["--measure", family] + extra)
            store = make_corpus_store(base_t, args.corpus_dtype, device=dev)
            ctx[label] = (measures[family], store, nbrs, graph, cfg,
                          serve.engine_options(args))
    return ctx


def check_tuning(torch, np, dev, ctx):
    """Phase 12: (a) the tile plan at N=5,000, (b)-(c) serve --autotune
    and --tile at N=100,000 (the serve phase's graph), (d) search_legacy
    card vs CPU at N=5,000, (e) serve --searcher legacy at N=100,000."""
    import tempfile
    t_phase = time.perf_counter()
    out, times = {}, {}
    t0 = time.perf_counter()
    out["tile_plan"], (base, graph) = tile_plan_parity(torch, np, dev)
    times["a"] = time.perf_counter() - t0
    equal = {dt: all(v["tile_equals_rowwise"] for k, v in
                     out["tile_plan"].items() if k.endswith(dt))
             for dt in RESIDENCIES}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        out["autotune"] = tune_serve(torch, np, dev, ctx, root, equal)
        times["b-c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["legacy"] = legacy_parity(torch, np, dev, base, graph)
    times["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["legacy_serve"] = legacy_serve(torch, np, dev, ctx)
    times["e"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    out["times"] = times
    log(f"tuning: phase 12 passed in {out['seconds']:.1f}s ("
        + ", ".join(f"({k}) {v:.1f}s" for k, v in times.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# phase 13: the LM and GNN families (the dense and MoE transformers, their
# prefill on the flash kernel and decode on the decode kernel; training
# through the launcher; GIN on fanout-sampled minibatches)
# ---------------------------------------------------------------------------

LM_PARITY_LAYERS = 2        # (a): full width, depth cut to two layers
LM_PARITY_S = 256           # (a): prompt length at B=1
LM_PARITY_STEPS = 4         # (a): decode steps after the prefill
# (a) card against CPU. float32: the flash kernel runs in 3xTF32 and the
# decode kernel on the CUDA cores, cuBLAS and the CPU BLAS sum in other
# orders; the phase 3b attention tolerance (rtol 1e-4), with an atol of
# 1e-4 of the largest |value| for the logits and the cache (a logit sums
# 4,096 products that cancel). bfloat16: rtol 2e-2, atol 2e-2 of the
# float32 CPU run's largest |value| (the CPU tests' bf16 rule).
LM_F32_RTOL, LM_F32_ATOL_OF_MAX = 1e-4, 1e-4
LM_BF16_TOL = 2e-2
# MoE: the CPU run takes the card's routes (``RouteLog``'s ``follow``), so
# its logits and cache stay comparable where a near tie of the router went
# another way on each device; the router logits are held at the same rtol
# and atol-of-max as the rest of the run
YI_PREFILL_B, YI_PREFILL_S = 2, 32768     # (b) prefill_32k, batch cut 32 -> 2
YI_GREEDY_STEPS = 16                      # (b) greedy steps from its cache
YI_DECODE_B, YI_DECODE_T = 8, 32768       # (c) decode_32k, batch cut 128 -> 8
YI_DECODE_STEPS = 32                      # (c) timed steps
GRANITE_S, GRANITE_STEPS = 8192, 16       # (d) prefill at B=1, decode steps
LM_TRAIN_ARCHS = ("yi-9b", "command-r-plus-104b", "starcoder2-3b",
                  "granite-moe-3b-a800m", "gin-tu")
LM_TRAIN_STEPS = 20                       # (e) the launcher's --steps
GIN_STEPS = 10                            # (f) AdamW steps at minibatch_lg
GIN_LR = 1e-2
GIN_LOSS_RTOL = 1e-4                      # (f) first batch's loss, card/CPU


def lm_wall_s(torch, fn):
    """(result, seconds) of ``fn`` on the host clock, synchronised before
    and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lm_segment(torch, label, fn, expect, paths):
    """One main-path segment of phase 13: every launch count set to 0,
    ``fn`` run, the counts read. ``expect`` {kernel: launches} must be
    exactly what launched, and each kernel's launches must all have taken
    ``paths[kernel]``. Returns (fn's result, counts, seconds)."""
    from repro_torch.kernels import (launch_counts, path_launch_counts,
                                     reset_launch_counts)
    reset_launch_counts()
    out, secs = lm_wall_s(torch, fn)
    counts = {k: v for k, v in launch_counts().items() if v}
    require(counts == expect, f"lm {label}: kernel launches {counts}, "
            f"expected {expect}")
    by_path = path_launch_counts()
    for name, path in paths.items():
        got = by_path[name]
        require(got == {p: (expect[name] if p == path else 0) for p in got},
                f"lm {label}: {name} launches by path {got}; every launch "
                f"must take {path}")
    return out, counts, secs


def lm_profile(torch, label, fn, kinds):
    """torch.profiler over one call of ``fn``: wall and device-busy us, and
    the device time of the kernels whose names hold each substring of
    ``kinds`` ({label: substring}) as a share of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = device_busy_us((e.time_range.start, e.time_range.end)
                          for e in kern)
    by_name = collections.Counter()
    for e in kern:
        by_name[e.name] += e.time_range.elapsed_us()
    out = {"wall_us": wall_us, "busy_us": busy, "events": len(kern)}
    for kind, sub in kinds.items():
        us = sum(t for n, t in by_name.items() if sub in n)
        out[kind + "_us"] = us
        out[kind + "_share"] = us / busy if busy else 0.0
    top = by_name.most_common(6)
    log(f"lm profile {label}: wall {wall_us / 1e3:.2f}ms, device busy "
        f"{busy / 1e3:.2f}ms ({busy / wall_us:.1%}), {len(kern)} device "
        f"events; " + ", ".join(f"{k} {out[k + '_us'] / 1e3:.2f}ms "
                                f"({out[k + '_share']:.1%} of busy)"
                                for k in kinds))
    for name, t in top:
        log(f"lm profile {label}:   {t / 1e3:9.3f}ms  {name[:90]}")
    out["top"] = [(n, t) for n, t in top]
    return out


class RouteLog:
    """Records every (router logits, own expert ids) that ``moe.route``
    computes while installed (``with RouteLog(torch, moe_lib) as log_:``).
    Given ``follow``, another run's calls in the same order, each call
    returns that run's expert ids instead of its own, weighted by this
    run's own affinities at those ids: this run then takes the other's
    routes, so its outputs stay comparable with the other's even where the
    two devices' rounding decides a near tie differently."""

    def __init__(self, torch, moe_lib, follow=None):
        self.torch, self.moe, self.follow, self.calls = torch, moe_lib, \
            follow, []

    def __enter__(self):
        real = self.real = self.moe.route
        torch = self.torch

        def route(logits, top_k, router_type="softmax"):
            w, idx = real(logits, top_k, router_type)
            i = len(self.calls)
            self.calls.append((logits.detach().float().cpu(),
                               idx.detach().cpu()))
            if self.follow is None:
                return w, idx
            require(i < len(self.follow), f"lm routes: router call {i} "
                    f"has no counterpart in the run it follows")
            idx = self.follow[i][1].to(logits.device)
            s = logits.to(torch.float32)
            s = torch.sigmoid(s) if router_type == "sigmoid" \
                else torch.softmax(s, dim=-1)
            w = s.gather(-1, idx.long())
            return w / (w.sum(dim=-1, keepdim=True) + 1e-20), idx

        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


def route_check(torch, card_calls, cpu_calls, n_experts, K, rtol,
                atol_of_max, label):
    """The CPU run having followed the card's routes (``RouteLog``'s
    ``follow``), holds every router call's logits, the card's against the
    CPU's, at ``rtol`` and an atol of ``atol_of_max`` of the CPU call's
    largest |logit|, and the card's expert ids as the exact top-K of its
    own logits. Returns the tokens whose own top-K sets differ (a near tie
    that the two devices' rounding decides apart: it spans no more than
    the logits' held difference), the first call with one, the largest
    gap of the CPU's own K-th and (K+1)-th logit among them, and the
    logits' worst ratio to their tolerance."""
    require(len(card_calls) == len(cpu_calls),
            f"{label}: {len(card_calls)} router calls on the card, "
            f"{len(cpu_calls)} on the CPU")
    flips, first, gap, worst = 0, None, 0.0, 0.0
    for i, ((lc, ic), (lp, ip)) in enumerate(zip(card_calls, cpu_calls)):
        lc, lp = lc[:, :n_experts], lp[:, :n_experts]   # no padded expert
        worst = max(worst, close_err(lc, lp, rtol,
                                     atol_of_max * float(lp.abs().max()))[1])
        ic = ic.long()
        rest = lc.scatter(-1, ic, float("-inf"))
        require(bool((lc.gather(-1, ic).min(dim=-1).values
                      >= rest.max(dim=-1).values).all()),
                f"{label}: router call {i}: the card's expert ids are not "
                f"the top-{K} of its own logits")
        bad = (ic.sort(dim=-1).values
               != ip.long().sort(dim=-1).values).any(dim=-1)
        n = int(bad.sum())
        if n:
            flips += n
            first = i if first is None else first
            top = lp[bad].sort(dim=-1, descending=True).values
            gap = max(gap, float((top[:, K - 1] - top[:, K]).max()))
    require(worst <= 1.0, f"{label}: router logits card vs CPU at "
            f"{worst:.3f} of the tolerance (rtol {rtol}, atol {atol_of_max} "
            f"x max)")
    return {"flips": flips, "first": first, "gap": gap,
            "logit_tol_ratio": worst}


def lm_run(torch, np, tf, moe_lib, params, cfg, prompt, steps, dev,
           follow=None):
    """(a) one device's run: prefill ``prompt`` (1, S), the cache grown by
    len(steps), then one teacher-forced decode step per token of
    ``steps``; on the card each call is a launch-checked segment; with
    ``follow`` (another run's router calls) the routes are that run's.
    Returns (logits per call, cache, router calls)."""
    n = cfg.n_layers
    dt = str(cfg.dtype).split(".")[-1]
    paths = {"flash_attention": "tensor_core_tf32" if dt == "float32"
             else "tensor_core",
             "decode_attention": "cuda_core" if dt == "float32"
             else "tensor_core"}
    card = dev.type == "cuda"
    toks = torch.as_tensor(prompt, device=dev)
    with RouteLog(torch, moe_lib, follow) as routes:
        call = lambda: tf.prefill(params, toks, cfg)  # noqa: E731
        if card:
            (lg, cache), launches, _ = lm_segment(
                torch, f"(a) {cfg.name} {dt} prefill", call,
                {"flash_attention": n},
                {"flash_attention": paths["flash_attention"]})
        else:
            lg, cache = call()
        logits = [lg.float().cpu()]
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, len(steps)))
                 for k, v in cache.items()}
        S = prompt.shape[1]
        for i, tok in enumerate(steps):
            t = torch.as_tensor(np.asarray([tok]), device=dev)
            pos = torch.tensor([S + i], dtype=torch.int32, device=dev)
            call = lambda: tf.decode_step(params, cache, t, pos, cfg)  # noqa
            if card:
                (lg, cache), _, _ = lm_segment(
                    torch, f"(a) {cfg.name} {dt} decode step {i}", call,
                    {"decode_attention": n},
                    {"decode_attention": paths["decode_attention"]})
            else:
                lg, cache = call()
            logits.append(lg.float().cpu())
    return logits, {k: v.float().cpu() for k, v in cache.items()}, \
        routes.calls


def lm_parity(torch, np, dev, name):
    """(a) ``name`` at its published widths, two layers: one init (drawn on
    the card, copied to the CPU), float32 then bf16; prefill logits and
    cache, then LM_PARITY_STEPS decode steps, card against CPU."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map
    base = dataclasses.replace(get_arch(name).make_config(),
                               n_layers=LM_PARITY_LAYERS,
                               dtype=torch.float32)
    if base.is_moe:
        # capacity = T: no token can be dropped at any batch
        base = dataclasses.replace(
            base, capacity_factor=moe_lib.pad_experts(base.n_experts)
            / base.moe_top_k)
    params, _ = tf.init_params(torch.Generator(device=dev).manual_seed(0),
                               base, device=dev)
    r = np.random.default_rng(0)
    toks = r.integers(0, base.vocab_size, (1, LM_PARITY_S + LM_PARITY_STEPS))
    prompt, steps = toks[:, :LM_PARITY_S], toks[0, LM_PARITY_S:]
    out = {}
    f32_max = None
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt).split(".")[-1]
        cfg = dataclasses.replace(base, dtype=dt)
        p_card = tree_map(lambda t: t.to(dt), params)
        p_cpu = tree_map(lambda t: t.cpu(), p_card)
        t0 = time.perf_counter()
        card = lm_run(torch, np, tf, moe_lib, p_card, cfg, prompt, steps, dev)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = lm_run(torch, np, tf, moe_lib, p_cpu, cfg, prompt, steps,
                     torch.device("cpu"), follow=card[2])
        t_cpu = time.perf_counter() - t0
        del p_card, p_cpu
        if dt == torch.float32:
            rtol, atol_of_max = LM_F32_RTOL, LM_F32_ATOL_OF_MAX
        else:
            rtol, atol_of_max = LM_BF16_TOL, LM_BF16_TOL
        routes = None
        if base.is_moe:
            routes = route_check(torch, card[2], cpu[2], base.n_experts,
                                 base.moe_top_k, rtol, atol_of_max,
                                 f"lm (a) {name} {key}")
        got = card[0] + [card[1]["k"], card[1]["v"]]
        want = cpu[0] + [cpu[1]["k"], cpu[1]["v"]]
        if f32_max is None:
            f32_max = [float(w.abs().max()) for w in want]
        worst, errs = 0.0, []
        for g, w, m in zip(got, want, f32_max):
            err, ratio = close_err(g, w, rtol, atol_of_max * m)
            errs.append(err)
            worst = max(worst, ratio)
        names = (["prefill"] + [f"step {i}" for i in range(len(steps))]
                 + ["cache k", "cache v"])
        log(f"lm (a) {name} x{LM_PARITY_LAYERS} layers {key}: card vs CPU "
            f"max_abs_err " + ", ".join(f"{n_} {e:.3e}"
                                        for n_, e in zip(names, errs))
            + f"; {worst:.3f} of the tolerance (rtol {rtol}, atol "
            + f"{atol_of_max} x {'max' if dt == torch.float32 else 'f32 max'}"
            + f"); card {t_card:.1f}s, CPU {t_cpu:.1f}s")
        if routes is not None:
            log(f"lm (a) {name} {key}: the CPU took the card's routes; "
                f"router logits {routes['logit_tol_ratio']:.3f} of the "
                f"tolerance over {len(card[2])} router calls; the CPU's own "
                f"top-{base.moe_top_k} differs at {routes['flips']} tokens"
                + (f", first at router call {routes['first']} (layer "
                   f"{routes['first'] % base.n_layers} of the "
                   f"{'prefill' if routes['first'] < base.n_layers else 'decode'}"
                   f"), its K-th and (K+1)-th logits at most "
                   f"{routes['gap']:.2e} apart: near ties that the two "
                   f"devices' rounding decides apart"
                   if routes["flips"] else ""))
        require(worst <= 1.0, f"lm (a) {name} {key}: the card differs "
                f"from the CPU by {worst:.3f} of the tolerance")
        out[key] = {"max_abs_err": max(errs), "tol_ratio": worst,
                    "errs": dict(zip(names, errs)), "routes": routes,
                    "card_s": t_card, "cpu_s": t_cpu}
    del params
    torch.cuda.empty_cache()
    return out


def lm_steps(tf, params, cfg, cache, tok, pos, n, vocab):
    """``n`` greedy decode steps from ``tok`` at ``pos`` (a device tensor,
    advanced in place): no host sync. Returns the last logits."""
    lg = None
    for _ in range(n):
        lg, cache = tf.decode_step(params, cache, tok, pos, cfg)
        tok = lg[:, :vocab].argmax(dim=-1)
        pos += 1
    return lg


def lm_decode_bound_ms(params, cfg, B, pos0, n):
    """Least ms of ``n`` decode steps from ``pos0``: every weight read once a
    step (the token table's B rows only, unless it is tied to the head),
    each step's valid K and V prefix of every layer read once."""
    from repro_torch.tree import tree_bytes
    w = tree_bytes(params)
    if not cfg.tie_embeddings:
        w -= params["embed"].numel() * params["embed"].element_size()
    esize = params["embed"].element_size()
    kv = sum(2 * cfg.n_layers * B * (pos0 + i + 1) * cfg.n_kv_heads
             * cfg.head_dim * esize for i in range(n))
    return (n * w + kv) / H100_BYTES_PER_S * 1e3


def yi_full(torch, np, dev):
    """(b) Yi-9B at full width, 48 layers, bf16: prefill_32k at batch 2,
    then greedy steps from its cache; (c) decode_32k at batch 8 from a
    32,768-token cache drawn from a generator."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_bytes, tree_size
    cfg = dataclasses.replace(get_arch("yi-9b").make_config(),
                              dtype=torch.bfloat16)
    L_, V = cfg.n_layers, cfg.vocab_size
    out = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    (params, _), t_init = lm_wall_s(torch, lambda: tf.init_params(
        gen, cfg, device=dev))
    out["params"], out["param_bytes"] = tree_size(params), tree_bytes(params)
    out["init_s"] = t_init
    log(f"lm (b) Yi-9B: {out['params']:,} parameters, "
        f"{out['param_bytes'] / 1e9:.2f} GB bf16, drawn on the card in "
        f"{t_init:.1f}s")
    B, S = YI_PREFILL_B, YI_PREFILL_S
    toks = torch.randint(0, V, (B, S), generator=gen, device=dev)
    tf.prefill(params, toks[:1, :512], cfg)           # cuBLAS and kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (lg, cache), launches, t_pre = lm_segment(
        torch, "(b) Yi-9B prefill_32k B=2", lambda: tf.prefill(params, toks,
                                                               cfg),
        {"flash_attention": L_}, {"flash_attention": "tensor_core"})
    peak = torch.cuda.max_memory_allocated()
    require(tuple(lg.shape) == (B, tf.L.pad_vocab(V))
            and bool(torch.isfinite(lg[:, :V]).all()),
            f"lm (b): prefill logits {tuple(lg.shape)} not finite")
    out["prefill"] = {"B": B, "S": S, "s": t_pre,
                      "tokens_per_s": B * S / t_pre,
                      "launches": launches, "peak_gb": peak / 1e9}
    # GEMMs: every weight but the tables once per token, the head once
    # per sequence (prefill's logits are the last position's)
    head = params["lm_head"].numel()
    flops = 2 * (out["params"] - params["embed"].numel() - head) * B * S \
        + 2 * head * B
    attn_flops = 4 * cfg.n_heads * cfg.head_dim * B * (S * (S + 1) // 2) \
        * L_
    out["prefill"]["floor_s"] = (flops + attn_flops) / H100_BF16_FLOPS
    log(f"lm (b) Yi-9B prefill_32k B={B}: {t_pre:.3f}s, "
        f"{B * S / t_pre:,.0f} tokens/s (floor {out['prefill']['floor_s']:.3f}"
        f"s: {flops:.3g} GEMM + {attn_flops:.3g} causal attention FLOPs at "
        f"989 TFLOP/s), flash_attention launched {launches} (1 a layer), "
        f"peak {peak / 1e9:.1f} GB")
    # the prefill's cache, grown by the greedy steps
    T = S + YI_GREEDY_STEPS
    small, cache = cache, {}
    for k in ("k", "v"):
        cache[k] = torch.empty((L_, B, T, cfg.n_kv_heads, cfg.head_dim),
                               dtype=cfg.dtype, device=dev)
        cache[k][:, :, :S].copy_(small[k])
    del small
    out["prefill"]["profile"] = lm_profile(
        torch, "(b) Yi-9B prefill_32k B=2",
        lambda: tf.prefill(params, toks, cfg), {"flash": "flash_"})
    tok = lg[:, :V].argmax(dim=-1)
    pos = torch.tensor([S], dtype=torch.int32, device=dev)
    tf.decode_step(params, cache, tok, pos, cfg)       # warm; rewritten
    pos = torch.tensor([S], dtype=torch.int32, device=dev)
    lg_last, launches, t_dec = lm_segment(
        torch, "(b) Yi-9B greedy steps",
        lambda: lm_steps(tf, params, cfg, cache, tok, pos, YI_GREEDY_STEPS,
                         V),
        {"decode_attention": L_ * YI_GREEDY_STEPS},
        {"decode_attention": "tensor_core"})
    require(bool(torch.isfinite(lg_last[:, :V]).all()),
            "lm (b): decode logits not finite")
    out["greedy"] = {"steps": YI_GREEDY_STEPS,
                     "ms_per_step": t_dec / YI_GREEDY_STEPS * 1e3,
                     "launches": launches,
                     "bound_ms_per_step": lm_decode_bound_ms(
                         params, cfg, B, S, YI_GREEDY_STEPS)
                     / YI_GREEDY_STEPS}
    pos = torch.tensor([T - 1], dtype=torch.int32, device=dev)
    out["greedy"]["profile"] = lm_profile(
        torch, "(b) Yi-9B decode step B=2 at 32,784",
        lambda: tf.decode_step(params, cache, tok, pos, cfg),
        {"decode": "decode_"})
    log(f"lm (b) Yi-9B {YI_GREEDY_STEPS} greedy steps from the 32,768-token "
        f"cache (B={B}): {out['greedy']['ms_per_step']:.2f}ms a step (bound "
        f"{out['greedy']['bound_ms_per_step']:.2f}ms), decode_attention "
        f"launched {launches} ({L_} a step)")
    del cache, lg, lg_last
    torch.cuda.empty_cache()

    # (c) decode_32k at batch 8 from a drawn cache
    Bd, T = YI_DECODE_B, YI_DECODE_T
    cache = {}
    for k in ("k", "v"):
        cache[k] = torch.empty((L_, Bd, T, cfg.n_kv_heads, cfg.head_dim),
                               dtype=cfg.dtype, device=dev)
        for i in range(L_):
            cache[k][i].normal_(generator=gen)
    cache_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    pos0 = T - YI_DECODE_STEPS - 2
    tok = torch.randint(0, V, (Bd,), generator=gen, device=dev)
    pos = torch.tensor([pos0], dtype=torch.int32, device=dev)
    lm_steps(tf, params, cfg, cache, tok, pos, 2, V)     # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed():
        start.record()
        lg = lm_steps(tf, params, cfg, cache, tok, pos, YI_DECODE_STEPS, V)
        end.record()
        return lg

    lg, launches, t_dec = lm_segment(
        torch, "(c) Yi-9B decode_32k B=8", timed,
        {"decode_attention": L_ * YI_DECODE_STEPS},
        {"decode_attention": "tensor_core"})
    require(bool(torch.isfinite(lg[:, :V]).all()),
            "lm (c): decode logits not finite")
    bound = lm_decode_bound_ms(params, cfg, Bd, pos0 + 2,
                               YI_DECODE_STEPS) / YI_DECODE_STEPS
    out["decode_32k"] = {
        "B": Bd, "T": T, "steps": YI_DECODE_STEPS, "cache_gb": cache_gb,
        "ms_per_step": t_dec / YI_DECODE_STEPS * 1e3,
        "device_ms_per_step": start.elapsed_time(end) / YI_DECODE_STEPS,
        "bound_ms_per_step": bound, "launches": launches}
    pos = torch.tensor([T - 1], dtype=torch.int32, device=dev)
    out["decode_32k"]["profile"] = lm_profile(
        torch, "(c) Yi-9B decode_32k step B=8",
        lambda: tf.decode_step(params, cache, tok, pos, cfg),
        {"decode": "decode_"})
    d = out["decode_32k"]
    log(f"lm (c) Yi-9B decode_32k B={Bd}: {d['ms_per_step']:.2f}ms a step "
        f"on the host clock ({d['device_ms_per_step']:.2f}ms between device "
        f"events), bound {bound:.2f}ms ({out['param_bytes'] / 1e9:.2f} GB of "
        f"weights + {cache_gb:.2f} GB of cache at 3.35 TB/s); "
        f"decode_attention launched {launches}")
    del cache, params, lg
    torch.cuda.empty_cache()
    return out


def granite_full(torch, np, dev):
    """(d) Granite-MoE-3B at full width, 32 layers, bf16: a prefill at
    B=1, S=8,192, then greedy steps; the MoE dispatch's share of one
    prefill layer."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_size
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m").make_config(),
                              dtype=torch.bfloat16)
    L_, V, S = cfg.n_layers, cfg.vocab_size, GRANITE_S
    gen = torch.Generator(device=dev).manual_seed(1)
    params, _ = tf.init_params(gen, cfg, device=dev)
    out = {"params": tree_size(params)}
    toks = torch.randint(0, V, (1, S), generator=gen, device=dev)
    tf.prefill(params, toks[:, :256], cfg)
    (lg, small), launches, t_pre = lm_segment(
        torch, "(d) Granite prefill S=8192", lambda: tf.prefill(params, toks,
                                                                cfg),
        {"flash_attention": L_}, {"flash_attention": "tensor_core"})
    require(bool(torch.isfinite(lg[:, :V]).all()),
            "lm (d): prefill logits not finite")
    out["prefill"] = {"S": S, "s": t_pre, "tokens_per_s": S / t_pre,
                      "launches": launches}
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, GRANITE_STEPS))
             for k, v in small.items()}
    del small
    tok = lg[:, :V].argmax(dim=-1)
    pos = torch.tensor([S], dtype=torch.int32, device=dev)
    tf.decode_step(params, cache, tok, pos, cfg)       # warm; rewritten
    pos = torch.tensor([S], dtype=torch.int32, device=dev)
    lg, launches, t_dec = lm_segment(
        torch, "(d) Granite greedy steps",
        lambda: lm_steps(tf, params, cfg, cache, tok, pos, GRANITE_STEPS, V),
        {"decode_attention": L_ * GRANITE_STEPS},
        {"decode_attention": "tensor_core"})
    require(bool(torch.isfinite(lg[:, :V]).all()),
            "lm (d): decode logits not finite")
    out["decode"] = {"steps": GRANITE_STEPS,
                     "ms_per_step": t_dec / GRANITE_STEPS * 1e3,
                     "launches": launches}
    # one prefill layer, its MoE FFN and the expert products alone
    lp = tf.layer_params(params, 0)
    x = tf._embed(params, toks, cfg)
    rope = tf._rope(cfg, torch.arange(S, device=dev)[None, :])
    h = tf._norm(cfg, x, lp["norm"]["ln2"])
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
              capacity_factor=cfg.capacity_factor, n_groups=cfg.moe_groups)
    buf = moe_lib.dispatch(lp["mlp"], h.reshape(S, -1), **kw)[0]
    with torch.no_grad():
        layer_ms = event_ms(lambda: tf._layer(cfg, x, lp, rope, "prefill"),
                            reps=5)
        moe_ms = event_ms(lambda: moe_lib.moe_ffn(lp["mlp"], h, **kw),
                          reps=5)
        expert_ms = event_ms(lambda: moe_lib.expert_ffn(lp["mlp"], buf),
                             reps=5)
    out["layer"] = {"layer_ms": layer_ms, "moe_ms": moe_ms,
                    "expert_ms": expert_ms,
                    "dispatch_share": (moe_ms - expert_ms) / layer_ms,
                    "capacity": int(buf.shape[1])}
    log(f"lm (d) Granite-MoE-3B: {out['params']:,} parameters (48 experts "
        f"with the padding), prefill S={S} {t_pre:.3f}s ({S / t_pre:,.0f} "
        f"tokens/s, flash_attention launched {out['prefill']['launches']}), "
        f"{GRANITE_STEPS} greedy steps {out['decode']['ms_per_step']:.2f}ms a "
        f"step (decode_attention launched {launches}); one prefill layer "
        f"{layer_ms:.3f}ms, its MoE FFN {moe_ms:.3f}ms of which the expert "
        f"products {expert_ms:.3f}ms (capacity {buf.shape[1]} a expert): "
        f"routing, dispatch and combine "
        f"{out['layer']['dispatch_share']:.1%} of the layer")
    del params, cache, x, h, buf
    torch.cuda.empty_cache()
    return out


def lm_train(torch, np, dev):
    """(e) ``python -m repro_torch.launch.train --arch A --steps 20`` for
    each LM and GNN arch (the smoke configs, as the JAX launcher runs
    them), and the first step's loss and gradients card against CPU (the
    same weights, float32)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch
    from repro_torch.models import moe as moe_lib
    from repro_torch.train.trainer import value_and_grad
    out = {}
    for name in LM_TRAIN_ARCHS:
        t0 = time.perf_counter()
        tr = launch.main(["--arch", name, "--steps", str(LM_TRAIN_STEPS),
                          "--device", str(dev)])
        secs = time.perf_counter() - t0
        losses = [h["loss"] for h in tr.history]
        require(len(losses) == LM_TRAIN_STEPS
                and all(np.isfinite(losses)),
                f"lm (e) {name}: the launcher's losses {losses}")
        arch = get_arch(name)
        cfg = arch.make_smoke_config()
        if arch.family == "lm":
            cfg = dataclasses.replace(cfg, dtype=torch.float32)
        runs = {}
        for where in (str(dev), "cpu"):     # the CPU takes the card's routes
            gen = torch.Generator().manual_seed(0)
            if arch.family == "lm":
                params, loss_fn, batch_fn = launch.lm_setup(
                    arch, cfg, 16, 64, device=where, generator=gen)
            else:
                params, loss_fn, batch_fn = launch.gnn_setup(
                    arch, cfg, device=where, generator=gen)
            follow = runs[str(dev)][2] if where == "cpu" else None
            with RouteLog(torch, moe_lib, follow) as routes:
                loss, grads = value_and_grad(loss_fn, params, batch_fn(0))
            runs[where] = (float(loss), grads, routes.calls)
        (lc, gc, rc), (ld, gd, rd) = runs["cpu"], runs[str(dev)]
        flips = 0
        if getattr(cfg, "is_moe", False):
            flips = route_check(torch, rd, rc, cfg.n_experts, cfg.moe_top_k,
                                STEP_RTOL, SMOKE_GRAD_ATOL_OF_MAX,
                                f"lm (e) {name}")["flips"]
        g_worst = _worst(torch, gd, gc, STEP_RTOL, 0.0,
                         SMOKE_GRAD_ATOL_OF_MAX)
        log(f"lm (e) {name}: launcher {LM_TRAIN_STEPS} steps on the card, "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f} in {secs:.1f}s "
            f"({step_ms(tr.history):.1f}ms a step after the first); first "
            f"step float32 card vs CPU: loss {ld:.6f} / {lc:.6f}, gradients "
            f"{g_worst:.3f} of their tolerance (rtol {STEP_RTOL}, atol "
            f"{SMOKE_GRAD_ATOL_OF_MAX} x max)"
            + (f"; the CPU took the card's routes, its own top-"
               f"{cfg.moe_top_k} differing at {flips} tokens (near ties)"
               if flips else ""))
        require(abs(ld - lc) <= STEP_RTOL * abs(lc) and g_worst <= 1.0,
                f"lm (e) {name}: the card's first step differs from the "
                f"CPU's (loss {ld} / {lc}, gradients {g_worst:.3f})")
        out[name] = {"losses": losses, "s": secs,
                     "ms_per_step": step_ms(tr.history),
                     "loss_cpu": lc, "loss_card": ld, "grad_worst": g_worst,
                     "route_flips": flips}
        del tr
    torch.cuda.empty_cache()
    return out


def gin_minibatch(torch, np, dev):
    """(f) GIN at minibatch_lg: a graph at the shape's own sizes from the
    ported ``make_graph``, the ported ``NeighborSampler`` (15/10 fanouts,
    1,024 seeds, padded to 262,144 nodes and edges), GIN_STEPS AdamW steps
    on the card over fresh samples of the same seeds; the loss finite and
    falling, the first batch's loss card = CPU, the sampler timed against
    the step."""
    from repro_torch.configs import get_arch
    from repro_torch.configs import gin_tu
    from repro_torch.data import NeighborSampler, make_graph
    from repro_torch.models import gnn
    from repro_torch.train import OptimizerConfig, adamw_init
    from repro_torch.train.trainer import make_train_step
    from repro_torch.tree import tree_map
    shape = get_arch("gin-tu").shape("minibatch_lg")
    cfg = gin_tu.config(shape)
    n, e = shape["n_nodes"], shape["n_edges"]
    t0 = time.perf_counter()
    g = make_graph(n, e, shape["d_feat"], n_classes=shape["n_classes"],
                   seed=0)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = NeighborSampler(g["src"], g["dst"], n,
                              (shape["fanout0"], shape["fanout1"]), seed=0)
    t_csr = time.perf_counter() - t0
    log(f"lm (f) GIN minibatch_lg: make_graph {n:,} nodes, {e:,} edges, "
        f"d_feat {shape['d_feat']} in {t_graph:.1f}s; the sampler's CSR in "
        f"{t_csr:.1f}s")
    seeds = np.random.default_rng(0).choice(n, shape["batch_nodes"],
                                            replace=False)
    mx_n, mx_e = shape["max_nodes"], shape["max_edges"]
    params, _ = gnn.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    p_cpu = tree_map(lambda t: t.detach().cpu().clone(), params)

    def batch_of(b, where):
        labels = np.zeros(mx_n, np.int32)
        mask = np.zeros(mx_n, np.float32)
        labels[b.seed_local] = b.labels
        mask[b.seed_local] = 1.0
        d = {"feats": b.feats, "src": b.src, "dst": b.dst,
             "edge_mask": b.edge_mask, "labels": labels, "mask": mask}
        return {k: torch.as_tensor(v).to(where) for k, v in d.items()}

    def loss_fn(p, b):
        return gnn.node_classification_loss(
            p, b["feats"], b["src"], b["dst"], b["labels"], b["mask"], cfg,
            edge_mask=b["edge_mask"])

    ocfg = OptimizerConfig(lr=GIN_LR, warmup_steps=0, total_steps=GIN_STEPS)
    step = make_train_step(loss_fn, ocfg)
    state = adamw_init(params, ocfg)
    losses, t_sample, t_copy, t_step, sizes = [], [], [], [], []
    for i in range(GIN_STEPS):
        t0 = time.perf_counter()
        b = sampler.sample(seeds, g["feats"], g["labels"], mx_n, mx_e)
        t_sample.append(time.perf_counter() - t0)
        sizes.append((b.n_nodes, int(b.edge_mask.sum())))
        batch, dt = lm_wall_s(torch, lambda: batch_of(b, dev))
        t_copy.append(dt)
        if i == 0:
            with torch.no_grad():
                l_cpu = float(loss_fn(p_cpu, batch_of(b, "cpu")))
        (params, state, m), dt = lm_wall_s(
            torch, lambda: step(params, state, batch))
        losses.append(float(m["loss"]))
        t_step.append(dt)
    del p_cpu
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"lm (f) GIN: losses {losses} not finite and falling")
    require(abs(losses[0] - l_cpu) <= GIN_LOSS_RTOL * abs(l_cpu),
            f"lm (f) GIN: first batch's loss {losses[0]} on the card, "
            f"{l_cpu} on the CPU")
    med = statistics.median
    out = {"graph_s": t_graph, "csr_s": t_csr, "losses": losses,
           "loss_cpu": l_cpu, "sample_s": med(t_sample),
           "copy_s": med(t_copy), "step_s": med(t_step[1:]),
           "first_step_s": t_step[0], "nodes_edges": sizes}
    log(f"lm (f) GIN minibatch_lg: {GIN_STEPS} AdamW steps (lr {GIN_LR}) "
        f"over fresh samples of the same {len(seeds)} seeds "
        f"({sizes[0][0]:,} nodes, {sizes[0][1]:,} edges of "
        f"{mx_n:,} / {mx_e:,}): loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(first batch on the CPU {l_cpu:.4f}); the sampler "
        f"{out['sample_s'] * 1e3:.0f}ms, the batch's copy to the card "
        f"{out['copy_s'] * 1e3:.0f}ms, a step {out['step_s'] * 1e3:.1f}ms "
        f"(first {t_step[0] * 1e3:.0f}ms)")
    del params, state
    torch.cuda.empty_cache()
    return out


def check_lm(torch, np, dev):
    """Phase 13: (a) Yi-9B and Granite at full width, two layers, card vs
    CPU at float32 and bf16; (b) Yi-9B prefill_32k at batch 2 and greedy
    decoding; (c) decode_32k at batch 8; (d) Granite at full width; (e)
    the launcher trains each LM and GNN arch; (f) GIN at minibatch_lg."""
    t_phase = time.perf_counter()
    out, secs = {}, {}
    log(f"lm: phase 13, TF32 "
        f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'} for "
        f"matrix products")
    t0 = time.perf_counter()
    out["parity"] = {name: lm_parity(torch, np, dev, name)
                     for name in ("yi-9b", "granite-moe-3b-a800m")}
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["yi"] = yi_full(torch, np, dev)
    secs["b-c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["granite"] = granite_full(torch, np, dev)
    secs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train"] = lm_train(torch, np, dev)
    secs["e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["gin"] = gin_minibatch(torch, np, dev)
    secs["f"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    out["seconds_by_part"] = secs
    log(f"lm: phase 13 passed in {out['seconds']:.1f}s ("
        + ", ".join(f"({k}) {v:.1f}s" for k, v in secs.items()) + ")")
    return out


KERNEL_META = {
    "deepfm_score": ("src/repro_torch/kernels/csrc/deepfm_score.cu",
                     "src/repro/kernels/deepfm_score/kernel.py:46"),
    "neighbor_rank": ("src/repro_torch/kernels/csrc/neighbor_rank.cu",
                      "src/repro/kernels/neighbor_rank/kernel.py:47"),
    "deepfm_grad": ("src/repro_torch/kernels/csrc/deepfm_grad.cu",
                    "src/repro/kernels/deepfm_grad/kernel.py:63"),
    "deepfm_score_fused": (
        "src/repro_torch/kernels/csrc/deepfm_score_fused.cu",
        "src/repro/kernels/deepfm_score_fused/kernel.py:101"),
    "neighbor_rank_fused": (
        "src/repro_torch/kernels/csrc/neighbor_rank_fused.cu",
        "src/repro/kernels/neighbor_rank_fused/kernel.py:70"),
    "deepfm_grad_fused": (
        "src/repro_torch/kernels/csrc/deepfm_grad_fused.cu",
        "src/repro/kernels/deepfm_grad_fused/kernel.py:85"),
    "mlp_score": ("src/repro_torch/kernels/csrc/mlp_score.cu",
                  "src/repro/kernels/mlp_score/kernel.py:52"),
    "mlp_score_fused": ("src/repro_torch/kernels/csrc/mlp_score_fused.cu",
                        "src/repro/kernels/mlp_score/kernel.py:126"),
    "mlp_grad": ("src/repro_torch/kernels/csrc/mlp_grad.cu",
                 "src/repro/kernels/mlp_grad/kernel.py:73"),
    "mlp_grad_fused": ("src/repro_torch/kernels/csrc/mlp_grad_fused.cu",
                       "src/repro/kernels/mlp_grad/kernel.py:131"),
}
KERNEL_META.update({
    "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/kernel.py:41"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                         "src/repro/kernels/decode_attn/kernel.py:59"),
    # flash_attention's two main-path kernels: bf16 (wgmma) and float32
    # (3xTF32); bf16 at hd = 8 runs csrc/flash_attn.cu
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn_tc.cu",
                        "src/repro/kernels/flash_attn/kernel.py:67"),
    "flash_attention_f32": ("src/repro_torch/kernels/csrc/flash_attn_tf32.cu",
                            "src/repro/kernels/flash_attn/kernel.py:67"),
})
WRAPPER = {"deepfm_score": "deepfm_score", "neighbor_rank": "neighbor_rank",
           "deepfm_grad": "deepfm_value_and_grad",
           "deepfm_score_fused": "deepfm_score_fused",
           "neighbor_rank_fused": "neighbor_rank_fused",
           "deepfm_grad_fused": "deepfm_grad_fused",
           "mlp_score": "mlp_score", "mlp_score_fused": "mlp_score_fused",
           "mlp_grad": "mlp_value_and_grad",
           "mlp_grad_fused": "mlp_grad_fused",
           "embedding_bag": "embedding_bag",
           "decode_attention": "decode_attention",
           "flash_attention": "flash_attention",
           "flash_attention_f32": "flash_attention"}
# the run whose launches each kernel reports: a serve run by its label, or
# ("phase", name) for a kernel off the serving paths, whose launches come
# from that phase's main-path segments
LAUNCH_RUN = {"deepfm_score": "unfused float32",
              "neighbor_rank": "unfused float32",
              "deepfm_grad": "unfused float32",
              "deepfm_score_fused": "fused int8 adaptive",
              "neighbor_rank_fused": "fused int8 adaptive",
              "deepfm_grad_fused": "fused int8 adaptive",
              "mlp_score": "mlp unfused float32",
              "mlp_grad": "mlp unfused float32",
              "mlp_score_fused": "mlp fused int8 adaptive",
              "mlp_grad_fused": "mlp fused int8 adaptive",
              "embedding_bag": ("phase", "library_kernels"),
              "decode_attention": ("phase", "library_kernels"),
              "flash_attention": ("phase", "library_kernels"),
              "flash_attention_f32": ("phase", "library_kernels")}
LINE_RESIDENCY = "int8"   # the fused kernels' numbers in the kernels line
# the LM path's launches and times of the attention kernels (phase 13, Yi-9B
# at full width): launches per prefill and per decode step, and the
# kernels' share of a profiled prefill or step
LM_PATH = {
    "flash_attention": lambda lm: {
        "launches_per_prefill": lm["yi"]["prefill"]["launches"][
            "flash_attention"],
        "prefill_s": lm["yi"]["prefill"]["s"],
        "share_of_prefill": lm["yi"]["prefill"]["profile"]["flash_share"],
        "ms_in_prefill": lm["yi"]["prefill"]["profile"]["flash_us"] / 1e3},
    "decode_attention": lambda lm: {
        "launches_per_step": lm["yi"]["decode_32k"]["launches"][
            "decode_attention"] // YI_DECODE_STEPS,
        "step_ms": lm["yi"]["decode_32k"]["ms_per_step"],
        "share_of_step": lm["yi"]["decode_32k"]["profile"]["decode_share"],
        "ms_in_step": lm["yi"]["decode_32k"]["profile"]["decode_us"] / 1e3},
}


def kernel_line(results) -> dict:
    timed = {**results["kernels"], **results["fused_kernels"],
             **results["mlp_kernels"]}
    serve_out = results["serve"]
    out = []
    for name in KERNEL_META:
        run = LAUNCH_RUN[name]
        if isinstance(run, tuple):             # a phase's main-path run
            r = results[run[1]][WRAPPER[name]]
            e = r["shapes"][LIBRARY_LINE_SHAPE[name]]
            out.append({"name": name, "route": "cuda",
                        "source": KERNEL_META[name][0],
                        "replaces": KERNEL_META[name][1],
                        "launches": e.get("launches", r["launches"]),
                        "max_abs_err": r.get("err_by_dtype", {}).get(
                            e.get("dtype"), r["err"]),
                        "ms": e["ms"], "plain_ms": e["plain_ms"],
                        "bound_ms": e["bound"][0],
                        "bound_by": e["bound"][1],
                        "library_ms": e["library_ms"],
                        "shape": LIBRARY_LINE_SHAPE[name]})
            for key in ("bound_split_p", "bound_split_tf32",
                        "bound_f32_peak"):
                if key in e:
                    out[-1][key + "_ms"] = e[key][0]
            if name in LM_PATH and "lm" in results:
                out[-1]["lm_path"] = LM_PATH[name](results["lm"])
            continue
        launches = serve_out[run]["launches"][WRAPPER[name]]
        entry = {"name": name, "route": "cuda",
                 "source": KERNEL_META[name][0],
                 "replaces": KERNEL_META[name][1], "launches": launches}
        entry["launch_floor_ms"] = results["launch_floor_ms"]
        r = timed[name]
        if not isinstance(r["ms"], dict):      # a pre-gathered kernel
            entry.update(max_abs_err=r["err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                         bound_by=r["bound"][1], library_ms=None)
        else:
            dt = LINE_RESIDENCY
            entry.update(max_abs_err=r["err"], ms=r["ms"][dt],
                         plain_ms=r["plain_ms"][dt],
                         bound_ms=r["bound"][dt][0],
                         bound_by=r["bound"][dt][1], library_ms=None,
                         residency=dt, ms_by_residency=r["ms"])
        out.append(entry)
    return {"kernels": out}


def log_kernels(report, floor_ms) -> None:
    """One line per kernel (per residency for a fused one) of its times,
    beside the launch floor (``launch_floor_ms``)."""
    for name, r in report.items():
        if not isinstance(r["ms"], dict):
            log(f"kernel {name}: {r['ms'] * 1e3:.2f}us (launch floor "
                f"{floor_ms * 1e3:.2f}us, plain "
                f"{r['plain_ms'] * 1e3:.2f}us, bound {r['bound'][0] * 1e3:.4f}"
                f"us by {r['bound'][1]}; one eager call costs the host "
                f"{r['host_us']:.1f}us), max_abs_err {r['err']:.3e}")
            continue
        for dt in RESIDENCIES:
            log(f"kernel {name} {dt}: {r['ms'][dt] * 1e3:.2f}us (launch "
                f"floor {floor_ms * 1e3:.2f}us, plain "
                f"{r['plain_ms'][dt] * 1e3:.2f}us, bound "
                f"{r['bound'][dt][0] * 1e3:.4f}us by {r['bound'][dt][1]})")
        log(f"kernel {name}: one eager int8 call costs the host "
            f"{r['host_us']:.1f}us; max_abs_err {r['err']:.3e}")
        if "adaptive_int8" in r:
            a = r["adaptive_int8"]
            log(f"kernel {name} int8 M=512 with a prefix mask "
                f"({a['live_rows']} live rows): {a['ms'] * 1e3:.2f}us, "
                f"unmasked {a['ms_unmasked'] * 1e3:.2f}us")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON file")
    ap.add_argument("--only", choices=("train", "tune", "lm"), default=None,
                    help="build the kernels and run only this phase (no "
                         "result line): a quicker check of one phase")
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

        if opts.only is not None:
            if opts.only == "train":
                results["train"] = check_training(torch, np, dev)
            elif opts.only == "tune":
                results["tuning"] = check_tuning(
                    torch, np, dev, tune_context(torch, np, dev))
            else:
                results["lm"] = check_lm(torch, np, dev)
            phase = {"train": 11, "tune": 12, "lm": 13}[opts.only]
            log(f"--only {opts.only}: phase {phase} passed; no result "
                f"line ({time.perf_counter() - t_start:.1f}s)")
            if opts.out:
                os.makedirs(os.path.dirname(os.path.abspath(opts.out)),
                            exist_ok=True)
                with open(opts.out, "w") as f:
                    json.dump(results, f, indent=1, default=str)
            return 0
        results["launch_floor_ms"] = launch_floor_ms(torch, dev)
        log(f"launch floor: {results['launch_floor_ms'] * 1e3:.2f}us per "
            f"in-place add on a one-element tensor under graph replay")

        from repro_torch.core import make_family_measure
        measure = make_family_measure("deepfm",
                                      torch.Generator().manual_seed(0), 40,
                                      device=dev)
        results["kernels"] = check_kernels(torch, dev, measure,
                                           measure.meta[1])
        log_kernels(results["kernels"], results["launch_floor_ms"])
        results["fused_kernels"] = check_fused_kernels(torch, dev, measure,
                                                       measure.meta[1])
        log_kernels(results["fused_kernels"], results["launch_floor_ms"])
        check_deepfm_refusals(torch, dev)
        results["mlp_kernels"] = check_mlp_kernels(torch, dev)
        log_kernels(results["mlp_kernels"], results["launch_floor_ms"])
        results["kernel_build"] = check_kernel_build(_lib.BUILD_INFO["path"])
        results["library_kernels"] = check_library_kernels(torch, dev)
        log_library(results["library_kernels"])
        results["engine"] = check_engine(torch, np, dev, "deepfm")
        results["engine_mlp"] = check_engine(torch, np, dev, "mlp")
        results["graph"] = check_graph(torch, np, dev, "deepfm")
        results["graph_mlp"] = check_graph(torch, np, dev, "mlp")
        results["serve"], ctx = check_serve(torch, np, dev)
        profiled = ("unfused float32", "fused float32",
                    "fused int8 adaptive", "mlp fused int8 adaptive")
        results["profile"] = {
            label: profile_serve(torch, np, dev, ctx[label], label)
            for label in profiled}
        results["profile_replayed"] = {
            label: profile_serve(torch, np, dev, ctx[label], label,
                                 capture=True)
            for label in profiled}
        results["continuous"] = {
            label: check_continuous(torch, np, dev, ctx[label], label)
            for label in CONTINUOUS_RUNS}
        results["index"], sharded_idx, results["paged"] = check_index(
            torch, np, dev, ctx, results["serve"])
        results["fault_domain"] = check_fault_domain(torch, np, dev, ctx,
                                                     sharded_idx)
        results["train"] = check_training(torch, np, dev)
        results["tuning"] = check_tuning(torch, np, dev, ctx)
        del ctx
        torch.cuda.empty_cache()
        results["lm"] = check_lm(torch, np, dev)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        print(f"[smoke] FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    results["seconds"] = time.perf_counter() - t_start
    log(f"all phases passed in {results['seconds']:.1f}s")

    line = kernel_line(results)
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
