#!/usr/bin/env python3
"""Card smoke test of the PyTorch/CUDA port (``src/repro_torch``): builds
the ten CUDA kernels from this checkout, holds each against its plain
PyTorch version on the card (the index-fused ones at float32, bfloat16 and
int8 residency, and bit for bit against the pre-gathered ones at float32;
the MLP ones at several depths), runs the engine with the DeepFM and the
MLP measure on the card against the same engine on the CPU, serves the
GUITAR search at N=100,000 through the port's oneshot serving path (DeepFM
unfused, fused at float32, bfloat16 and int8, and int8 with adaptive angle
sizing; the MLP measure unfused, fused int8 and fused int8 adaptive),
counting kernel launches in each run, and profiles one served batch of four
of those runs (device busy share, device events per engine step, device
time by kernel).

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
            err, ratio, n_diff = rank_close(torch, key, mask, pk, pm, alpha,
                                            rank_by, "neighbor_rank")
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
                                     deepfm_score_fused,
                                     deepfm_value_and_grad, neighbor_rank,
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
    r = report["deepfm_score_fused"] = {"err": worst, "ms": {},
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

    # -- deepfm_grad_fused: main path Q = 32, a ragged Q, 256
    worst = 0.0
    for dt, store in stores.items():
        worst_dt = 0.0
        for M in (32, 7, 256):
            for shared in (False, True):
                idx = ids_of(M)
                q = rows(D) if shared else rows(M, D)
                v, g, x = deepfm_grad_fused(store, idx, q, mlp, fm_dim)
                torch.cuda.synchronize()
                pv, pg, px = deepfm_grad_fused_ref(store, idx, q, *wb, fm_dim)
                label = f"deepfm_grad_fused {dt} M={M} shared={shared}"
                require(torch.equal(x, px), f"{label}: x differs from "
                        f"CorpusStore.take")
                ev, rv = close_err(v, pv, SCORE_RTOL, SCORE_ATOL)
                eg, rg = close_err(g, pg, GRAD_RTOL, GRAD_ATOL)
                require(rv <= 1.0 and rg <= 1.0,
                        f"{label}: vals {ev:.3e} grads {eg:.3e}")
                worst_dt = max(worst_dt, ev, eg)
                if dt == "float32":
                    uv, ug = deepfm_value_and_grad(px, q, mlp, fm_dim)
                    require(torch.equal(v, uv) and torch.equal(g, ug),
                            f"{label}: differs from deepfm_grad on the "
                            f"gathered rows")
        log(f"deepfm_grad_fused {dt}: 6 cases, max_abs_err {worst_dt:.3e}, "
            f"x equal to CorpusStore.take"
            + (", equal to deepfm_grad bit for bit" if dt == "float32"
               else ""))
        worst = max(worst, worst_dt)
    M = 32
    idx, q = ids_of(M), rows(M, D)
    r = report["deepfm_grad_fused"] = {"err": worst, "ms": {},
                                       "plain_ms": {}, "bound": {}}
    for dt, st in stores.items():
        r["ms"][dt] = time_ms(lambda: deepfm_grad_fused(st, idx, q, mlp,
                                                        fm_dim))
        r["plain_ms"][dt] = time_ms(lambda: deepfm_grad_fused_ref(
            st, idx, q, *wb, fm_dim))
        r["bound"][dt] = bound_ms(*fused_deepfm_costs(dt, M, D, fm_dim, H0,
                                                      H1, True, True))
    r["host_us"] = host_us(lambda: deepfm_grad_fused(st8, idx, q, mlp,
                                                     fm_dim))

    # -- neighbor_rank_fused: main path (Q, B) = (32, 48), a ragged shape,
    #    both rank modes; frontier rows and gradients as the engine has them
    alpha = 1.01
    worst = 0.0
    for dt, store in stores.items():
        worst_dt = 0.0
        for Q, B in ((32, 48), (5, 37)):
            x = store.take(ids_of(Q).clamp_min(0))
            g = deepfm_value_and_grad_ref(x, rows(Q, D), *wb,
                                          fm_dim)[1].contiguous()
            idx = ids_of(Q, B)
            valid = (torch.rand((Q, B), generator=gen) < 0.7).to(dev) \
                & (idx >= 0)
            valid[0] = False                    # an all-invalid lane
            for rank_by in ("angle", "projection"):
                key, mask = neighbor_rank_fused(x, g, store, idx, valid,
                                                alpha, rank_by)
                torch.cuda.synchronize()
                pk, pm = neighbor_rank_fused_ref(x, g, store, idx, valid,
                                                 alpha, rank_by)
                label = f"neighbor_rank_fused {dt} Q={Q} B={B} {rank_by}"
                err, ratio, n_diff = rank_close(torch, key, mask, pk, pm,
                                                alpha, rank_by, label)
                require(ratio <= 1.0 and n_diff == 0,
                        f"{label}: key {err:.3e}, {n_diff} mask mismatches")
                worst_dt = max(worst_dt, err)
                if dt == "float32":
                    uk, um = neighbor_rank(x, g, store.take(idx.clamp_min(0)),
                                           valid, alpha, rank_by)
                    require(torch.equal(key, uk) and torch.equal(mask, um),
                            f"{label}: differs from neighbor_rank on the "
                            f"gathered rows")
        log(f"neighbor_rank_fused {dt}: 4 cases, key max_abs_err "
            f"{worst_dt:.3e}, no mask mismatch away from the band edge"
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
# layers below the top one, and a net with no hidden layer.
MLP_NETS = (
    ("80-64-64-1", 40, 40, (64, 64)),
    ("80-32-1", 40, 40, (32,)),
    ("80-128-128-1", 40, 40, (128, 128)),
    ("64-64-64-1 (Dq=24)", 40, 24, (64, 64)),
    ("64-48-32-24-1 (Dq=24)", 40, 24, (48, 32, 24)),
    ("80-1", 40, 40, ()),
)


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


def check_mlp_kernels(torch, dev):
    """The four MLP kernels against their plain versions at every net of
    MLP_NETS: mlp_score at M = 256, 512, 77, 1 and mlp_grad at Q = 32, 7,
    both query forms; the fused pair at each residency (with and without a
    prefix mask, -1 ids), ``x`` of the grad form equal to
    ``CorpusStore.take``, and at float32 bit for bit against the
    pre-gathered pair on the gathered rows. Times each at the serving
    net and shape."""
    from repro_torch.core import make_corpus_store
    from repro_torch.kernels import (mlp_grad_fused, mlp_score,
                                     mlp_score_fused, mlp_value_and_grad)
    from repro_torch.kernels.mlp_grad.ref import mlp_value_and_grad_ref
    from repro_torch.kernels.mlp_grad_fused.ref import mlp_grad_fused_ref
    from repro_torch.kernels.mlp_score.ops import mlp_dims
    from repro_torch.kernels.mlp_score.ref import mlp_score_ref
    from repro_torch.kernels.mlp_score_fused.ref import mlp_score_fused_ref

    N = 5000
    gen = torch.Generator(device="cpu").manual_seed(456)
    neg_inf = float("-inf")

    def rows(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def ids_of(*shape):
        i = torch.randint(0, N, shape, generator=gen)
        i.view(-1)[::13] = -1                 # padding, clamped in-kernel
        return i.to(dev)

    def expand(q, M):
        return q.expand(M, -1) if q.dim() == 1 else q

    worst = {k: 0.0 for k in ("mlp_score", "mlp_grad", "mlp_score_fused",
                              "mlp_grad_fused")}
    serving = None
    for label, Dx, Dq, hidden in MLP_NETS:
        net = random_mlp(torch, dev, Dx + Dq, hidden, gen)
        w, b = net["w"], net["b"]
        base = torch.randn((N, Dx), generator=gen)
        stores = {dt: make_corpus_store(base, dt, device=dev)
                  for dt in RESIDENCIES}
        if serving is None:
            serving = (net, Dx, Dq, stores)
        n_cases = 0
        # -- mlp_score: M = Q*C = 256 (C = 8), 512 (adaptive c_max = 16),
        #    a ragged M, one row
        for M in (256, 512, 77, 1):
            for shared in (False, True):
                c, q = rows(M, Dx), (rows(Dq) if shared else rows(M, Dq))
                got = mlp_score(c, q, net)
                torch.cuda.synchronize()
                err, ratio = close_err(got, mlp_score_ref(c, expand(q, M), w,
                                                          b),
                                       SCORE_RTOL, SCORE_ATOL)
                require(ratio <= 1.0, f"mlp_score {label} M={M} shared="
                        f"{shared}: {err:.3e}")
                worst["mlp_score"] = max(worst["mlp_score"], err)
                n_cases += 1
        # -- mlp_grad: Q = 32 frontier rows, a ragged Q
        for M in (32, 7):
            for shared in (False, True):
                c, q = rows(M, Dx), (rows(Dq) if shared else rows(M, Dq))
                v, g = mlp_value_and_grad(c, q, net)
                torch.cuda.synchronize()
                pv, pg = mlp_value_and_grad_ref(c, expand(q, M), w, b)
                ev, rv = close_err(v, pv, SCORE_RTOL, SCORE_ATOL)
                eg, rg = close_err(g, pg, GRAD_RTOL, GRAD_ATOL)
                require(rv <= 1.0 and rg <= 1.0, f"mlp_grad {label} M={M} "
                        f"shared={shared}: vals {ev:.3e} grads {eg:.3e}")
                worst["mlp_grad"] = max(worst["mlp_grad"], ev, eg)
                n_cases += 1
        for dt, store in stores.items():
            # -- mlp_score_fused: the same shapes, masked and not
            for M, C in ((256, 8), (512, 16), (77, None), (1, None)):
                for shared in (False, True):
                    for masked in (False, True):
                        idx = ids_of(M)
                        q = rows(Dq) if shared else rows(M, Dq)
                        mask = None
                        if masked:
                            mask = (prefix_mask(torch, M // C, C, gen) if C
                                    else torch.rand(M, generator=gen) < 0.5)
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
                            worst["mlp_score_fused"] = max(
                                worst["mlp_score_fused"], err)
                        if dt == "float32":
                            unf = mlp_score(store.take(idx.clamp_min(0)), q,
                                            net)
                            if mask is not None:
                                unf = unf.masked_fill(~mask, neg_inf)
                            require(torch.equal(got, unf), f"{tag}: differs "
                                    f"from mlp_score on the gathered rows")
                        n_cases += 1
            # -- mlp_grad_fused: Q = 32, a ragged Q
            for M in (32, 7):
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
                    worst["mlp_grad_fused"] = max(worst["mlp_grad_fused"],
                                                  ev, eg)
                    if dt == "float32":
                        uv, ug = mlp_value_and_grad(px, q, net)
                        require(torch.equal(v, uv) and torch.equal(g, ug),
                                f"{tag}: differs from mlp_grad on the "
                                f"gathered rows")
                    n_cases += 1
        log(f"mlp kernels {label}: {n_cases} cases match their plain "
            f"versions; the fused pair equals the pre-gathered pair bit for "
            f"bit at float32, x equal to CorpusStore.take")
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
        err=worst["mlp_score"], ms=time_ms(lambda: mlp_score(c, q, net)),
        plain_ms=time_ms(lambda: mlp_score_ref(c, q, w, b)),
        host_us=host_us(lambda: mlp_score(c, q, net)),
        bound=bound_ms(*mlp_costs(256, Dx, Dq, dims, True, False)))
    cg, qg = rows(32, Dx), rows(32, Dq)
    report["mlp_grad"] = dict(
        err=worst["mlp_grad"],
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


def check_serve(torch, np, dev, items=100_000):
    """One graph at N=100,000, served through the launcher's oneshot path
    per SERVE_RUNS with the DeepFM and the MLP measure; each run must
    launch every kernel of its path and no other, each result must score
    its ids as the plain measure scores their resident rows, and recall is
    labelled on the float32 base."""
    from repro_torch.core import (SearchConfig, brute_force_topk,
                                  make_corpus_store, make_family_measure,
                                  recall, search_measure)
    from repro_torch.graph import build_l2_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    # the DeepFM model's width (D = 40, hidden 64x64) and corpus size
    # (DeepFMConfig.n_items), the paper's graph (M = 24, k_construction =
    # 100) and search settings; 10 batches of 32 queries
    common = ["--items", str(items), "--dim", "40", "--queries", "320",
              "--batch", "32", "--ef", "64", "--budget", "8", "--alpha",
              "1.01", "--k", "10", "--device", str(dev)]
    args = serve.parse_args(common)
    rng = np.random.default_rng(0)
    base = rng.normal(size=(args.items, args.dim)).astype(np.float32)
    query_stream = rng.bit_generator.state
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
                      "corpus_mib": store.nbytes() / 2**20}
        ctx[label] = (measure, store, nbrs, graph, cfg, options)
    return out, ctx


def profile_serve(torch, np, dev, ctx, label):
    """torch.profiler over one served batch of 32 at N=100,000: the share
    of the batch's wall time in which the card runs a kernel, and device
    time by kernel. It reports and checks nothing."""
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

    search_measure(measure, store, nbrs, q, entries, cfg, options)
    torch.cuda.synchronize()
    launches0 = steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search_measure(measure, store, nbrs, q, entries, cfg, options)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n_steps = steps() - launches0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        log(f"profile {label}: the profiler recorded no device events")
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
    log(f"profile {label}: one batch of 32 at N={store.n}: wall "
        f"{wall_us:.0f}us, device busy {busy:.0f}us ({busy / wall_us:.1%}), "
        f"idle {1 - busy / wall_us:.1%}; {len(kern)} device events over "
        f"{n_steps} engine steps ({len(kern) / max(n_steps, 1):.1f} per "
        f"step)")
    for name, (n, t) in top:
        log(f"profile {label}:   {t:9.1f}us {n:6d}x  {name[:90]}")
    return {"wall_us": wall_us, "busy_us": busy, "device_events": len(kern),
            "idle_share": 1 - busy / wall_us, "steps": n_steps,
            "top": [(name, n, t) for name, (n, t) in top]}


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
WRAPPER = {"deepfm_score": "deepfm_score", "neighbor_rank": "neighbor_rank",
           "deepfm_grad": "deepfm_value_and_grad",
           "deepfm_score_fused": "deepfm_score_fused",
           "neighbor_rank_fused": "neighbor_rank_fused",
           "deepfm_grad_fused": "deepfm_grad_fused",
           "mlp_score": "mlp_score", "mlp_score_fused": "mlp_score_fused",
           "mlp_grad": "mlp_value_and_grad",
           "mlp_grad_fused": "mlp_grad_fused"}
# the serve run whose launches each kernel reports
LAUNCH_RUN = {"deepfm_score": "unfused float32",
              "neighbor_rank": "unfused float32",
              "deepfm_grad": "unfused float32",
              "deepfm_score_fused": "fused int8 adaptive",
              "neighbor_rank_fused": "fused int8 adaptive",
              "deepfm_grad_fused": "fused int8 adaptive",
              "mlp_score": "mlp unfused float32",
              "mlp_grad": "mlp unfused float32",
              "mlp_score_fused": "mlp fused int8 adaptive",
              "mlp_grad_fused": "mlp fused int8 adaptive"}
LINE_RESIDENCY = "int8"   # the fused kernels' numbers in the kernels line


def kernel_line(results) -> dict:
    timed = {**results["kernels"], **results["fused_kernels"],
             **results["mlp_kernels"]}
    serve_out = results["serve"]
    out = []
    for name in KERNEL_META:
        launches = serve_out[LAUNCH_RUN[name]]["launches"][WRAPPER[name]]
        entry = {"name": name, "route": "cuda",
                 "source": KERNEL_META[name][0],
                 "replaces": KERNEL_META[name][1], "launches": launches}
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


def log_kernels(report) -> None:
    """One line per kernel (per residency for a fused one) of its times."""
    for name, r in report.items():
        if not isinstance(r["ms"], dict):
            log(f"kernel {name}: {r['ms'] * 1e3:.2f}us (plain "
                f"{r['plain_ms'] * 1e3:.2f}us, bound {r['bound'][0] * 1e3:.4f}"
                f"us by {r['bound'][1]}; one eager call costs the host "
                f"{r['host_us']:.1f}us), max_abs_err {r['err']:.3e}")
            continue
        for dt in RESIDENCIES:
            log(f"kernel {name} {dt}: {r['ms'][dt] * 1e3:.2f}us (plain "
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
        results["kernels"] = check_kernels(torch, dev, measure,
                                           measure.meta[1])
        log_kernels(results["kernels"])
        results["fused_kernels"] = check_fused_kernels(torch, dev, measure,
                                                       measure.meta[1])
        log_kernels(results["fused_kernels"])
        results["mlp_kernels"] = check_mlp_kernels(torch, dev)
        log_kernels(results["mlp_kernels"])
        results["engine"] = check_engine(torch, np, dev, "deepfm")
        results["engine_mlp"] = check_engine(torch, np, dev, "mlp")
        results["serve"], ctx = check_serve(torch, np, dev)
        results["profile"] = {
            label: profile_serve(torch, np, dev, ctx[label], label)
            for label in ("unfused float32", "fused float32",
                          "fused int8 adaptive", "mlp fused int8 adaptive")}
    except SmokeFailure as e:
        log(f"FAIL: {e}")
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
