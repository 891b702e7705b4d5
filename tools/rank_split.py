#!/usr/bin/env python3
"""Where the rank pair's time goes: device µs per call of cut-down copies
of ``neighbor_rank`` and ``neighbor_rank_fused``, timed in turns in one
process at the serving shape (Q = 32 lanes, B = 48 neighbors, D = 40,
both kernels in angle mode), each under CUDA-graph replay as
``chip_smoke.time_ms`` times the kernels.

Phases, each a copy that stops after it: ``launch`` (nothing done),
``loads`` (+ the ids and the rows: the fused form's ids, then every row
value of the lane), ``dot`` (+ <d, g>, |d|^2 and |g|^2 summed over the
threads of a row), ``keys`` (+ acos or the projection, the keys
written), ``all`` (+ theta and the mask: the kernel), and ``whole``, the
sources' own C entry (``neighbor_rank_f32``, ``neighbor_rank_fused``),
whatever body it launches; and ``floor``, an in-place add on a
one-element tensor. Each form is split pre-gathered (``gathered``) and
index-fused over an int8-resident corpus (``fused_int8``); ``whole`` also
at float32 and bfloat16 residency.

Two bodies are split: ``warp``, the one-warp-per-row layout (one block of
256 threads per lane, one warp per neighbor row, so 6 rows in series per
warp at B = 48, each a chain of loads and two 5-level shuffle trees, then
theta by warp 0; a copy of it is kept here, compiled against each
source directory's row sources), and ``rows``, the body of
``csrc/neighbor_rank.cuh`` that has a lane's rows in flight at once,
where the sources have it (its ``RankStop`` phases).

``--sweep`` also times the ``rows`` body compiled for D = 40 at every
point of ``SWEEP`` (threads per row G x lanes per CTA), and its run-time
-width copy at the call's own plan (``runtime``), each held against the
plain version first, pre-gathered and fused int8, with each point's plan
and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.

Splits this checkout's kernels, or each kernel source directory given
with ``--csrc`` (another commit's ``src/repro_torch/kernels/csrc``
unpacked with ``git archive`` into a directory that ``.gitignore`` lists),
all timed in turns in one process (each copy is its own library with
plain C entry points). Prints one JSON line: per variant the median over
the rounds and each round's time, each copy's largest key error against
the plain version and its ptxas lines.

    python3 tools/rank_split.py [--sweep] [--rounds 5] [--csrc DIR ...]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

Q, B, D = 32, 48, 40
N = 5000                  # corpus rows of the fused form
ALPHA = 1.01
STOPS = ("launch", "loads", "dot", "keys", "all")
# (threads per row, lanes per CTA) of the sweep, at D = 40
SWEEP = ((4, 1), (4, 2), (4, 4), (8, 1), (8, 2), (8, 4))

# every copy: the sources' two entries (and through them their row
# sources), and the one-warp-per-row layout's cut-down copies
HEAD_CU = r"""
#include "neighbor_rank.cu"
#include "neighbor_rank_fused.cu"
using namespace repro;

// The one-warp-per-row layout: one block of 256 threads per lane, one
// warp per neighbor row (lanes across D), |g| by every warp, keys to
// shared memory, theta by warp 0 after a barrier, the mask after another;
// stopped after phase Stop (0 launch, 1 loads, 2 dot, 3 keys, 4 all).
template <class Rows, int Stop>
__global__ void __launch_bounds__(256)
warp_rank_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 Rows nv, const unsigned char* __restrict__ valid,
                 float* __restrict__ key, unsigned char* __restrict__ mask,
                 int B, int D, float alpha, int by_angle) {
  if (Stop == 0) return;
  extern __shared__ float rank_key[];
  __shared__ float theta_s;
  const float eps = 1e-12f;
  const int qrow = blockIdx.x;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  const float* xr = x + static_cast<size_t>(qrow) * D;
  const float* gr = g + static_cast<size_t>(qrow) * D;
  float gp = 0.f;
  for (int d = lane; d < D; d += kWarp) gp = fmaf(gr[d], gr[d], gp);
  const float gnorm = Stop >= 2 ? sqrtf(warp_sum(gp)) + eps : gp;
  for (int b = warp; b < B; b += nwarps) {
    const size_t qb = static_cast<size_t>(qrow) * B + b;
    const typename Rows::Row nb = nv.row(qb, D);
    float dp = 0.f, nn = 0.f;
    for (int d = lane; d < D; d += kWarp) {
      const float df = nv.get(nb, d) - xr[d];
      dp = fmaf(df, gr[d], dp);
      nn = fmaf(df, df, nn);
    }
    if (Stop == 1) {
      if (dp + nn == 1234.5f) key[qb] = gnorm;
      continue;
    }
    dp = warp_sum(dp);
    nn = warp_sum(nn);
    if (Stop == 2) {
      if (lane == 0 && dp + nn == 1234.5f) key[qb] = gnorm;
      continue;
    }
    const bool v = valid[qb] != 0;
    float k;
    if (by_angle) {
      const float dnorm = sqrtf(nn) + eps;
      const float c = fminf(fmaxf(dp / (dnorm * gnorm), -1.f), 1.f);
      k = v ? acosf(c) : INFINITY;
      if (lane == 0) rank_key[b] = k;
    } else {
      const float proj = dp / gnorm;
      k = v ? -proj : INFINITY;
      if (lane == 0) rank_key[b] = v ? proj : -INFINITY;
    }
    if (lane == 0) key[qb] = k;
  }
  if (Stop < 4) return;
  __syncthreads();
  if (warp == 0) {
    float t = by_angle ? INFINITY : -INFINITY;
    for (int b = lane; b < B; b += kWarp)
      t = by_angle ? fminf(t, rank_key[b]) : fmaxf(t, rank_key[b]);
    t = by_angle ? warp_min(t) : warp_max(t);
    if (lane == 0) theta_s = t;
  }
  __syncthreads();
  const float theta = theta_s;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const size_t qb = static_cast<size_t>(qrow) * B + b;
    const bool v = valid[qb] != 0;
    bool in;
    if (by_angle) {
      in = v && (rank_key[b] <= alpha * theta + eps);
    } else {
      const float bound = theta >= 0.f ? theta / alpha : theta * alpha;
      in = v && (rank_key[b] >= bound - eps);
    }
    mask[qb] = in ? 1 : 0;
  }
}

template <int Stop, class Rows>
static cudaError_t warp_launch(const float* x, const float* g, Rows nv,
                               const void* valid, void* key, void* mask,
                               int Q, int B, int D, float alpha, int by_angle,
                               cudaStream_t s) {
  warp_rank_kernel<Rows, Stop><<<Q, 256, sizeof(float) * B, s>>>(
      x, g, nv, static_cast<const unsigned char*>(valid),
      static_cast<float*>(key), static_cast<unsigned char*>(mask), B, D,
      alpha, by_angle);
  return cudaGetLastError();
}

// fn(rows) with the row source of a form: pre-gathered (residency -1) or
// the corpus at a residency
template <class Fn>
static cudaError_t with_rows(int residency, const void* nv, const void* data,
                             const void* scales, const void* ids, Fn fn) {
  if (residency < 0) return fn(GatheredRows{static_cast<const float*>(nv)});
  cudaError_t err = cudaSuccess;
  const cudaError_t bad = with_corpus_rows(
      residency, data, scales, ids, [&](auto rows) { err = fn(rows); });
  return bad != cudaSuccess ? bad : err;
}

#define SPLIT_ARGS                                                        \
  int stop, int residency, const void *x, const void *g, const void *nv, \
      const void *data, const void *scales, const void *ids,             \
      const void *valid, void *key, void *mask, int Q, int B, int D,     \
      float alpha, int by_angle, void *stream

extern "C" int warp_split(SPLIT_ARGS) {
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_rows(
      residency, nv, data, scales, ids, [&](auto rows) {
        switch (stop) {
          case 0: return warp_launch<0>(xf, gf, rows, valid, key, mask, Q, B,
                                        D, alpha, by_angle, s);
          case 1: return warp_launch<1>(xf, gf, rows, valid, key, mask, Q, B,
                                        D, alpha, by_angle, s);
          case 2: return warp_launch<2>(xf, gf, rows, valid, key, mask, Q, B,
                                        D, alpha, by_angle, s);
          case 3: return warp_launch<3>(xf, gf, rows, valid, key, mask, Q, B,
                                        D, alpha, by_angle, s);
          default: return warp_launch<4>(xf, gf, rows, valid, key, mask, Q,
                                         B, D, alpha, by_angle, s);
        }
      }));
}

// the sources' own entries (stop ignored)
extern "C" int whole_split(SPLIT_ARGS) {
  if (residency < 0)
    return neighbor_rank_f32(x, g, nv, valid, key, mask, Q, B, D, alpha,
                             by_angle, stream);
  return neighbor_rank_fused(x, g, data, scales, ids, residency, valid, key,
                             mask, Q, B, D, alpha, by_angle, stream);
}
"""

# the rows body's phases and the sweep (sources with RankStop)
ROWS_CU = r"""
extern "C" int rows_split(SPLIT_ARGS) {
  return static_cast<int>(with_rows(
      residency, nv, data, scales, ids, [&](auto rows) {
        switch (stop) {
          case 0: return launch_neighbor_rank<decltype(rows), kRankLaunch>(
              x, g, rows, valid, key, mask, Q, B, D, alpha, by_angle, stream);
          case 1: return launch_neighbor_rank<decltype(rows), kRankLoads>(
              x, g, rows, valid, key, mask, Q, B, D, alpha, by_angle, stream);
          case 2: return launch_neighbor_rank<decltype(rows), kRankDot>(
              x, g, rows, valid, key, mask, Q, B, D, alpha, by_angle, stream);
          case 3: return launch_neighbor_rank<decltype(rows), kRankKeys>(
              x, g, rows, valid, key, mask, Q, B, D, alpha, by_angle, stream);
          default: return launch_neighbor_rank<decltype(rows), kRankAll>(
              x, g, rows, valid, key, mask, Q, B, D, alpha, by_angle, stream);
        }
      }));
}

template <int G, int L>
static int sweep_at(int residency, const void* x, const void* g,
                    const void* nv, const void* data, const void* scales,
                    const void* ids, const void* valid, void* key,
                    void* mask, int Q, int B, int D, float alpha,
                    int by_angle, void* stream, int* info) {
  using W = RankFixed<40, G, L>;
  const RankPlan p = rank_plan_at(B, 40, G, L);
  if (D != 40) return static_cast<int>(cudaErrorInvalidValue);
  if (info) {
    const int fields[6] = {p.G, p.lanes, p.rows, p.pitch, p.threads, p.smem};
    for (int i = 0; i < 6; ++i) info[i] = fields[i];
    return static_cast<int>(
        rank_blocks_per_sm<GatheredRows, W>(p, info + 6));
  }
  return static_cast<int>(with_rows(
      residency, nv, data, scales, ids, [&](auto rows) {
        return launch_neighbor_rank_as<decltype(rows), W>(
            x, g, rows, valid, key, mask, Q, B, D, alpha, by_angle, p,
            stream);
      }));
}

// the run-time-width copy at the call's own plan (what compiling the
// serving width in buys)
extern "C" int rows_runtime(SPLIT_ARGS) {
  return static_cast<int>(with_rows(
      residency, nv, data, scales, ids, [&](auto rows) {
        return launch_neighbor_rank_as<decltype(rows), RankRuntime>(
            x, g, rows, valid, key, mask, Q, B, D, alpha, by_angle,
            neighbor_rank_plan(B, D), stream);
      }));
}

extern "C" int rows_sweep(int point, int residency, const void* x,
                          const void* g, const void* nv, const void* data,
                          const void* scales, const void* ids,
                          const void* valid, void* key, void* mask, int Q,
                          int B, int D, float alpha, int by_angle,
                          void* stream, int* info) {
#define SWEEP_AT(G, L)                                                  \
  sweep_at<G, L>(residency, x, g, nv, data, scales, ids, valid, key,    \
                 mask, Q, B, D, alpha, by_angle, stream, info)
  switch (point) {
SWEEP_CASES
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWEEP_AT
}
""".replace("SWEEP_CASES", "\n".join(
    f"    case {i}: return SWEEP_AT({G}, {L});"
    for i, (G, L) in enumerate(SWEEP)))


def build(csrc, out_dir):
    """Compile the copies against the kernel sources in ``csrc`` into one
    library with the port's nvcc flags; returns (library, whether the
    sources have the rows body, nvcc's output)."""
    from repro_torch.kernels import _lib
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, "neighbor_rank.cuh")) as f:
        has_rows = "kRankDot" in f.read()
    src = os.path.join(out_dir, "rank_split.cu")
    with open(src, "w") as f:
        f.write(HEAD_CU + (ROWS_CU if has_rows else ""))
    so = os.path.join(out_dir, "librank_split.so")
    out = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", csrc,
                          "-shared", "-o", so, src],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}\n{out.stderr}")
    lib = ctypes.CDLL(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    args = [I, I, P, P, P, P, P, P, P, P, P, I, I, I, F, I, P]
    for name in ("warp_split", "whole_split") + (
            ("rows_split", "rows_runtime") if has_rows else ()):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = I
    if has_rows:
        lib.rows_sweep.argtypes = [I] + args[1:] + [P]
        lib.rows_sweep.restype = I
    return lib, has_rows, out.stdout + out.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also time the rows body at every point of SWEEP")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--csrc", nargs="*", default=None,
                    help="kernel source directories to split, each timed "
                         "in turns with the others (default: this "
                         "checkout's)")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rank_split: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core import make_corpus_store
    from repro_torch.kernels import _lib
    from repro_torch.kernels.neighbor_rank.ref import neighbor_rank_ref
    from repro_torch.kernels.neighbor_rank_fused.ref import \
        neighbor_rank_fused_ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(654)

    def rows(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    x, g = rows(Q, D), rows(Q, D)
    nv = x[:, None, :] + 0.5 * rows(Q, B, D)
    valid = (torch.rand((Q, B), generator=gen) < 0.7).to(dev)
    stores = {dt: make_corpus_store(torch.randn((N, D), generator=gen), dt,
                                    device=dev)
              for dt in chip_smoke.RESIDENCIES}
    ids = torch.randint(0, N, (Q, B), generator=gen).to(dev)
    want = {"gathered": neighbor_rank_ref(x, g, nv, valid, ALPHA)}
    forms = {"gathered": (-1, None)}
    for dt, st in stores.items():
        want[f"fused_{dt}"] = neighbor_rank_fused_ref(x, g, st, ids, valid,
                                                      ALPHA)
        forms[f"fused_{dt}"] = (_lib.RESIDENCY[dt], st)
    key = torch.empty((Q, B), device=dev)
    mask = torch.empty((Q, B), dtype=torch.bool, device=dev)

    def call(fn, stop, form, point=None):
        residency, st = forms[form]
        data, scales, _ = (None, None, None) if st is None else \
            _lib.corpus_args(st)
        head = (stop,) if point is None else (point,)
        tail = () if point is None else (None,)

        def run():       # on the current stream: time_ms captures a graph
            rc = fn(*head, residency, x.data_ptr(), g.data_ptr(),
                    nv.data_ptr(), data, scales, ids.data_ptr(),
                    valid.data_ptr(), key.data_ptr(), mask.data_ptr(), Q, B,
                    D, ALPHA, 1, _lib.stream_of(dev), *tail)
            _lib.check(rc, f"{form} stop {stop} point {point}")
        return run

    def check(fn, tag, form):
        """Run ``fn`` once and hold its keys and mask against the plain
        version; returns the largest key error."""
        fn()
        torch.cuda.synchronize()
        pk, pm = want[form]
        err, ratio, n_diff = chip_smoke.rank_close(
            torch, key, mask, pk, pm, ALPHA, "angle", tag)
        if ratio > 1.0 or n_diff:
            raise RuntimeError(f"{tag}: key {err:.3e}, {n_diff} mask "
                               f"mismatches")
        return err

    out = {"device": chip_smoke.nvidia_smi_line(), "unit": "us",
           "shape": f"Q={Q} B={B} D={D} angle", "err": {}, "ptxas": {}}
    calls = {}
    for i, csrc in enumerate(opts.csrc or [str(_lib.CSRC)]):
        label = os.path.basename(os.path.normpath(csrc)) + (
            f"#{i}" if opts.csrc else "")
        lib, has_rows, log = build(
            csrc, os.path.join(ROOT, "build", "rank_split", str(i)))
        out["ptxas"][label] = [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        bodies = {"warp": lib.warp_split}
        if has_rows:
            bodies["rows"] = lib.rows_split
        for form in ("gathered", "fused_int8"):
            for body, fn in bodies.items():
                for stop, name in enumerate(STOPS):
                    calls[f"{label}:{body}_{name}:{form}"] = call(fn, stop,
                                                                  form)
                tag = f"{label}:{body}_all:{form}"
                out["err"][tag] = check(calls[tag], tag, form)
        for form in forms:
            tag = f"{label}:whole:{form}"
            calls[tag] = call(lib.whole_split, 0, form)
            out["err"][tag] = check(calls[tag], tag, form)
        if has_rows and opts.sweep:
            for form in ("gathered", "fused_int8"):
                tag = f"{label}:runtime:{form}"
                calls[tag] = call(lib.rows_runtime, 0, form)
                out["err"][tag] = check(calls[tag], tag, form)
            for point, (G, L) in enumerate(SWEEP):
                info = (ctypes.c_int * 7)()
                _lib.check(lib.rows_sweep(point, -1, *([None] * 9), Q, B, D,
                                          ALPHA, 1, None, info), "plan")
                tag = f"{label}:sweep_g{G}_l{L}"
                out.setdefault("sweep", {})[tag] = dict(zip(
                    ("threads_per_row", "lanes", "rows", "pitch", "threads",
                     "smem_bytes", "blocks_per_sm"), info))
                for form in ("gathered", "fused_int8"):
                    fn = call(lib.rows_sweep, None, form, point)
                    out["err"][f"{tag}:{form}"] = check(fn, tag, form)
                    calls[f"{tag}:{form}"] = fn
    one = torch.zeros(1, device=dev)
    calls["floor"] = lambda: one.add_(1.0)
    times = {k: [] for k in calls}
    for _ in range(opts.rounds):
        for k, fn in calls.items():
            times[k].append(chip_smoke.time_ms(fn) * 1e3)
    out["median_us"] = {k: statistics.median(v) for k, v in times.items()}
    out["rounds_us"] = times
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
