#!/usr/bin/env python3
"""Where an MLP or DeepFM kernel's time goes: device µs per call of
cut-down copies of it, timed in turns in one process at the serving shape
(``--kernel grad``: Q = 32 frontier rows; ``--kernel score``: M = Q * C =
256 candidate rows; per-row queries; ``--measure mlp``: Dx = Dq = 40, MLP
80 -> 64 -> 64 -> 1; ``--measure deepfm``: D = 40, fm = 8, deep input
64 -> 64 -> 64 -> 1), each under CUDA-graph replay as
``chip_smoke.time_ms`` times the kernels.

Variants of the one-warp-per-row layout, compiled only from sources that
still have it (for the MLP, ``mlp_stage`` and ``mlp_forward_warp`` of
``mlp.cuh``; for DeepFM, ``deepfm_stage`` and ``deepfm_forward_warp`` of
``deepfm.cuh``, the score body before it moved onto the cluster body), at
its grid of M / 8 blocks of 256 threads and its shared memory:

- ``warp_empty``: the launch alone, nothing done;
- ``warp_stage``: the whole network staged into shared memory;
- ``warp_forward``: staging and the forward pass (the score) of every row;

where the sources run the kernel on the cluster body of ``mlp_grad.cuh``,
its ``Stop`` phases at its own cluster launch: ``cluster_empty``,
``cluster_stage``, ``cluster_forward`` (through the value); then
``kernel``: the sources' own entry (``mlp_grad_f32``, ``mlp_score_f32``,
``deepfm_grad_f32``, ``deepfm_score_f32``), whatever body it launches; and
``floor``, an in-place add on a one-element tensor. The grad splits the
warp layout only where the sources have no cluster body; the score splits
both where it finds them.

``--sweep`` (score, cluster body) also times the score's tile at every
point of ``SWEEP`` (rows × CTAs per cluster, the measure's serving widths
compiled in), each held against the plain version first: at M = 256
pre-gathered, and at the adaptive M = 512 over int8 corpus rows with and
without a prefix mask (c_max = 16), with each point's shared memory per
CTA and ``cudaOccupancyMaxActiveClusters``.

Splits this checkout's kernel, or each kernel source directory given with
``--csrc`` (another commit's ``src/repro_torch/kernels/csrc`` unpacked
with ``git archive`` into a directory that ``.gitignore`` lists, or an
edited copy), all timed in turns in one process (each copy is its own
library with plain C entry points). Prints one JSON line: per variant the
median over the rounds and each round's time, each copy's largest error
against the plain version, its ptxas lines and its SASS opcode counts,
and for a copy instrumented with clock64 stamps (one that defines
``extern "C" int mlp_grad_stamps(unsigned long long*)``, up to 128
counters) the stamps of one run (MLP only). The parents' splits in PERF.md are this
tool on the parent's sources (``--csrc
build/parent/src/repro_torch/kernels/csrc``).

    python3 tools/mlp_grad_split.py [--measure mlp|deepfm]
                                    [--kernel grad|score] [--sweep]
                                    [--rounds 5] [--csrc DIR ...]
                                    [--sass-dir DIR]
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

Q, DX, DQ, HIDDEN = 32, 40, 40, (64, 64)
M_SCORE = 256          # the score's candidate rows, Q * C
D, FM = 40, 8          # the DeepFM measure (configs/guitar_deepfm.py)

# what every copy compiles: the entry files of the MLP grad and score pairs
# (and through them the headers), a sink and an empty kernel
HEAD_CU = r"""
#include "mlp_grad.cu"
#include "mlp_score.cu"
using namespace repro;

// keep a variant's shared-memory work alive without writing anything
__device__ inline void sink(const float* sm, float* out, int M) {
  if (threadIdx.x == 0 && sm[M & 7] == 1234.5f) out[0] = sm[1];
}

__global__ void __launch_bounds__(256) warp_empty(float* vals, int M) {
  if (M < 0) vals[0] = 0.f;
}
"""

# cut-down copies of the one-warp-per-row layout (compiled only from
# sources whose mlp.cuh still defines mlp_stage and mlp_forward_warp)
WARP_CU = r"""
__global__ void __launch_bounds__(kMLPThreads)
warp_stage(MLPNet net, float* vals, int M) {
  extern __shared__ float sm[];
  mlp_stage(sm, net);
  __syncthreads();
  sink(sm, vals, M);
}

__global__ void __launch_bounds__(kMLPThreads)
warp_forward(GatheredRows rows, const float* __restrict__ query,
             int q_shared, MLPNet net, float* __restrict__ vals, int M) {
  extern __shared__ float sm[];
  mlp_stage(sm, net);
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* scr = sm + net.weight_floats + warp * net.scratch_floats;
  float* slice = scr + net.scratch_floats - net.dx;
  const int row0 = blockIdx.x * kMLPRowsPerBlock;
  const int row1 = min(row0 + kMLPRowsPerBlock, M);
  for (int r = row0 + warp; r < row1; r += blockDim.x / kWarp) {
    __syncwarp();
    const float* x = rows.load(r, net.dx, slice, lane);
    const float* q =
        q_shared ? query : query + static_cast<size_t>(r) * net.dq;
    const float val = mlp_forward_warp(sm, net, x, q, scr, lane);
    if (lane == 0) vals[r] = val;
  }
}

// variant 0 the launch, 1 staging, 2 staging and the forward, at the
// layout's grid of M / 8 blocks and its shared memory
static int warp_variant(int variant, const void* cand, const void* query,
                        int q_shared, const void* const* ws,
                        const void* const* bs, const int* dims, int layers,
                        void* vals, int M, int Dx, int Dq, void* stream) {
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mlp_smem_bytes(net);
  const int grid = (M + kMLPRowsPerBlock - 1) / kMLPRowsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(vals);
  switch (variant) {
    case 0:
      allow_smem(warp_empty, smem);
      warp_empty<<<grid, kMLPThreads, smem, s>>>(v, M);
      break;
    case 1:
      allow_smem(warp_stage, smem);
      warp_stage<<<grid, kMLPThreads, smem, s>>>(net, v, M);
      break;
    default:
      allow_smem(warp_forward, smem);
      warp_forward<<<grid, kMLPThreads, smem, s>>>(
          GatheredRows{static_cast<const float*>(cand)},
          static_cast<const float*>(query), q_shared, net, v, M);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# the entries: variants 0-2 of the one-warp-per-row layout, 3 the
# sources' own mlp_grad_f32 (split_run) or mlp_score_f32 (split_score),
# whatever body it launches; each takes the arguments of mlp_grad_f32
ENTRY_CU = r"""
extern "C" int split_run(int variant, const void* cand, const void* query,
                         int q_shared, const void* const* ws,
                         const void* const* bs, const int* dims, int layers,
                         void* vals, void* grads, int M, int Dx, int Dq,
                         void* stream) {
#if SPLIT_WARP
  if (variant < 3)
    return warp_variant(variant, cand, query, q_shared, ws, bs, dims, layers,
                        vals, M, Dx, Dq, stream);
#endif
  return mlp_grad_f32(cand, query, q_shared, ws, bs, dims, layers, vals,
                      grads, M, Dx, Dq, stream);
}

extern "C" int split_score(int variant, const void* cand, const void* query,
                           int q_shared, const void* const* ws,
                           const void* const* bs, const int* dims,
                           int layers, void* vals, void*, int M, int Dx,
                           int Dq, void* stream) {
#if SPLIT_WARP
  if (variant < 3)
    return warp_variant(variant, cand, query, q_shared, ws, bs, dims, layers,
                        vals, M, Dx, Dq, stream);
#endif
  return mlp_score_f32(cand, query, q_shared, ws, bs, dims, layers, vals, M,
                       Dx, Dq, stream);
}
"""

# cut-down copies of the DeepFM one-warp-per-row score layout (compiled
# only from sources whose deepfm.cuh still defines deepfm_stage and
# deepfm_forward_warp)
DEEPFM_WARP_CU = r"""
__global__ void __launch_bounds__(kDeepFMThreads)
dfm_stage(DeepFMWeights w, float* vals, int M, int K0, int H0, int H1) {
  extern __shared__ float sm[];
  deepfm_stage(deepfm_layout(sm, K0, H0, H1), w, K0, H0, H1);
  __syncthreads();
  sink(sm, vals, M);
}

__global__ void __launch_bounds__(kDeepFMThreads)
dfm_forward(GatheredRows rows, const float* __restrict__ query, int q_shared,
            DeepFMWeights w, float* __restrict__ vals, int M, int D, int fm,
            int H0, int H1) {
  extern __shared__ float sm[];
  const int dd = D - fm, K0 = 2 * dd;
  const DeepFMSmem s = deepfm_layout(sm, K0, H0, H1);
  deepfm_stage(s, w, K0, H0, H1);
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const DeepFMScratch c = deepfm_scratch(sm, warp, K0, H0, H1, D);
  const int row0 = blockIdx.x * kDeepFMRowsPerBlock;
  const int row1 = min(row0 + kDeepFMRowsPerBlock, M);
  for (int r = row0 + warp; r < row1; r += blockDim.x / kWarp) {
    __syncwarp();
    const float* x = rows.load(r, D, c.x, lane);
    const float* q = q_shared ? query : query + static_cast<size_t>(r) * D;
    const float val =
        deepfm_forward_warp(s, x, q, c.in, c.z0, c.z1, fm, dd, H0, H1, lane);
    if (lane == 0) vals[r] = val;
  }
}

// variant 0 the launch, 1 staging, 2 staging and the forward, at the
// layout's grid of M / 8 blocks and its shared memory
static int dfm_warp_variant(int variant, const void* cand, const void* query,
                            int q_shared, const DeepFMWeights& w, void* vals,
                            int M, int D, int fm, int H0, int H1,
                            void* stream) {
  const size_t smem = deepfm_smem_bytes(D, fm, H0, H1);
  const int grid = (M + kDeepFMRowsPerBlock - 1) / kDeepFMRowsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(vals);
  switch (variant) {
    case 0:
      allow_smem(warp_empty, smem);
      warp_empty<<<grid, kDeepFMThreads, smem, s>>>(v, M);
      break;
    case 1:
      allow_smem(dfm_stage, smem);
      dfm_stage<<<grid, kDeepFMThreads, smem, s>>>(w, v, M, 2 * (D - fm), H0,
                                                   H1);
      break;
    default:
      allow_smem(dfm_forward, smem);
      dfm_forward<<<grid, kDeepFMThreads, smem, s>>>(
          GatheredRows{static_cast<const float*>(cand)},
          static_cast<const float*>(query), q_shared, w, v, M, D, fm, H0, H1);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# the DeepFM entries: variants 0-2 of the one-warp-per-row score layout, 3
# the sources' own deepfm_grad_f32 (split_deepfm) or deepfm_score_f32
# (split_deepfm_score); each takes the arguments of deepfm_grad_f32
DEEPFM_CU = r"""
#include "deepfm_grad.cu"
#include "deepfm_score.cu"

extern "C" int split_deepfm(int variant, const void* cand, const void* query,
                            int q_shared, const void* w0, const void* b0,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* vals, void* grads, int M,
                            int D, int fm, int H0, int H1, void* stream) {
#if SPLIT_DFM_WARP
  if (variant < 3)
    return dfm_warp_variant(variant, cand, query, q_shared,
                            deepfm_weights(w0, b0, w1, b1, w2, b2), vals, M,
                            D, fm, H0, H1, stream);
#endif
  return deepfm_grad_f32(cand, query, q_shared, w0, b0, w1, b1, w2, b2, vals,
                         grads, M, D, fm, H0, H1, stream);
}

extern "C" int split_deepfm_score(int variant, const void* cand,
                                  const void* query, int q_shared,
                                  const void* w0, const void* b0,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* vals,
                                  void*, int M, int D, int fm, int H0, int H1,
                                  void* stream) {
#if SPLIT_DFM_WARP
  if (variant < 3)
    return dfm_warp_variant(variant, cand, query, q_shared,
                            deepfm_weights(w0, b0, w1, b1, w2, b2), vals, M,
                            D, fm, H0, H1, stream);
#endif
  return deepfm_score_f32(cand, query, q_shared, w0, b0, w1, b1, w2, b2, vals,
                          M, D, fm, H0, H1, stream);
}
"""

# the cluster kernel's phases, where the checkout has it
CLUSTER_CU = r"""
extern "C" int split_cluster(int stop, const void* cand, const void* query,
                             int q_shared, const void* const* ws,
                             const void* const* bs, const int* dims,
                             int layers, void* vals, void* grads, int M,
                             int Dx, int Dq, void* stream) {
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  const GatheredRows rows{static_cast<const float*>(cand)};
  switch (stop) {
    case 0:
      return static_cast<int>(launch_mlp_grad_cluster<GatheredRows, 0>(
          rows, query, q_shared, net, vals, grads, nullptr, M, stream));
    case 1:
      return static_cast<int>(launch_mlp_grad_cluster<GatheredRows, 1>(
          rows, query, q_shared, net, vals, grads, nullptr, M, stream));
    default:
      return static_cast<int>(launch_mlp_grad_cluster<GatheredRows, 2>(
          rows, query, q_shared, net, vals, grads, nullptr, M, stream));
  }
}
"""


# the DeepFM grad on the cluster kernel's phases, where the checkout has it
DEEPFM_CLUSTER_CU = r"""
extern "C" int split_deepfm_cluster(int stop, const void* cand,
                                    const void* query, int q_shared,
                                    const void* w0, const void* b0,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* b2,
                                    void* vals, void* grads, int M, int D,
                                    int fm, int H0, int H1, void* stream) {
  const DeepFMWeights w = deepfm_weights(w0, b0, w1, b1, w2, b2);
  const GatheredRows rows{static_cast<const float*>(cand)};
  switch (stop) {
    case 0:
      return static_cast<int>(launch_deepfm_grad_cluster<GatheredRows, 0>(
          rows, query, q_shared, w, vals, grads, nullptr, M, D, fm, H0, H1,
          stream));
    case 1:
      return static_cast<int>(launch_deepfm_grad_cluster<GatheredRows, 1>(
          rows, query, q_shared, w, vals, grads, nullptr, M, D, fm, H0, H1,
          stream));
    default:
      return static_cast<int>(launch_deepfm_grad_cluster<GatheredRows, 2>(
          rows, query, q_shared, w, vals, grads, nullptr, M, D, fm, H0, H1,
          stream));
  }
}
"""


# the score on the cluster kernel's phases, where the checkout has it
SCORE_CLUSTER_CU = r"""
extern "C" int split_score_cluster(int stop, const void* cand,
                                   const void* query, int q_shared,
                                   const void* const* ws,
                                   const void* const* bs, const int* dims,
                                   int layers, void* vals, void*, int M,
                                   int Dx, int Dq, void* stream) {
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  const GatheredRows rows{static_cast<const float*>(cand)};
  switch (stop) {
    case 0:
      return static_cast<int>(launch_mlp_score_cluster<GatheredRows, 0>(
          rows, query, q_shared, nullptr, net, vals, M, stream));
    case 1:
      return static_cast<int>(launch_mlp_score_cluster<GatheredRows, 1>(
          rows, query, q_shared, nullptr, net, vals, M, stream));
    default:
      return static_cast<int>(launch_mlp_score_cluster<GatheredRows, 2>(
          rows, query, q_shared, nullptr, net, vals, M, stream));
  }
}
"""

# the DeepFM score on the cluster kernel's phases, where the checkout has it
DEEPFM_SCORE_CLUSTER_CU = r"""
extern "C" int split_deepfm_score_cluster(int stop, const void* cand,
                                          const void* query, int q_shared,
                                          const void* w0, const void* b0,
                                          const void* w1, const void* b1,
                                          const void* w2, const void* b2,
                                          void* vals, void*, int M, int D,
                                          int fm, int H0, int H1,
                                          void* stream) {
  const DeepFMWeights w = deepfm_weights(w0, b0, w1, b1, w2, b2);
  const GatheredRows rows{static_cast<const float*>(cand)};
  switch (stop) {
    case 0:
      return static_cast<int>(launch_deepfm_score_cluster<GatheredRows, 0>(
          rows, query, q_shared, nullptr, w, vals, M, D, fm, H0, H1, stream));
    case 1:
      return static_cast<int>(launch_deepfm_score_cluster<GatheredRows, 1>(
          rows, query, q_shared, nullptr, w, vals, M, D, fm, H0, H1, stream));
    default:
      return static_cast<int>(launch_deepfm_score_cluster<GatheredRows, 2>(
          rows, query, q_shared, nullptr, w, vals, M, D, fm, H0, H1, stream));
  }
}
"""

# the score's tile swept: rows per cluster x CTAs per cluster (SWEEP), each
# point the serving widths compiled in, over pre-gathered rows or (fused)
# int8 corpus rows with an optional prefix mask; info (nullable) receives
# the point's rows, CTAs, shared memory per CTA and
# cudaOccupancyMaxActiveClusters instead of a launch
SWEEP = ((4, 4), (4, 8), (8, 4), (8, 8), (16, 4), (16, 8), (32, 4), (32, 8),
         (16, 2), (32, 2))
SWEEP_CU = r"""
template <int T, int N>
static int sweep_at(int fused, const void* data, const void* scales,
                    const void* ids, const void* cand, const void* query,
                    int q_shared, const void* mask, const void* const* ws,
                    const void* const* bs, const int* dims, int layers,
                    void* out, int M, int Dx, int Dq, void* stream,
                    int* info) {
  MLPNet net;
  MLPGradPlan plan;
  using W = mlpg::FixedWidths<80, 40, 64, 3, N>;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq) ||
      !mlp_score_plan(plan, net, T, N) || !W::matches(net, plan))
    return static_cast<int>(cudaErrorInvalidValue);
  using I8 = CorpusRows<kI8>;
  if (info != nullptr) {
    info[0] = T;
    info[1] = plan.n;
    info[2] = static_cast<int>(sizeof(float) * plan.floats);
    return static_cast<int>(
        fused ? mlp_score_max_clusters<I8, W, T>(plan, info + 3)
              : mlp_score_max_clusters<GatheredRows, W, T>(plan, info + 3));
  }
  if (fused)
    return static_cast<int>(launch_mlp_score_cluster_as<I8, kMLPGradAll, W,
                                                        T>(
        I8{static_cast<const signed char*>(data),
           static_cast<const float*>(scales),
           static_cast<const int64_t*>(ids)},
        query, q_shared, mask, net, plan, out, M, stream));
  return static_cast<int>(launch_mlp_score_cluster_as<GatheredRows,
                                                      kMLPGradAll, W, T>(
      GatheredRows{static_cast<const float*>(cand)}, query, q_shared,
      nullptr, net, plan, out, M, stream));
}

extern "C" int score_sweep(int point, int fused, const void* data,
                           const void* scales, const void* ids,
                           const void* cand, const void* query, int q_shared,
                           const void* mask, const void* const* ws,
                           const void* const* bs, const int* dims,
                           int layers, void* out, int M, int Dx, int Dq,
                           void* stream, int* info) {
#define SWEEP_AT(T, N)                                                  \
  sweep_at<T, N>(fused, data, scales, ids, cand, query, q_shared, mask, \
                 ws, bs, dims, layers, out, M, Dx, Dq, stream, info)
  switch (point) {
SWEEP_CASES
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWEEP_AT
}
"""


# the same sweep at the DeepFM serving widths (D 40, fm 8, 64 x 64), the
# plan of deepfm_cluster_plan at each point
DEEPFM_SWEEP_CU = r"""
template <int T, int N>
static int dfm_sweep_at(int fused, const void* data, const void* scales,
                        const void* ids, const void* cand, const void* query,
                        int q_shared, const void* mask, const DeepFMWeights& w,
                        void* out, int M, int D, int fm, int H0, int H1,
                        void* stream, int* info) {
  MLPNet net;
  MLPGradPlan plan;
  mlpg::DeepFMInput in;
  using W = mlpg::FixedWidths<64, 32, 64, 3, N, 8>;
  if (!deepfm_cluster_plan(net, plan, in, w, D, fm, H0, H1, T, N, false) ||
      !W::matches(net, plan, fm))
    return static_cast<int>(cudaErrorInvalidValue);
  using I8 = CorpusRows<kI8>;
  using In = mlpg::DeepFMInput;
  if (info != nullptr) {
    info[0] = T;
    info[1] = plan.n;
    info[2] = static_cast<int>(sizeof(float) * plan.floats);
    return static_cast<int>(
        fused ? mlp_score_max_clusters<I8, W, T, In>(plan, info + 3)
              : mlp_score_max_clusters<GatheredRows, W, T, In>(plan,
                                                               info + 3));
  }
  if (fused)
    return static_cast<int>(launch_mlp_score_cluster_as<I8, kMLPGradAll, W,
                                                        T>(
        I8{static_cast<const signed char*>(data),
           static_cast<const float*>(scales),
           static_cast<const int64_t*>(ids)},
        query, q_shared, mask, net, plan, out, M, stream, in));
  return static_cast<int>(launch_mlp_score_cluster_as<GatheredRows,
                                                      kMLPGradAll, W, T>(
      GatheredRows{static_cast<const float*>(cand)}, query, q_shared,
      nullptr, net, plan, out, M, stream, in));
}

extern "C" int deepfm_sweep(int point, int fused, const void* data,
                            const void* scales, const void* ids,
                            const void* cand, const void* query, int q_shared,
                            const void* mask, const void* w0, const void* b0,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int M, int D, int fm,
                            int H0, int H1, void* stream, int* info) {
  const DeepFMWeights w = deepfm_weights(w0, b0, w1, b1, w2, b2);
#define SWEEP_AT(T, N)                                                      \
  dfm_sweep_at<T, N>(fused, data, scales, ids, cand, query, q_shared, mask, \
                     w, out, M, D, fm, H0, H1, stream, info)
  switch (point) {
SWEEP_CASES
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWEEP_AT
}
"""


# each point of SWEEP a case of the sweep entries' switch
SWEEP_CASES = "\n".join(f"    case {i}: return SWEEP_AT({t}, {n});"
                        for i, (t, n) in enumerate(SWEEP))
SWEEP_CU, DEEPFM_SWEEP_CU = (cu.replace("SWEEP_CASES", SWEEP_CASES)
                             for cu in (SWEEP_CU, DEEPFM_SWEEP_CU))


def _defines(csrc, name, word):
    """Whether ``csrc``'s file ``name`` exists and mentions ``word``."""
    path = os.path.join(csrc, name)
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return word in f.read()


def build(csrc, out_dir, measure, kernel="grad", sweep=False):
    """Compile the variants of ``measure``'s ``kernel`` (grad or score)
    against the kernel sources in ``csrc`` into one library with the
    port's nvcc flags; returns (library, whether the kernel runs on the
    cluster body, whether the sources have the measure's one-warp-per-row
    layout, nvcc's output, the library's SASS)."""
    from repro_torch.kernels import _lib
    os.makedirs(out_dir, exist_ok=True)
    has_warp = _defines(csrc, "mlp.cuh", "mlp_forward_warp")
    cu = f"#define SPLIT_WARP {int(has_warp)}\n" + HEAD_CU + (
        WARP_CU if has_warp else "") + ENTRY_CU
    if measure == "deepfm":
        has_warp = _defines(csrc, "deepfm.cuh", "deepfm_forward_warp")
        cu += f"#define SPLIT_DFM_WARP {int(has_warp)}\n" + (
            DEEPFM_WARP_CU if has_warp else "") + DEEPFM_CU
        if kernel == "score":
            has_cluster = _defines(csrc, "mlp_grad.cuh",
                                   "launch_deepfm_score_cluster")
            cu += (DEEPFM_SCORE_CLUSTER_CU + (DEEPFM_SWEEP_CU if sweep
                                              else "")
                   if has_cluster else "")
        else:
            has_cluster = _defines(csrc, "mlp_grad.cuh",
                                   "launch_deepfm_grad_cluster")
            cu += DEEPFM_CLUSTER_CU if has_cluster else ""
    elif kernel == "score":
        has_cluster = _defines(csrc, "mlp_grad.cuh",
                               "launch_mlp_score_cluster")
        cu += (SCORE_CLUSTER_CU + (SWEEP_CU if sweep else "")
               if has_cluster else "")
    else:
        has_cluster = _defines(csrc, "mlp_grad.cuh",
                               "launch_mlp_grad_cluster")
        cu += CLUSTER_CU if has_cluster else ""
    src = os.path.join(out_dir, "mlp_grad_split.cu")
    with open(src, "w") as f:
        f.write(cu)
    so = os.path.join(out_dir, "libmlp_grad_split.so")
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", csrc, "-shared", "-o", so,
           src]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}\n{out.stderr}")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump"), "-sass",
         so], capture_output=True, text=True).stdout
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    if measure == "deepfm":
        score = kernel == "score"
        names = ["split_deepfm", "split_deepfm_score"] + (
            [("split_deepfm_score_cluster" if score else
              "split_deepfm_cluster")] if has_cluster else [])
        argtypes = [I, P, P, I, P, P, P, P, P, P, P, P, I, I, I, I, I, P]
    else:
        names = ["split_run", "split_score"] + (
            [("split_score_cluster" if kernel == "score" else
              "split_cluster")] if has_cluster else [])
        argtypes = [I, P, P, I, P, P, P, I, P, P, I, I, I, P]
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    if kernel == "score" and has_cluster and sweep:
        if measure == "deepfm":
            lib.deepfm_sweep.argtypes = [I, I, P, P, P, P, P, I, P, P, P, P,
                                         P, P, P, P, I, I, I, I, I, P, P]
            lib.deepfm_sweep.restype = I
        else:
            lib.score_sweep.argtypes = [I, I, P, P, P, P, P, I, P, P, P, P,
                                        I, P, I, I, I, P, P]
            lib.score_sweep.restype = I
    return lib, has_cluster, has_warp, out.stdout + out.stderr, sass


def is_kernel(fn: str, measure: str, kernel: str) -> bool:
    """Whether SASS function ``fn`` is a ``kernel`` (grad or score) kernel
    of ``measure``: the cluster kernel's instantiations for that measure's
    input (``DeepFMInput`` in the name for DeepFM) or its one-warp-per-row
    kernel."""
    cluster = f"mlp_{kernel}_cluster_kernel"
    if measure == "deepfm":
        return f"deepfm_{kernel}_kernel" in fn or (
            cluster in fn and "DeepFMInput" in fn)
    return f"mlp_{kernel}" in fn and "DeepFMInput" not in fn


def sass_opcodes(sass: str, measure: str, kernel: str = "grad") -> dict:
    """Opcode counts of each ``kernel`` kernel of ``measure``."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if is_kernel(fn, measure, kernel) else None
        elif fn and "/*" in line and ";" in line:
            op = line.split("*/", 1)[1].strip().split()
            if op and op[0].startswith("@"):
                op = op[1:]
            if op:
                name = op[0].rstrip(";")
                counts.setdefault(fn, {})
                counts[fn][name] = counts[fn].get(name, 0) + 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--measure", choices=("mlp", "deepfm"), default="mlp")
    ap.add_argument("--kernel", choices=("grad", "score"), default="grad",
                    help="split the grad kernel (Q = 32) or the score "
                         "kernel (M = 256)")
    ap.add_argument("--sweep", action="store_true",
                    help="with --kernel score, also time the cluster "
                         "body's tile at every rows x CTAs point of SWEEP, "
                         "at M = 256 and at the adaptive M = 512 (int8 "
                         "rows, c_max = 16) masked and not")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--csrc", nargs="*", default=None,
                    help="kernel source directories to split, each timed "
                         "in turns with the others (default: this "
                         "checkout's)")
    ap.add_argument("--sass-dir", default=None,
                    help="also write each copy's SASS of the split kernels "
                         "to this directory")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mlp_grad_split: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core import make_corpus_store
    from repro_torch.kernels import _lib
    from repro_torch.kernels.deepfm_grad.ref import deepfm_value_and_grad_ref
    from repro_torch.kernels.deepfm_score.ref import deepfm_score_ref
    from repro_torch.kernels.deepfm_score_fused.ref import \
        deepfm_score_fused_ref
    from repro_torch.kernels.mlp_grad.ref import mlp_value_and_grad_ref
    from repro_torch.kernels.mlp_score.ops import net_args
    from repro_torch.kernels.mlp_score.ref import mlp_score_ref
    from repro_torch.kernels.mlp_score_fused.ref import mlp_score_fused_ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(456)
    deepfm = opts.measure == "deepfm"
    score = opts.kernel == "score"
    M = M_SCORE if score else Q
    if deepfm:
        dd = D - FM
        net = chip_smoke.random_mlp(torch, dev, 2 * dd, HIDDEN, gen)
        dx, dq = D, D
        wb = [t for pair in zip(net["w"], net["b"]) for t in pair]
        args = [t.data_ptr() for t in wb]
        widths = (D, FM, *HIDDEN)
        plain = {"score": lambda c, q: deepfm_score_ref(c, q, *wb, FM),
                 "fused": lambda st, i, q, m: deepfm_score_fused_ref(
                     st, i, q, *wb, FM, m),
                 "grad": lambda c, q: deepfm_value_and_grad_ref(c, q, *wb,
                                                                FM)}
        shape = f"{'M' if score else 'Q'}={M} D={D} fm={FM} hidden={HIDDEN}"
    else:
        net = chip_smoke.random_mlp(torch, dev, DX + DQ, HIDDEN, gen)
        dx, dq = DX, DQ
        w, b = net["w"], net["b"]
        args = net_args(w, b, DX, dev)
        widths = (DX, DQ)
        plain = {"score": lambda c, q: mlp_score_ref(c, q, w, b),
                 "fused": lambda st, i, q, m: mlp_score_fused_ref(
                     st, i, q, w, b, m),
                 "grad": lambda c, q: mlp_value_and_grad_ref(c, q, w, b)}
        shape = (f"{'M' if score else 'Q'}={M} Dx={DX} Dq={DQ} "
                 f"hidden={HIDDEN}")
    c = torch.randn((M, dx), generator=gen).to(dev)
    q = torch.randn((M, dq), generator=gen).to(dev)
    grads = torch.empty((M, dx), device=dev)
    pv, pg = (plain["score"](c, q), None) if score else plain["grad"](c, q)
    vals = torch.empty((M,), device=dev)

    def call(fn, variant):
        def run():       # on the current stream: time_ms captures a graph
            rc = fn(variant, c.data_ptr(), q.data_ptr(), 0, *args,
                    vals.data_ptr(), grads.data_ptr(), M, *widths,
                    _lib.stream_of(dev))
            _lib.check(rc, f"variant {variant}")
        return run

    out = {"device": chip_smoke.nvidia_smi_line(), "unit": "us",
           "measure": opts.measure, "kernel": opts.kernel, "shape": shape,
           "err": {}, "ptxas": {}, "sass_opcodes": {}}
    calls = {}
    sweeps = []
    for i, csrc in enumerate(opts.csrc or [str(_lib.CSRC)]):
        label = os.path.basename(os.path.normpath(csrc)) + (
            f"#{i}" if opts.csrc else "")
        lib, has_cluster, has_warp, log, sass = build(
            csrc, os.path.join(ROOT, "build", "mlp_grad_split", str(i)),
            opts.measure, opts.kernel, opts.sweep)
        if deepfm:
            whole = lib.split_deepfm_score if score else lib.split_deepfm
        else:
            whole = lib.split_score if score else lib.split_run
        phases = ("empty", "stage", "forward")
        if (score and has_warp) or (not score and not has_cluster):
            for v, name in enumerate(phases):
                calls[f"{label}:warp_{name}"] = call(whole, v)
        if has_cluster:
            fn = getattr(lib, ("split_deepfm" if deepfm else "split")
                         + ("_score" if score else "") + "_cluster")
            for v, name in enumerate(phases):
                calls[f"{label}:cluster_{name}"] = call(fn, v)
        calls[f"{label}:kernel"] = call(whole, 3)
        calls[f"{label}:kernel"]()
        torch.cuda.synchronize()
        out["err"][label] = max(float((vals - pv).abs().max()),
                                0.0 if pg is None else
                                float((grads - pg).abs().max()))
        out["ptxas"][label] = [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        out["sass_opcodes"][label] = sass_opcodes(sass, opts.measure,
                                                  opts.kernel)
        if opts.sass_dir:
            os.makedirs(opts.sass_dir, exist_ok=True)
            with open(os.path.join(opts.sass_dir, f"{label}.sass"), "w") as f:
                f.write(sass)
        if score and has_cluster and opts.sweep:
            sweeps.append((label, lib))
        try:            # a copy instrumented with clock64 stamps
            stamps = lib.mlp_grad_stamps
        except AttributeError:
            continue
        buf = (ctypes.c_ulonglong * 128)()
        calls[f"{label}:kernel"]()
        torch.cuda.synchronize()
        _lib.check(stamps(buf), "mlp_grad_stamps")
        out.setdefault("stamps", {})[label] = list(buf)
    if sweeps:
        entry = "deepfm_sweep" if deepfm else "score_sweep"

        def sweep(lib, point, fused, data, scales, ids, cand, query, mask,
                  res, rows, info):
            return getattr(lib, entry)(
                point, fused, data, scales, ids, cand, query, 0, mask, *args,
                res, rows, *widths, _lib.stream_of(dev), info)
        calls.update(sweep_calls(torch, dev, gen, c, q, dx, dq, sweeps, out,
                                 sweep, plain, make_corpus_store, chip_smoke,
                                 _lib))
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


def sweep_calls(torch, dev, gen, c, q, dx, dq, sweeps, out, sweep, plain,
                make_corpus_store, chip_smoke, _lib):
    """The sweep's calls, each point checked against the plain version
    first: at M = 256 over pre-gathered rows (``c``, ``q``), and at the
    adaptive M = 512 over int8 corpus rows (``dx`` wide, queries ``dq``)
    with and without its prefix mask (32 lanes of c_max = 16). ``sweep``
    calls a library's sweep entry, ``plain`` holds the plain versions.
    Records each point's plan and errors in ``out["sweep"]``."""
    N = 5000
    store = make_corpus_store(torch.randn((N, dx), generator=gen), "int8",
                              device=dev)
    ids = torch.randint(0, N, (2 * M_SCORE,), generator=gen).to(dev)
    qa = torch.randn((2 * M_SCORE, dq), generator=gen).to(dev)
    mask = chip_smoke.prefix_mask(torch, 32, 16, gen).to(dev)
    data, scales, _ = _lib.corpus_args(store)
    want = {"m256": plain["score"](c, q),
            "m512": plain["fused"](store, ids, qa, None),
            "m512_masked": plain["fused"](store, ids, qa, mask)}
    outs = {k: torch.empty_like(v) for k, v in want.items()}
    calls = {}
    for label, lib in sweeps:
        for point, (rows, ctas) in enumerate(SWEEP):
            tag = f"{label}:sweep_t{rows}_n{ctas}"
            info = (ctypes.c_int * 4)()
            _lib.check(sweep(lib, point, 0, None, None, None, None, None,
                             None, None, M_SCORE, info), f"{tag} plan")
            info_g = list(info)
            _lib.check(sweep(lib, point, 1, None, None, None, None, None,
                             None, None, M_SCORE, info), f"{tag} plan")
            rec = {"rows": info_g[0], "ctas": info_g[1],
                   "smem_bytes": info_g[2],
                   "max_active_clusters": info_g[3],
                   "max_active_clusters_int8": info[3], "err": {}}

            def one(point=point, key="m256", tag=tag, lib=lib):
                fused = key != "m256"
                M = 2 * M_SCORE if fused else M_SCORE
                m = mask.data_ptr() if key == "m512_masked" else None

                def run():
                    rc = sweep(lib, point, int(fused), data, scales,
                               ids.data_ptr(), c.data_ptr(),
                               (qa if fused else q).data_ptr(), m,
                               outs[key].data_ptr(), M, None)
                    _lib.check(rc, f"{tag} {key}")
                return run
            for key in want:
                fn = one(key=key)
                fn()
                torch.cuda.synchronize()
                got, ref = outs[key], want[key]
                if not torch.equal(torch.isneginf(got), torch.isneginf(ref)):
                    raise RuntimeError(f"{tag} {key}: masked rows differ")
                fin = torch.isfinite(ref)
                err, ratio = chip_smoke.close_err(
                    got[fin], ref[fin], chip_smoke.SCORE_RTOL,
                    chip_smoke.SCORE_ATOL)
                if ratio > 1.0:
                    raise RuntimeError(f"{tag} {key}: {err:.3e}")
                rec["err"][key] = err
                calls[f"{tag}:{key}"] = fn
            out.setdefault("sweep", {})[tag] = rec
    return calls


if __name__ == "__main__":
    sys.exit(main())
