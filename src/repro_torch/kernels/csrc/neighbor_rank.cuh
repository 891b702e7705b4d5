// The GUITAR neighbor-ranking kernel (paper Eq. 3 / Eq. 4 keys and the
// adaptive alpha*theta mask), one body for every row source: see
// neighbor_rank.cu (pre-gathered rows) and neighbor_rank_fused.cu (rows by
// id from the resident corpus) for what each replaces and what bounds it.
#pragma once

#include "rows.cuh"

namespace repro {

constexpr int kRankThreads = 256;

// Keys and the alpha*theta mask of one lane per block, one warp per
// neighbor row; ``nv`` is the row source (rows.cuh): pre-gathered float32
// rows, or rows by id from the resident corpus, dequantized as read.
template <class Rows>
__global__ void __launch_bounds__(kRankThreads)
neighbor_rank_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     Rows nv,
                     const unsigned char* __restrict__ valid,
                     float* __restrict__ key, unsigned char* __restrict__ mask,
                     int B, int D, float alpha, int by_angle) {
  extern __shared__ float rank_key[];  // B: angle, or masked projection
  __shared__ float theta_s;
  const float eps = 1e-12f;
  const int qrow = blockIdx.x;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  const float* xr = x + static_cast<size_t>(qrow) * D;
  const float* gr = g + static_cast<size_t>(qrow) * D;

  float gp = 0.f;
  for (int d = lane; d < D; d += kWarp) gp = fmaf(gr[d], gr[d], gp);
  const float gnorm = sqrtf(warp_sum(gp)) + eps;

  for (int b = warp; b < B; b += nwarps) {
    const size_t qb = static_cast<size_t>(qrow) * B + b;
    const typename Rows::Row nb = nv.row(qb, D);
    float dp = 0.f, nn = 0.f;
    for (int d = lane; d < D; d += kWarp) {
      const float df = nv.get(nb, d) - xr[d];
      dp = fmaf(df, gr[d], dp);
      nn = fmaf(df, df, nn);
    }
    dp = warp_sum(dp);
    nn = warp_sum(nn);
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

template <class Rows>
inline cudaError_t launch_neighbor_rank(const void* x, const void* g, Rows nv,
                                        const void* valid, void* key,
                                        void* mask, int Q, int B, int D,
                                        float alpha, int by_angle,
                                        void* stream) {
  if (Q > 0 && B > 0) {
    const size_t smem = sizeof(float) * B;
    allow_smem(neighbor_rank_kernel<Rows>, smem);
    neighbor_rank_kernel<Rows><<<Q, kRankThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), nv,
        static_cast<const unsigned char*>(valid), static_cast<float*>(key),
        static_cast<unsigned char*>(mask), B, D, alpha, by_angle);
  }
  return cudaGetLastError();
}

}  // namespace repro
