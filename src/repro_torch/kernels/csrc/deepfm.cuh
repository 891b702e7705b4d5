// DeepFM measure pieces shared by the score and grad kernels.
//
//   f(x, q) = sigmoid(<x_fm, q_fm> + relu(relu([q_deep | x_deep] W0 + b0)
//                                         W1 + b1) W2 + b2)
//
// Layout: the whole measure MLP is staged once per block into shared memory,
// each weight matrix with a row stride of (cols + 1) floats. With that pad a
// warp reading one column across 32 rows (the backward's transposed
// products) hits 32 distinct banks, and a warp reading one row across 32
// columns (the forward) does too. Each warp then owns one candidate row at a
// time; its lanes split the hidden units, and the row's activations live in
// a per-warp scratch slice of shared memory, never in device memory.
//
// At the serving shapes the weight staging is the kernels' largest cost, so
// it keeps kStageLoads global loads in flight per thread, and a block holds
// one row per warp so that more blocks (on more SMs) stage in parallel.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kDeepFMThreads = 256;       // 8 warps
constexpr int kDeepFMRowsPerBlock = 8;    // one row per warp
constexpr int kStageLoads = 16;           // independent loads per thread

struct DeepFMSmem {
  float* W0;  // K0 x (H0 + 1)
  float* b0;  // H0
  float* W1;  // H0 x (H1 + 1)
  float* b1;  // H1
  float* w2;  // H1
  float* b2;  // 1
};

__host__ __device__ inline size_t deepfm_weight_floats(int K0, int H0,
                                                       int H1) {
  return static_cast<size_t>(K0) * (H0 + 1) + H0 +
         static_cast<size_t>(H0) * (H1 + 1) + H1 + H1 + 1;
}

// Per-warp scratch: deep input (K0), z0 (H0), z1 (H1), and for the
// backward g1 (H1) and g0 (H0).
__host__ __device__ inline size_t deepfm_scratch_floats(int K0, int H0,
                                                        int H1) {
  return static_cast<size_t>(K0) + 2 * H0 + 2 * H1;
}

__device__ inline DeepFMSmem deepfm_layout(float* sm, int K0, int H0,
                                           int H1) {
  DeepFMSmem s;
  s.W0 = sm;
  s.b0 = s.W0 + static_cast<size_t>(K0) * (H0 + 1);
  s.W1 = s.b0 + H0;
  s.b1 = s.W1 + static_cast<size_t>(H0) * (H1 + 1);
  s.w2 = s.b1 + H1;
  s.b2 = s.w2 + H1;
  return s;
}

// Copy a (rows, cols) row-major matrix into shared memory with a row
// stride of cols + 1. Each thread issues kStageLoads independent global
// loads before storing any, so the copy costs a few load latencies rather
// than one per element.
__device__ inline void stage_padded(float* dst, const float* __restrict__ src,
                                    int rows, int cols) {
  const int n = rows * cols;
  for (int base = threadIdx.x; base < n; base += kStageLoads * blockDim.x) {
    float v[kStageLoads];
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const int i = base + j * blockDim.x;
      v[j] = i < n ? __ldg(src + i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const int i = base + j * blockDim.x;
      if (i < n) {
        const int r = i / cols;
        dst[r * (cols + 1) + (i - r * cols)] = v[j];
      }
    }
  }
}

// Block-wide copy of the weights into the padded shared layout. The caller
// must __syncthreads() before reading.
__device__ inline void deepfm_stage(const DeepFMSmem& s,
                                    const float* __restrict__ w0,
                                    const float* __restrict__ b0,
                                    const float* __restrict__ w1,
                                    const float* __restrict__ b1,
                                    const float* __restrict__ w2,
                                    const float* __restrict__ b2, int K0,
                                    int H0, int H1) {
  stage_padded(s.W0, w0, K0, H0);
  stage_padded(s.W1, w1, H0, H1);
  for (int i = threadIdx.x; i < H0; i += blockDim.x) s.b0[i] = b0[i];
  for (int i = threadIdx.x; i < H1; i += blockDim.x) {
    s.b1[i] = b1[i];
    s.w2[i] = w2[i];
  }
  if (threadIdx.x == 0) s.b2[0] = b2[0];
}

// z[u] = bias[u] + sum_k in_k * W[k, u] for the lane's units u = lane,
// lane + 32, ... (W in the padded layout, row stride H + 1). Two units per
// pass keep two independent FMA chains in flight. ``relu_in`` applies
// max(., 0) to the inputs as they are read.
template <bool relu_in>
__device__ inline void dense_warp(const float* in, int K, const float* W,
                                  const float* bias, int H, float* z,
                                  int lane) {
  for (int u0 = lane; u0 < H; u0 += 2 * kWarp) {
    const int u1 = u0 + kWarp;
    const bool two = u1 < H;
    float a0 = 0.f, a1 = 0.f;
    for (int k = 0; k < K; ++k) {
      const float v = relu_in ? fmaxf(in[k], 0.f) : in[k];
      const float* row = W + k * (H + 1);
      a0 = fmaf(v, row[u0], a0);
      if (two) a1 = fmaf(v, row[u1], a1);
    }
    z[u0] = a0 + bias[u0];
    if (two) z[u1] = a1 + bias[u1];
  }
}

// One warp's forward pass over the row (x, q). Leaves the pre-activations
// z0 (H0) and z1 (H1) in scratch for a backward pass, and returns the
// score in every lane.
__device__ inline float deepfm_forward_warp(const DeepFMSmem& s,
                                            const float* __restrict__ x,
                                            const float* __restrict__ q,
                                            float* in, float* z0, float* z1,
                                            int fm, int dd, int H0, int H1,
                                            int lane) {
  const int K0 = 2 * dd;
  for (int k = lane; k < dd; k += kWarp) {
    in[k] = q[fm + k];
    in[dd + k] = x[fm + k];
  }
  float fmp = 0.f;
  for (int k = lane; k < fm; k += kWarp) fmp = fmaf(x[k], q[k], fmp);
  const float fmv = warp_sum(fmp);
  __syncwarp();
  dense_warp<false>(in, K0, s.W0, s.b0, H0, z0, lane);
  __syncwarp();
  dense_warp<true>(z0, H0, s.W1, s.b1, H1, z1, lane);
  __syncwarp();
  float lp = 0.f;
  for (int u = lane; u < H1; u += kWarp)
    lp = fmaf(fmaxf(z1[u], 0.f), s.w2[u], lp);
  const float logit = (warp_sum(lp) + s.b2[0]) + fmv;
  return 1.f / (1.f + expf(-logit));
}

}  // namespace repro
