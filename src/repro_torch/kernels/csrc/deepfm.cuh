// The DeepFM measure's score kernels (deepfm_score, deepfm_score_fused) and
// their pieces. The grad kernels run on the MLP grad pair's cluster body
// (mlp_grad.cuh, over its DeepFM input).
//
//   f(x, q) = sigmoid(<x_fm, q_fm> + relu(relu([q_deep | x_deep] W0 + b0)
//                                         W1 + b1) W2 + b2)
//
// Layout: the whole measure MLP is staged once per block into shared memory,
// each weight matrix with a row stride of (cols + 1) floats, so that a warp
// reading one row across 32 columns hits 32 distinct banks (as would one
// reading a column across 32 rows). Each warp then owns one candidate row at a
// time; its lanes split the hidden units, and the row's activations live in
// a per-warp scratch slice of shared memory, never in device memory.
//
// At the serving shapes the weight staging is the kernels' largest cost, so
// it keeps kStageLoads global loads in flight per thread, and a block holds
// one row per warp so that more blocks (on more SMs) stage in parallel.
#pragma once

#include "common.cuh"
#include "rows.cuh"

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

// Per-warp scratch: deep input (K0), z0 (H0), z1 (H1), and the row slice
// (D) an index-fused kernel gathers and dequantizes its row into.
__host__ __device__ inline size_t deepfm_scratch_floats(int K0, int H0,
                                                        int H1, int D) {
  return static_cast<size_t>(K0) + H0 + H1 + D;
}

struct DeepFMScratch {
  float* in;
  float* z0;
  float* z1;
  float* x;
};

__device__ inline DeepFMScratch deepfm_scratch(float* sm, int warp, int K0,
                                               int H0, int H1, int D) {
  DeepFMScratch c;
  c.in = sm + deepfm_weight_floats(K0, H0, H1) +
         warp * deepfm_scratch_floats(K0, H0, H1, D);
  c.z0 = c.in + K0;
  c.z1 = c.z0 + H0;
  c.x = c.z1 + H1;
  return c;
}

// The measure MLP's parameters in device memory (row-major, as the
// PyTorch tensors hold them).
struct DeepFMWeights {
  const float* w0;
  const float* b0;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
};

// Dynamic shared memory of a DeepFM kernel block: the staged weights and
// one scratch slice per warp.
inline size_t deepfm_smem_bytes(int D, int fm, int H0, int H1) {
  const int K0 = 2 * (D - fm);
  return sizeof(float) *
         (deepfm_weight_floats(K0, H0, H1) +
          (kDeepFMThreads / kWarp) * deepfm_scratch_floats(K0, H0, H1, D));
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
                                    const DeepFMWeights& w, int K0, int H0,
                                    int H1) {
  stage_padded(s.W0, w.w0, K0, H0);
  stage_padded(s.W1, w.w1, H0, H1);
  for (int i = threadIdx.x; i < H0; i += blockDim.x) s.b0[i] = w.b0[i];
  for (int i = threadIdx.x; i < H1; i += blockDim.x) {
    s.b1[i] = w.b1[i];
    s.w2[i] = w.w2[i];
  }
  if (threadIdx.x == 0) s.b2[0] = w.b2[0];
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
// z0 (H0) and z1 (H1) in scratch, and returns the score in every lane.
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

// ---------------------------------------------------------------------------
// The score kernel, one body for every row source (rows.cuh): GatheredRows
// for the pre-gathered kernel, CorpusRows<R> for the index-fused one.
// Blocks of kDeepFMRowsPerBlock rows, one warp per row.
// ---------------------------------------------------------------------------

// f(x_r, q_r) for each row r; ``mask`` (nullable) is the adaptive prefix
// mask: a masked row scores -inf and its warp skips the FM and MLP, and a
// block whose rows are all masked skips the weight staging as well.
template <class Rows>
__global__ void __launch_bounds__(kDeepFMThreads)
deepfm_score_kernel(Rows rows, const float* __restrict__ query, int q_shared,
                    const unsigned char* __restrict__ mask, DeepFMWeights w,
                    float* __restrict__ out, int M, int D, int fm, int H0,
                    int H1) {
  extern __shared__ float sm[];
  const int row0 = blockIdx.x * kDeepFMRowsPerBlock;
  const int row1 = min(row0 + kDeepFMRowsPerBlock, M);
  if (mask != nullptr) {
    const int r = row0 + threadIdx.x;
    const int live = threadIdx.x < kDeepFMRowsPerBlock && r < row1 && mask[r];
    if (!__syncthreads_or(live)) {
      if (r < row1 && threadIdx.x < kDeepFMRowsPerBlock) out[r] = -INFINITY;
      return;
    }
  }
  const int dd = D - fm;
  const int K0 = 2 * dd;
  const DeepFMSmem s = deepfm_layout(sm, K0, H0, H1);
  deepfm_stage(s, w, K0, H0, H1);
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  const DeepFMScratch c = deepfm_scratch(sm, warp, K0, H0, H1, D);
  for (int r = row0 + warp; r < row1; r += nwarps) {
    __syncwarp();  // the previous row's scratch reads are done
    if (mask != nullptr && !mask[r]) {
      if (lane == 0) out[r] = -INFINITY;
      continue;
    }
    const float* x = rows.load(r, D, c.x, lane);
    const float* q = q_shared ? query : query + static_cast<size_t>(r) * D;
    const float val =
        deepfm_forward_warp(s, x, q, c.in, c.z0, c.z1, fm, dd, H0, H1, lane);
    if (lane == 0) out[r] = val;
  }
}

template <class Rows>
inline cudaError_t launch_deepfm_score(Rows rows, const void* query,
                                       int q_shared, const void* mask,
                                       const DeepFMWeights& w, void* out,
                                       int M, int D, int fm, int H0, int H1,
                                       void* stream) {
  if (M > 0) {
    const size_t smem = deepfm_smem_bytes(D, fm, H0, H1);
    allow_smem(deepfm_score_kernel<Rows>, smem);
    const int grid = (M + kDeepFMRowsPerBlock - 1) / kDeepFMRowsPerBlock;
    deepfm_score_kernel<Rows><<<grid, kDeepFMThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        rows, static_cast<const float*>(query), q_shared,
        static_cast<const unsigned char*>(mask), w, static_cast<float*>(out),
        M, D, fm, H0, H1);
  }
  return cudaGetLastError();
}

inline DeepFMWeights deepfm_weights(const void* w0, const void* b0,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* b2) {
  return {static_cast<const float*>(w0), static_cast<const float*>(b0),
          static_cast<const float*>(w1), static_cast<const float*>(b1),
          static_cast<const float*>(w2), static_cast<const float*>(b2)};
}

}  // namespace repro
