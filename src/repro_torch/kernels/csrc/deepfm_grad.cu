// DeepFM value and analytic gradient df/dx: the engine's grad stage.
//
// Replaces: src/repro/kernels/deepfm_grad/kernel.py, deepfm_grad_pallas
// (forward with the pre-activations kept in VMEM, then the hand-derived
// backward: sigmoid' on the logit, back through W2, W1 and W0 with the ReLU
// masks, and the FM term g_logit * q_fm).
//
// What bounds it on an H100: at the serving shape (Q = 32 frontier rows,
// D = 40, hidden 64x64) one call moves ~50 KB and does ~2 MFLOP; like the
// score kernel it is bounded by launch latency and per-block weight
// staging, not by bytes or FLOPs. The design is the score kernel's (weights
// staged once per block in padded shared rows, one warp per row) plus the
// backward in the same warp: z0 and z1 stay in the warp's shared scratch,
// and the padded row stride makes the transposed products (lane v reads
// column v of W1, lane k reads row k of W0) free of bank conflicts, so no
// transposed copy of the weights is needed. Only the x half of the deep
// input's cotangent is computed; the q half is never used.
#include "deepfm.cuh"

namespace repro {

__global__ void __launch_bounds__(kDeepFMThreads)
deepfm_grad_kernel(const float* __restrict__ cand,
                   const float* __restrict__ query, int q_shared,
                   const float* __restrict__ w0, const float* __restrict__ b0,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   float* __restrict__ vals, float* __restrict__ grads, int M,
                   int D, int fm, int H0, int H1) {
  extern __shared__ float sm[];
  const int dd = D - fm;
  const int K0 = 2 * dd;
  const DeepFMSmem s = deepfm_layout(sm, K0, H0, H1);
  deepfm_stage(s, w0, b0, w1, b1, w2, b2, K0, H0, H1);
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  float* scratch = sm + deepfm_weight_floats(K0, H0, H1) +
                   warp * deepfm_scratch_floats(K0, H0, H1);
  float* in = scratch;
  float* z0 = in + K0;
  float* z1 = z0 + H0;
  float* g1 = z1 + H1;
  float* g0 = g1 + H1;

  const int row0 = blockIdx.x * kDeepFMRowsPerBlock;
  const int row1 = min(row0 + kDeepFMRowsPerBlock, M);
  for (int r = row0 + warp; r < row1; r += nwarps) {
    __syncwarp();  // the previous row's scratch reads are done
    const float* x = cand + static_cast<size_t>(r) * D;
    const float* q = q_shared ? query : query + static_cast<size_t>(r) * D;
    const float val =
        deepfm_forward_warp(s, x, q, in, z0, z1, fm, dd, H0, H1, lane);
    const float g_logit = val * (1.f - val);
    for (int u = lane; u < H1; u += kWarp)
      g1[u] = z1[u] > 0.f ? g_logit * s.w2[u] : 0.f;
    __syncwarp();
    for (int v = lane; v < H0; v += kWarp) {
      const float* row = s.W1 + v * (H1 + 1);
      float a = 0.f;
      for (int u = 0; u < H1; ++u) a = fmaf(g1[u], row[u], a);
      g0[v] = z0[v] > 0.f ? a : 0.f;
    }
    __syncwarp();
    float* gr = grads + static_cast<size_t>(r) * D;
    for (int k = lane; k < dd; k += kWarp) {
      const float* row = s.W0 + (dd + k) * (H0 + 1);
      float a = 0.f;
      for (int v = 0; v < H0; ++v) a = fmaf(g0[v], row[v], a);
      gr[fm + k] = a;
    }
    for (int k = lane; k < fm; k += kWarp) gr[k] = g_logit * q[k];
    if (lane == 0) vals[r] = val;
  }
}

}  // namespace repro

extern "C" int deepfm_grad_f32(const void* cand, const void* query,
                               int q_shared, const void* w0, const void* b0,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* vals, void* grads, int M,
                               int D, int fm, int H0, int H1, void* stream) {
  using namespace repro;
  if (M > 0) {
    const int K0 = 2 * (D - fm);
    const size_t smem =
        sizeof(float) * (deepfm_weight_floats(K0, H0, H1) +
                         (kDeepFMThreads / kWarp) *
                             deepfm_scratch_floats(K0, H0, H1));
    allow_smem(deepfm_grad_kernel, smem);
    const int grid = (M + kDeepFMRowsPerBlock - 1) / kDeepFMRowsPerBlock;
    deepfm_grad_kernel<<<grid, kDeepFMThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cand), static_cast<const float*>(query),
        q_shared, static_cast<const float*>(w0),
        static_cast<const float*>(b0), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(vals),
        static_cast<float*>(grads), M, D, fm, H0, H1);
  }
  return static_cast<int>(cudaGetLastError());
}
