// DeepFM candidate scoring: the engine's measure stage.
//
// Replaces: src/repro/kernels/deepfm_score/kernel.py, deepfm_score_pallas
// (the Pallas kernel that scores a block of candidate rows with the FM dot
// and the two-hidden-layer MLP fused in VMEM).
//
// What bounds it on an H100: at the serving shape (M = Q*C = 256 rows,
// D = 40, hidden 64x64) one call moves ~116 KB and does ~4 MFLOP, well
// under a microsecond of either bytes or fp32 FMA throughput, so the call
// is bounded by launch latency and by the weight staging each block does.
// The design keeps that fixed cost small: one launch, blocks of 8 rows (one
// warp per row), the 34 KB of weights staged once per block into shared
// memory (bank-conflict-free padded rows, 16 loads in flight per thread),
// fp32 FMA on CUDA cores; activations never leave shared memory. A shared
// (D,) query is read in place for every row rather than broadcast into an
// (M, D) copy.
// Tensor cores (wgmma) and a persistent weight-resident block are later
// work: they pay only at much larger M.
#include "deepfm.cuh"

namespace repro {

__global__ void __launch_bounds__(kDeepFMThreads)
deepfm_score_kernel(const float* __restrict__ cand,
                    const float* __restrict__ query, int q_shared,
                    const float* __restrict__ w0, const float* __restrict__ b0,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ out, int M, int D, int fm, int H0,
                    int H1) {
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

  const int row0 = blockIdx.x * kDeepFMRowsPerBlock;
  const int row1 = min(row0 + kDeepFMRowsPerBlock, M);
  for (int r = row0 + warp; r < row1; r += nwarps) {
    __syncwarp();  // the previous row's scratch reads are done
    const float* x = cand + static_cast<size_t>(r) * D;
    const float* q = q_shared ? query : query + static_cast<size_t>(r) * D;
    const float val =
        deepfm_forward_warp(s, x, q, in, z0, z1, fm, dd, H0, H1, lane);
    if (lane == 0) out[r] = val;
  }
}

}  // namespace repro

extern "C" int deepfm_score_f32(const void* cand, const void* query,
                                int q_shared, const void* w0, const void* b0,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int M, int D,
                                int fm, int H0, int H1, void* stream) {
  using namespace repro;
  if (M > 0) {
    const int K0 = 2 * (D - fm);
    const size_t smem =
        sizeof(float) * (deepfm_weight_floats(K0, H0, H1) +
                         (kDeepFMThreads / kWarp) *
                             deepfm_scratch_floats(K0, H0, H1));
    allow_smem(deepfm_score_kernel, smem);
    const int grid = (M + kDeepFMRowsPerBlock - 1) / kDeepFMRowsPerBlock;
    deepfm_score_kernel<<<grid, kDeepFMThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cand), static_cast<const float*>(query),
        q_shared, static_cast<const float*>(w0),
        static_cast<const float*>(b0), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out), M, D, fm, H0,
        H1);
  }
  return static_cast<int>(cudaGetLastError());
}
