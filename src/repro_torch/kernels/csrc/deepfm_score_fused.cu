// Index-fused DeepFM candidate scoring: the engine's measure stage when
// EngineOptions(fused=True).
//
// Replaces: src/repro/kernels/deepfm_score_fused/kernel.py,
// deepfm_score_fused_pallas (scalar-prefetched candidate ids, a
// double-buffered DMA gather of bt corpus rows per grid step, dequant in
// VMEM, the DeepFM score, and a skip of the MLP for tiles whose rows the
// adaptive mask covers entirely).
//
// What bounds it on an H100: at the serving shape (M = Q*C = 256 rows, or
// 512 under adaptive c_max = 16, D = 40, hidden 64x64) one call reads
// M rows of 160 B (f32), 80 B (bf16) or 40 B + a 4 B scale (int8), M ids,
// the queries and 34 KB of weights, and does ~4 MFLOP: under 0.1 us of
// either bytes or fp32 FMA, so launch latency and the per-block weight
// staging bound it, as they bound deepfm_score.
// The design is deepfm_score's kernel body (deepfm.cuh) with another row
// source (rows.cuh): each warp gathers its candidate row by id (clamping
// -1 padding to 0), dequantizes it into its shared-memory slice with the
// rounding of CorpusStore.take, and runs the same forward on it. At
// float32 residency that is the unfused kernel's arithmetic on the same
// values, so the two agree bit for bit. The mask is the Hopper form of the
// Pallas tile skip: a masked row writes -inf and its warp skips the FM and
// MLP, and a block of 8 rows that are all masked skips the weight staging
// too. Neither the (M, D) candidate block nor its float32 copy ever
// exists in device memory.
#include "deepfm.cuh"

extern "C" int deepfm_score_fused(const void* data, const void* scales,
                                  const void* ids, int residency,
                                  const void* query, int q_shared,
                                  const void* mask, const void* w0,
                                  const void* b0, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int M, int D,
                                  int fm, int H0, int H1, void* stream) {
  using namespace repro;
  const DeepFMWeights w = deepfm_weights(w0, b0, w1, b1, w2, b2);
  cudaError_t err = cudaSuccess;
  const cudaError_t bad =
      with_corpus_rows(residency, data, scales, ids, [&](auto rows) {
        err = launch_deepfm_score(rows, query, q_shared, mask, w, out, M, D,
                                  fm, H0, H1, stream);
      });
  return static_cast<int>(bad != cudaSuccess ? bad : err);
}
