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
// 512 under adaptive c_max = 16, D = 40, fm = 8, deep part 64 -> 64 -> 64
// -> 1) one call reads M rows of 160 B (f32), 80 B (bf16) or 40 B + a 4 B
// scale (int8), M ids, the queries and 34 KB of weights, and does ~4.3
// MFLOP: under 0.1 us of either bytes or fp32 FMA, so latency bounds it,
// as it bounds deepfm_score.
// The design is deepfm_score's kernel body (mlp_grad.cuh, forward only,
// over the DeepFM input) with the corpus row source (rows.cuh): each CTA
// gathers the tile's candidate rows by id (clamping -1 padding to 0) and
// dequantizes them into its shared memory with the rounding of
// CorpusStore.take (float32 rows are copied by cp.async as they are), the
// FM columns beside the deep input as in deepfm_score, so at float32
// residency it equals deepfm_score bit for bit. The Pallas tile skip
// becomes: a masked row scores -inf, and a tile of rows that the mask
// covers entirely writes -inf and stages nothing. The (M, D) candidate
// block never exists in device memory.
#include "mlp_grad.cuh"

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
        err = launch_deepfm_score_cluster(rows, query, q_shared, mask, w, out,
                                          M, D, fm, H0, H1, stream);
      });
  return static_cast<int>(bad != cudaSuccess ? bad : err);
}
