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
// The kernel body (deepfm_score_kernel in deepfm.cuh) is shared with the
// index-fused form, deepfm_score_fused.cu; here it reads pre-gathered rows.
#include "deepfm.cuh"

extern "C" int deepfm_score_f32(const void* cand, const void* query,
                                int q_shared, const void* w0, const void* b0,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int M, int D,
                                int fm, int H0, int H1, void* stream) {
  using namespace repro;
  return static_cast<int>(launch_deepfm_score(
      GatheredRows{static_cast<const float*>(cand)}, query, q_shared, nullptr,
      deepfm_weights(w0, b0, w1, b1, w2, b2), out, M, D, fm, H0, H1,
      stream));
}
