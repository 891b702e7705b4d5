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
// The kernel body (deepfm_grad_kernel in deepfm.cuh) is shared with the
// index-fused form, deepfm_grad_fused.cu; here it reads pre-gathered rows.
#include "deepfm.cuh"

extern "C" int deepfm_grad_f32(const void* cand, const void* query,
                               int q_shared, const void* w0, const void* b0,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* vals, void* grads, int M,
                               int D, int fm, int H0, int H1, void* stream) {
  using namespace repro;
  return static_cast<int>(launch_deepfm_grad(
      GatheredRows{static_cast<const float*>(cand)}, query, q_shared,
      deepfm_weights(w0, b0, w1, b1, w2, b2), vals, grads, nullptr, M, D, fm,
      H0, H1, stream));
}
