// DeepFM value and analytic gradient df/dx: the engine's grad stage.
//
// Replaces: src/repro/kernels/deepfm_grad/kernel.py, deepfm_grad_pallas
// (forward with the pre-activations kept in VMEM, then the hand-derived
// backward: sigmoid' on the logit, back through W2, W1 and W0 with the ReLU
// masks, and the FM term g_logit * q_fm).
//
// What bounds it on an H100: at the serving shape (Q = 32 frontier rows,
// D = 40, fm = 8, deep input 64, hidden 64x64) one call moves ~50 KB
// (mostly the weights) and does ~1 MFLOP, well under 0.1 us of either;
// latency bounds it: the launch, the weights' trip from L2 into shared
// memory and the chain of dependent steps per row. The one-warp-per-row
// body this replaces staged the whole network per block of 8 rows in
// rounds of dependent loads, then ran each row's forward and backward as
// 64-long FMA chains per lane (PERF.md: the parent's split).
// The design is the MLP grad pair's body (mlp_grad.cuh) over the DeepFM
// input: the deep part [q_deep | x_deep] -> H0 -> H1 -> 1 is a tile of 4
// rows per cluster of 8 CTAs, each CTA staging and computing its slices
// of every layer both ways, the slices exchanged through distributed
// shared memory (st.async on mbarriers), the serving widths compiled in;
// the FM term is local to a row (every CTA adds <x_fm, q_fm> to its
// tile's logits, CTA 0 writes g_logit * q_fm). Only the x part of the deep
// input's cotangent is computed, from W0's rows [dd, 2 dd).
// The kernel body is shared with the index-fused form,
// deepfm_grad_fused.cu; here it reads pre-gathered rows.
#include "mlp_grad.cuh"

extern "C" int deepfm_grad_f32(const void* cand, const void* query,
                               int q_shared, const void* w0, const void* b0,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* vals, void* grads, int M,
                               int D, int fm, int H0, int H1, void* stream) {
  using namespace repro;
  return static_cast<int>(launch_deepfm_grad_cluster(
      GatheredRows{static_cast<const float*>(cand)}, query, q_shared,
      deepfm_weights(w0, b0, w1, b1, w2, b2), vals, grads, nullptr, M, D, fm,
      H0, H1, stream));
}
