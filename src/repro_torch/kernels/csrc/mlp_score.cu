// MLP-measure candidate scoring: the engine's measure stage for the
// generic measure f(x, q) = sigmoid(MLP([x | q])) (``--measure mlp``).
//
// Replaces: src/repro/kernels/mlp_score/kernel.py, mlp_score_pallas (the
// Pallas kernel that scores a block of candidate rows: the concat and L
// small matmuls back to back on the MXU in VMEM, one sigmoid lane out).
//
// What bounds it on an H100: at the serving shape (M = Q*C = 256 rows,
// Dx = Dq = 40, MLP 80 -> 64 -> 64 -> 1) one call moves ~120 KB and does
// ~4.8 MFLOP, under 0.1 us of either bytes or fp32 FMA throughput, so the
// call is bounded by launch latency and by the weight staging each block
// does, as deepfm_score is. The design is deepfm_score's: one launch,
// blocks of 8 rows (one warp per row), the ~38 KB of weights staged once
// per block into bank-conflict-free padded shared rows, fp32 FMA on CUDA
// cores, activations only in shared memory. The depth is a runtime value
// (up to kMaxMLPLayers), so one kernel serves every MLP measure. A shared
// (Dq,) query is read in place for every row, never broadcast.
// Tensor cores (wgmma) pay only at much larger M: later work.
// The kernel body (mlp_score_kernel in mlp.cuh) is shared with the
// index-fused form, mlp_score_fused.cu; here it reads pre-gathered rows.
#include "mlp.cuh"

extern "C" int mlp_score_f32(const void* cand, const void* query,
                             int q_shared, const void* const* ws,
                             const void* const* bs, const int* dims,
                             int layers, void* out, int M, int Dx, int Dq,
                             void* stream) {
  using namespace repro;
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mlp_score(
      GatheredRows{static_cast<const float*>(cand)}, query, q_shared,
      nullptr, net, out, M, stream));
}
