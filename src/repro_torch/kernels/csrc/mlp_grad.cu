// MLP-measure value and analytic gradient df/dx: the engine's grad stage
// for ``--measure mlp``.
//
// Replaces: src/repro/kernels/mlp_grad/kernel.py, mlp_grad_pallas (the
// forward with every pre-activation kept in VMEM, then the hand-derived
// backward: sigmoid' on the logit, transposed matmuls against
// pre-transposed weights with the ReLU masks, sliced to the first d_x
// inputs).
//
// What bounds it on an H100: at the serving shape (Q = 32 frontier rows,
// Dx = Dq = 40, MLP 80 -> 64 -> 64 -> 1) one call moves ~60 KB (mostly
// the weights) and does ~1 MFLOP; like the score kernel it is bounded by
// launch latency and the per-block weight staging, not by bytes or FLOPs.
// The design is the score kernel's plus the backward in the same warp:
// every z_i stays in the warp's shared scratch, and the padded row stride
// lets the transposed products (lane v reads row v of W_i across its
// columns, lane k row k of W_0) run free of bank conflicts on the weights
// as staged, so the Pallas kernel's transposed copies (_wt_rows) are not
// needed. Only the x part of the input's cotangent is computed.
// The kernel body (mlp_grad_kernel in mlp.cuh) is shared with the
// index-fused form, mlp_grad_fused.cu; here it reads pre-gathered rows.
#include "mlp.cuh"

extern "C" int mlp_grad_f32(const void* cand, const void* query,
                            int q_shared, const void* const* ws,
                            const void* const* bs, const int* dims,
                            int layers, void* vals, void* grads, int M,
                            int Dx, int Dq, void* stream) {
  using namespace repro;
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mlp_grad(
      GatheredRows{static_cast<const float*>(cand)}, query, q_shared, net,
      vals, grads, nullptr, M, stream));
}
