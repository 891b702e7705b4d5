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
// the weights) and does ~1 MFLOP, well under 0.1 us of either; latency
// bounds it: the launch, the weights' trip from L2 into shared memory and
// the chain of dependent steps per row. The one-warp-per-row body this
// replaces spent 5.8 of its 13.9 us staging the whole network per block of
// 8 rows in some eight dependent rounds of loads, and 6.8 us in each
// row's ~400-step chain of shared loads and FMAs (tools/mlp_grad_split.py).
// The design (mlp_grad.cuh) treats a tile of 4 rows as one small matrix
// product per layer, split by units over a cluster of 8 CTAs: each CTA
// stages its slices of the network with every copy in flight at once and
// computes its units in both directions, the slices exchanged through
// distributed shared memory (st.async on mbarriers), so that the chain of
// dependent steps per row is short. Only the x part of the input's
// cotangent is computed.
// The kernel body is shared with the index-fused form, mlp_grad_fused.cu;
// here it reads pre-gathered rows.
#include "mlp_grad.cuh"

extern "C" int mlp_grad_f32(const void* cand, const void* query,
                            int q_shared, const void* const* ws,
                            const void* const* bs, const int* dims,
                            int layers, void* vals, void* grads, int M,
                            int Dx, int Dq, void* stream) {
  using namespace repro;
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mlp_grad_cluster(
      GatheredRows{static_cast<const float*>(cand)}, query, q_shared, net,
      vals, grads, nullptr, M, stream));
}
