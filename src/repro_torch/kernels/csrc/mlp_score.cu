// MLP-measure candidate scoring: the engine's measure stage for the
// generic measure f(x, q) = sigmoid(MLP([x | q])) (``--measure mlp``).
//
// Replaces: src/repro/kernels/mlp_score/kernel.py, mlp_score_pallas (the
// Pallas kernel that scores a block of candidate rows: the concat and L
// small matmuls back to back on the MXU in VMEM, one sigmoid lane out).
//
// What bounds it on an H100: at the serving shape (M = Q*C = 256 rows,
// Dx = Dq = 40, MLP 80 -> 64 -> 64 -> 1) one call moves ~120 KB and does
// ~4.8 MFLOP, under 0.1 us of either bytes or fp32 FMA throughput, so
// latency bounds it: the launch, the weights' trip from L2 into shared
// memory and the chain of dependent steps per row. The one-warp-per-row
// body this replaces spent 5.9 of its 10.9 us staging the whole network
// per block of 8 rows in rounds of dependent loads, and 3.6 us in each
// lane's serial chain over K (tools/mlp_grad_split.py --kernel score).
// The design is the grad pairs' body (mlp_grad.cuh) forward only: a tile
// of 8 rows per thread-block cluster of 4 CTAs, each CTA staging only its
// column slices of the network (every copy in flight at once) and
// computing its units of each layer for the tile as one small matrix
// product (a warp's lanes on distinct rows, the K split over warps), the
// first layer's slices exchanged through distributed shared memory
// (st.async on mbarriers), the top layer's partial dots sent to CTA 0,
// the serving widths compiled in. A shared (Dq,) query is read in place
// for every row, never broadcast.
// The kernel body is shared with the index-fused form, mlp_score_fused.cu;
// here it reads pre-gathered rows.
#include "mlp_grad.cuh"

extern "C" int mlp_score_f32(const void* cand, const void* query,
                             int q_shared, const void* const* ws,
                             const void* const* bs, const int* dims,
                             int layers, void* out, int M, int Dx, int Dq,
                             void* stream) {
  using namespace repro;
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mlp_score_cluster(
      GatheredRows{static_cast<const float*>(cand)}, query, q_shared,
      nullptr, net, out, M, stream));
}

// The plan both score entries take for a net of these widths: info[0..3]
// = rows per cluster, CTAs per cluster, shared memory per CTA (bytes) and
// cudaOccupancyMaxActiveClusters of the pre-gathered form's kernel.
extern "C" int mlp_score_plan_info(const int* dims, int layers, int Dx,
                                   int Dq, int* info) {
  using namespace repro;
  const void* none[kMaxMLPLayers] = {};
  MLPNet net;
  if (!mlp_net(net, none, none, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      with_score_copy(net, [&](const MLPGradPlan& plan, auto copy) {
        using C = decltype(copy);
        info[0] = C::kTile;
        info[1] = plan.n;
        info[2] = static_cast<int>(sizeof(float) * plan.floats);
        return mlp_score_max_clusters<GatheredRows, typename C::Widths,
                                      C::kTile>(plan, info + 3);
      }));
}
