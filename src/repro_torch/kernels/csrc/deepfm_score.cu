// DeepFM candidate scoring: the engine's measure stage.
//
// Replaces: src/repro/kernels/deepfm_score/kernel.py, deepfm_score_pallas
// (the Pallas kernel that scores a block of candidate rows with the FM dot
// and the two-hidden-layer MLP fused in VMEM).
//
// What bounds it on an H100: at the serving shape (M = Q*C = 256 rows,
// D = 40, fm = 8, deep part 64 -> 64 -> 64 -> 1) one call moves ~116 KB
// and does ~4.3 MFLOP, under 0.1 us of either bytes or fp32 FMA
// throughput, so latency bounds it: the launch, the weights' trip from L2
// into shared memory and the chain of dependent steps per row. The
// one-warp-per-row body this replaces staged the whole 34 KB network per
// block of 8 rows in rounds of dependent loads, then ran each row's
// layers as 64-long FMA chains per lane (tools/mlp_grad_split.py
// --measure deepfm --kernel score; PERF.md).
// The design is the MLP score's body (mlp_grad.cuh, forward only) over
// the DeepFM input: the deep part [q_deep | x_deep] -> H0 -> H1 -> 1 as a
// tile of 8 rows per thread-block cluster of 4 CTAs, each CTA staging
// only its column slices of the network (every copy in flight at once)
// and computing its units of each layer for the tile as one small matrix
// product (a warp's lanes on distinct rows, the K split over warps), the
// first layer's slices exchanged through distributed shared memory
// (st.async on mbarriers), the top layer's partial dots sent to CTA 0,
// which adds them in rank order, then the bias, then the row's FM term
// <x_fm, q_fm> (computed while it waits, from the tile's x[:fm] and
// q[:fm] staged beside the deep input), the serving widths compiled in.
// A shared (D,) query is read in place for every row, never broadcast.
// The kernel body is shared with the index-fused form,
// deepfm_score_fused.cu; here it reads pre-gathered rows.
#include "mlp_grad.cuh"

extern "C" int deepfm_score_f32(const void* cand, const void* query,
                                int q_shared, const void* w0, const void* b0,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int M, int D,
                                int fm, int H0, int H1, void* stream) {
  using namespace repro;
  return static_cast<int>(launch_deepfm_score_cluster(
      GatheredRows{static_cast<const float*>(cand)}, query, q_shared, nullptr,
      deepfm_weights(w0, b0, w1, b1, w2, b2), out, M, D, fm, H0, H1,
      stream));
}

// The plan both score entries take for a net of these widths: info[0..4]
// = rows per cluster, CTAs per cluster, shared memory per CTA (bytes),
// cudaOccupancyMaxActiveClusters of the pre-gathered form's kernel, and 1
// if the copy compiled for the serving widths (DeepFMScoreServing) runs
// it, 0 for the run-time-width copy.
extern "C" int deepfm_score_plan_info(int D, int fm, int H0, int H1,
                                      int* info) {
  using namespace repro;
  return static_cast<int>(with_deepfm_score_copy(
      DeepFMWeights{}, D, fm, H0, H1,
      [&](const MLPNet&, const MLPGradPlan& plan, const mlpg::DeepFMInput&,
          auto copy) {
        using C = decltype(copy);
        info[0] = C::kTile;
        info[1] = plan.n;
        info[2] = static_cast<int>(sizeof(float) * plan.floats);
        info[4] = std::is_same_v<typename C::Widths, DeepFMScoreServing>;
        return mlp_score_max_clusters<GatheredRows, typename C::Widths,
                                      C::kTile, mlpg::DeepFMInput>(plan,
                                                                   info + 3);
      }));
}
