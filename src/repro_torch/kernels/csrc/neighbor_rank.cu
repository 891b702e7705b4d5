// GUITAR neighbor ranking (paper Eq. 3 / Eq. 4) with the adaptive alpha*theta
// mask: the engine's rank stage.
//
// Replaces: src/repro/kernels/neighbor_rank/kernel.py, neighbor_rank_pallas
// (diffs = nvecs - x, their dot with df/dx, the angle or projection key,
// the per-lane best key theta and the alpha*theta band, in one VMEM pass).
//
// What bounds it on an H100: at the serving shape (Q = 32 lanes, B = 48
// neighbors, D = 40) the call reads ~250 KB of neighbor rows and does
// ~0.25 MFLOP: a fraction of a microsecond of memory time, so latency
// bounds it: the launch, then the chain of dependent steps inside. The
// design (neighbor_rank.cuh) keeps that chain short: a lane's rows are in
// flight at once (one CTA of 192 threads per lane at the serving shape,
// 16-byte cp.async of every row, one wait), each row summed by a group of
// 4 threads (10 columns each, 2 shuffles instead of the 5 of a warp),
// theta a warp reduction and one pass over the warps' partials, the
// serving width compiled in. Diffs, norms and dots never reach device memory.
// The kernel body is shared with the index-fused form,
// neighbor_rank_fused.cu; here it reads pre-gathered rows.
#include "neighbor_rank.cuh"

extern "C" int neighbor_rank_f32(const void* x, const void* g, const void* nv,
                                 const void* valid, void* key, void* mask,
                                 int Q, int B, int D, float alpha,
                                 int by_angle, void* stream) {
  using namespace repro;
  return static_cast<int>(launch_neighbor_rank(
      x, g, GatheredRows{static_cast<const float*>(nv)}, valid, key, mask, Q,
      B, D, alpha, by_angle, stream));
}

// The plan both entries launch for B neighbors of width D: info[0..8] =
// threads per row, lanes per CTA, rows per pass, columns per chunk, floats
// per staged row, threads per CTA, shared memory per CTA (bytes),
// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the pre-gathered form's
// kernel, and 1 if the copy compiled for the serving width (RankServing)
// runs it, 0 for the run-time-width copy.
extern "C" int neighbor_rank_plan_info(int B, int D, int* info) {
  using namespace repro;
  if (B <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const RankPlan p = neighbor_rank_plan(B, D);
  const bool serving = rank_copy_matches<RankServing>(p, D);
  const int fields[9] = {p.G,     p.lanes,   p.rows, p.cols, p.pitch,
                         p.threads, p.smem, 0,      serving};
  for (int i = 0; i < 9; ++i) info[i] = fields[i];
  return static_cast<int>(
      serving ? rank_blocks_per_sm<GatheredRows, RankServing>(p, info + 7)
              : rank_blocks_per_sm<GatheredRows, RankRuntime>(p, info + 7));
}
