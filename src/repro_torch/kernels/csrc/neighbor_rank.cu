// GUITAR neighbor ranking (paper Eq. 3 / Eq. 4) with the adaptive alpha*theta
// mask: the engine's rank stage.
//
// Replaces: src/repro/kernels/neighbor_rank/kernel.py, neighbor_rank_pallas
// (diffs = nvecs - x, their dot with df/dx, the angle or projection key,
// the per-lane best key theta and the alpha*theta band, in one VMEM pass).
//
// What bounds it on an H100: at the serving shape (Q = 32 lanes, B = 48
// neighbors, D = 40) the call reads ~250 KB of neighbor rows and does
// ~0.25 MFLOP: a fraction of a microsecond of memory time, so launch latency
// bounds it. Of the work it does, the neighbor-row read is the only real
// traffic. The design: one block per lane, one warp per neighbor row, lanes
// across D, so each neighbor row is one coalesced 160-byte read and is
// touched once; the dot and the squared norm of the diff are warp
// shuffles, |g| is computed by each warp from the lane's gradient row (no
// extra block barrier), keys go to shared memory, warp 0 reduces theta,
// and the mask is written after one barrier. Diffs, norms and dots never
// reach device memory.
// The kernel body (neighbor_rank_kernel in neighbor_rank.cuh) is shared
// with the index-fused form, neighbor_rank_fused.cu; here it reads
// pre-gathered rows.
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
