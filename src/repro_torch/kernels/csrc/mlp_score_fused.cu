// Index-fused MLP-measure candidate scoring: the engine's measure stage
// for ``--measure mlp`` when EngineOptions(fused=True).
//
// Replaces: src/repro/kernels/mlp_score/kernel.py, mlp_score_fused_pallas
// (scalar-prefetched candidate ids, a double-buffered DMA gather of bt
// corpus rows per grid step, dequant in VMEM, the MLP score, and a skip of
// the matmuls for tiles whose rows the adaptive mask covers entirely).
//
// What bounds it on an H100: at the serving shape (M = Q*C = 256 rows, or
// 512 under adaptive c_max = 16, Dx = Dq = 40, MLP 80 -> 64 -> 64 -> 1)
// one call reads M rows of 160 B (f32), 80 B (bf16) or 40 B + a 4 B scale
// (int8), M ids, the queries and ~38 KB of weights, and does ~4.8 MFLOP:
// under 0.1 us of either bytes or fp32 FMA, so latency bounds it, as it
// bounds mlp_score.
// The design is mlp_score's kernel body (mlp_grad.cuh, forward only) with
// the corpus row source (rows.cuh): each CTA gathers the tile's candidate
// rows by id (clamping -1 padding to 0) and dequantizes them into its
// shared memory with the rounding of CorpusStore.take (float32 rows are
// copied by cp.async as they are), so at float32 residency it equals
// mlp_score bit for bit. The Pallas tile skip becomes: a masked row
// scores -inf, and a tile of rows that the mask covers entirely writes
// -inf and stages nothing. The (M, Dx) candidate block never exists in
// device memory.
#include "mlp_grad.cuh"

extern "C" int mlp_score_fused(const void* data, const void* scales,
                               const void* ids, int residency,
                               const void* query, int q_shared,
                               const void* mask, const void* const* ws,
                               const void* const* bs, const int* dims,
                               int layers, void* out, int M, int Dx, int Dq,
                               void* stream) {
  using namespace repro;
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  const cudaError_t bad =
      with_corpus_rows(residency, data, scales, ids, [&](auto rows) {
        err = launch_mlp_score_cluster(rows, query, q_shared, mask, net, out,
                                       M, stream);
      });
  return static_cast<int>(bad != cudaSuccess ? bad : err);
}
