// Index-fused DeepFM value and analytic gradient df/dx: the engine's grad
// stage when EngineOptions(fused=True).
//
// Replaces: src/repro/kernels/deepfm_grad_fused/kernel.py,
// deepfm_grad_fused_pallas (scalar-prefetched frontier ids, a DMA gather
// and dequant of the frontier rows, the forward and hand-derived backward,
// and the dequantized rows written out for the rank stage).
//
// What bounds it on an H100: at the serving shape (Q = 32 frontier rows,
// D = 40, hidden 64x64) one call reads 32 corpus rows (5 KB at f32, less
// at bf16/int8), the queries and 34 KB of weights, writes values, grads
// and rows (~10 KB), and does ~1 MFLOP: well under 0.1 us of bytes or
// FLOPs, so latency bounds it, as it bounds deepfm_grad.
// The design is deepfm_grad's kernel body (mlp_grad.cuh over the DeepFM
// input: a tile of rows per cluster) with the corpus row source
// (rows.cuh): each CTA gathers the tile's frontier rows by id (clamping -1
// to 0) and dequantizes them into its shared memory with the rounding of
// CorpusStore.take (float32 rows are copied by cp.async as they are), runs
// its slice of the forward and backward on them, and CTA rank 0 writes the
// D-wide rows to ``x``, so the rows the rank stage consumes equal
// CorpusStore.take(ids) exactly and the engine does no gather of its own.
// At float32 residency the values and grads equal deepfm_grad's bit for
// bit.
#include "mlp_grad.cuh"

extern "C" int deepfm_grad_fused(const void* data, const void* scales,
                                 const void* ids, int residency,
                                 const void* query, int q_shared,
                                 const void* w0, const void* b0,
                                 const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* vals,
                                 void* grads, void* xout, int M, int D,
                                 int fm, int H0, int H1, void* stream) {
  using namespace repro;
  const DeepFMWeights w = deepfm_weights(w0, b0, w1, b1, w2, b2);
  cudaError_t err = cudaSuccess;
  const cudaError_t bad =
      with_corpus_rows(residency, data, scales, ids, [&](auto rows) {
        err = launch_deepfm_grad_cluster(rows, query, q_shared, w, vals,
                                         grads, xout, M, D, fm, H0, H1,
                                         stream);
      });
  return static_cast<int>(bad != cudaSuccess ? bad : err);
}
