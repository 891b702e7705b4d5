// Index-fused MLP-measure value and analytic gradient df/dx: the engine's
// grad stage for ``--measure mlp`` when EngineOptions(fused=True).
//
// Replaces: src/repro/kernels/mlp_grad/kernel.py, mlp_grad_fused_pallas
// (scalar-prefetched frontier ids, a DMA gather and dequant of bt frontier
// rows per grid step, the forward and hand-derived backward, and the
// dequantized rows written out for the rank stage).
//
// What bounds it on an H100: at the serving shape (Q = 32 frontier rows,
// Dx = Dq = 40, MLP 80 -> 64 -> 64 -> 1) one call reads 32 corpus rows
// (5 KB at f32, less at bf16/int8), the queries and ~38 KB of weights,
// writes values, grads and rows (~10 KB), and does ~1 MFLOP: well under
// 0.1 us of bytes or FLOPs, so latency bounds it, as it bounds mlp_grad.
// The design is mlp_grad's kernel body (mlp_grad.cuh: a tile of rows per
// cluster) with the corpus row source (rows.cuh): each CTA gathers the
// tile's frontier rows by id (clamping -1 to 0) and dequantizes them into
// its shared memory with the rounding of CorpusStore.take (float32 rows
// are copied by cp.async as they are), runs its slice of the forward and
// backward on them, and CTA rank 0 writes the rows to ``x``, so the rows
// the rank stage consumes equal CorpusStore.take(ids) exactly and the
// engine does no gather of its own.
// At float32 residency the values and grads equal mlp_grad's bit for bit.
#include "mlp_grad.cuh"

extern "C" int mlp_grad_fused(const void* data, const void* scales,
                              const void* ids, int residency,
                              const void* query, int q_shared,
                              const void* const* ws, const void* const* bs,
                              const int* dims, int layers, void* vals,
                              void* grads, void* xout, int M, int Dx, int Dq,
                              void* stream) {
  using namespace repro;
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  const cudaError_t bad =
      with_corpus_rows(residency, data, scales, ids, [&](auto rows) {
        err = launch_mlp_grad_cluster(rows, query, q_shared, net, vals, grads,
                                      xout, M, stream);
      });
  return static_cast<int>(bad != cudaSuccess ? bad : err);
}
