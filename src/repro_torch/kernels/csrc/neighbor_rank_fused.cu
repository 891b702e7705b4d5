// Index-fused GUITAR neighbor ranking (paper Eq. 3 / Eq. 4) with the
// adaptive alpha*theta mask: the engine's rank stage when
// EngineOptions(fused=True).
//
// Replaces: src/repro/kernels/neighbor_rank_fused/kernel.py,
// neighbor_rank_fused_pallas (scalar-prefetched (Q, B) neighbor ids, a
// double-buffered DMA gather of the neighbor rows, dequant in VMEM and the
// raw angle or projection keys; the JAX wrapper applies validity and the
// alpha*theta band afterwards, mask_from_key). Here the keys and the mask
// come out of one launch, as from neighbor_rank.cu.
//
// What bounds it on an H100: at the serving shape (Q = 32 lanes, B = 48
// neighbors, D = 40) the call reads 1,536 corpus rows: 245 KB at f32,
// 123 KB at bf16, 61 KB plus 6 KB of scales at int8, plus 12 KB of ids,
// and does ~0.25 MFLOP: under 0.1 us of memory time, so latency bounds
// it. The design is neighbor_rank's kernel body (neighbor_rank.cuh) with
// the corpus row source (rows.cuh): a lane's 48 ids are read first, in
// one coalesced pass into shared memory (clamping -1 to 0), then every
// row of the lane is in flight at once, by cp.async: float32 rows as
// 16-byte copies, bf16 and int8 rows as stored, 4 bytes a copy, and each
// int8 row's scale beside them (not after them); each element is
// dequantized as it is read, rounded with __fmul_rn before the
// subtraction of x so that the diff rounds as CorpusStore.take followed
// by the subtraction does.
// The (Q, B, D) neighbor block never exists in device memory. At float32
// residency the staged rows are the unfused kernel's, so the keys and
// mask equal its bit for bit.
#include "neighbor_rank.cuh"

extern "C" int neighbor_rank_fused(const void* x, const void* g,
                                   const void* data, const void* scales,
                                   const void* ids, int residency,
                                   const void* valid, void* key, void* mask,
                                   int Q, int B, int D, float alpha,
                                   int by_angle, void* stream) {
  using namespace repro;
  cudaError_t err = cudaSuccess;
  const cudaError_t bad =
      with_corpus_rows(residency, data, scales, ids, [&](auto rows) {
        err = launch_neighbor_rank(x, g, rows, valid, key, mask, Q, B, D,
                                   alpha, by_angle, stream);
      });
  return static_cast<int>(bad != cudaSuccess ? bad : err);
}
