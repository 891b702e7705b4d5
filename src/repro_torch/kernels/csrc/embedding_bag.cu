// EmbeddingBag: per bag, the weighted sum of table rows; id -1 adds 0.
//
// Replaces: src/repro/kernels/embedding_bag/kernel.py, embedding_bag_pallas
// (the Pallas kernel that keeps the table in HBM, prefetches the bag ids
// into SMEM and accumulates a block of bags with one dynamic row load per
// (bag, slot)).
//
// What bounds it on an H100: bytes. Each valid id reads one random row
// (256 bytes for a float32 row of d = 64) of a table far larger than the
// 50 MB L2 (DLRM-RM2: 33.8M rows, 8.6 GB in float32), and there is one
// multiply-add per element read: arithmetic intensity ~0.25 FLOP/byte,
// against the ~20 at which the card's float32 FMA rate would bind.
//
// Design: a group of lanes owns one bag (the smallest power of two of lanes,
// up to a warp, that covers the row in 16-byte pieces: 16 lanes for a d = 64
// float32 row, so two bags share a warp instead of half of it idling); the
// lanes split the row in 16-byte loads, so one row is read in as few
// transactions as its bytes allow, and each lane writes its slice of the sum
// in one 16-byte store. A group reads each of its bag's ids once per row
// chunk (the group's lanes read the same id, one transaction), skips an id
// outside [0, R) (the padding -1, and out-of-contract ids, so nothing
// outside the table is ever read), and keeps the sum in float32 registers:
// product and add rounded separately (__fmul_rn, __fadd_rn), slot by slot,
// as the plain version does, then one rounding to the table's dtype. The
// Pallas kernel accumulates in the table's dtype (bf16 for a bf16 table);
// this one sums in float32 and rounds once, which is closer to the exact
// sum. Bags are independent, so there is no reduction across blocks, and the
// ragged edge of B is masked, not padded.
#include "elem.cuh"

namespace repro {
namespace {

constexpr int kBagThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kBagThreads)
    embedding_bag_kernel(const T* __restrict__ table, long long R, int d,
                         const void* __restrict__ idx, int idx64,
                         const T* __restrict__ w, T* __restrict__ out, int B,
                         int L, int lanes_per_bag) {
  const long long gtid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long bag = gtid / lanes_per_bag;
  const int lane = static_cast<int>(gtid % lanes_per_bag);
  if (bag >= B) return;
  const int chunks = d / VEC;
  const long long base = bag * L;
  for (int c = lane; c < chunks; c += lanes_per_bag) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int j = 0; j < L; ++j) {
      const long long id =
          idx64 ? __ldg(static_cast<const long long*>(idx) + base + j)
                : static_cast<long long>(
                      __ldg(static_cast<const int*>(idx) + base + j));
      if (id < 0 || id >= R) continue;
      const float wj = w ? Elem<T>::to_f32(__ldg(w + base + j)) : 1.0f;
      float v[VEC];
      load_f32<T, VEC>(table + id * d + c * VEC, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k],
                                                       __fmul_rn(v[k], wj));
    }
    T* o = out + bag * d + c * VEC;
    if constexpr (VEC * sizeof(T) == 16) {   // one 16-byte store
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) e[k] = Elem<T>::from_f32(acc[k]);
      *reinterpret_cast<uint4*>(o) = raw;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) o[k] = Elem<T>::from_f32(acc[k]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* table, long long R, int d, const void* idx,
                   int idx64, const void* w, void* out, int B, int L,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int chunks = vec ? d / kVec : d;
  int lanes = 1;
  while (lanes < chunks && lanes < kWarp) lanes *= 2;
  const long long threads = static_cast<long long>(B) * lanes;
  const unsigned blocks =
      static_cast<unsigned>((threads + kBagThreads - 1) / kBagThreads);
  if (B == 0) return cudaGetLastError();
  const T* t = static_cast<const T*>(table);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (vec)
    embedding_bag_kernel<T, kVec><<<blocks, kBagThreads, 0, stream>>>(
        t, R, d, idx, idx64, wt, o, B, L, lanes);
  else
    embedding_bag_kernel<T, 1><<<blocks, kBagThreads, 0, stream>>>(
        t, R, d, idx, idx64, wt, o, B, L, lanes);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// table (R, d) in dtype (0 float32, 1 bfloat16); idx (B, L) int32 or, with
// idx64, int64; w (B, L) in the table's dtype or NULL (all ones); out
// (B, d) in the table's dtype. Returns cudaGetLastError().
extern "C" int embedding_bag(const void* table, int dtype, long long R,
                             int d, const void* idx, int idx64,
                             const void* w, void* out, int B, int L,
                             void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDTypeF32)
    return static_cast<int>(
        launch<float>(table, R, d, idx, idx64, w, out, B, L, s));
  if (dtype == kDTypeBF16)
    return static_cast<int>(
        launch<uint16_t>(table, R, d, idx, idx64, w, out, B, L, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
