// EmbeddingBag: per bag, the weighted sum of table rows; id -1 adds 0.
//
// Replaces: src/repro/kernels/embedding_bag/kernel.py, embedding_bag_pallas
// (the Pallas kernel that keeps the table in HBM, prefetches the bag ids
// into SMEM and accumulates a block of bags with one dynamic row load per
// (bag, slot)).
//
// What bounds it on an H100: bytes, and at serving batches the latency of
// the two dependent reads, id then row. Each valid id reads one random row
// (256 bytes for a float32 row of d = 64) of a table far larger than the
// 50 MB L2 (DLRM-RM2: 33.8M rows, 8.6 GB in float32), and there is one
// multiply-add per element read: arithmetic intensity ~0.25 FLOP/byte,
// against the ~20 at which the card's float32 FMA rate would bind. So the
// time is the bytes kept in flight: a thread with one row read outstanding
// leaves the memory system idle between its round trips.
//
// The first design walked a bag slot by slot: each slot's id was read by
// every lane of the bag's group, then the row at that id, added in before
// the next slot's id was read. A bag of 8 cost 8 serial (id, row) round
// trips; at L = 1 each thread had one 16-byte row read in flight. At
// DLRM-RM2's serve_p99 L = 8 the bf16 kernel took 89% of the float32 one's
// time on half the bytes.
//
// Design: a group of lanes owns a bag (the smallest power of two of lanes,
// up to a warp, that covers the row in 16-byte pieces: 16 lanes for a
// d = 64 float32 row, so two bags share a warp); the lanes split the row in
// 16-byte loads and each writes its slice of the sum in one 16-byte store.
// Each lane has ITEMS (bag, slot) items in flight at once: ITEMS slots of
// one bag, or for a short bag ITEMS / S bags of S slots (S = L rounded up
// to a power of two), so at L = 1 a group takes 4 bags. For each batch of
// items the group's lanes read the items' ids and weights once, each lane
// its own items, in coalesced loads (the warp's bags are consecutive rows
// of the (B, L) id array), and hand them round by __shfl_sync; then every
// valid item's row piece is loaded into registers, predicated on the id
// being in [0, R) (the padding -1, and out-of-contract ids, add nothing
// and are never read), before the first add. A batch thus costs one id
// round trip and one row round trip. The sums follow in slot order in
// float32 registers: product and add rounded separately (__fmul_rn,
// __fadd_rn), as the plain version does, then one rounding to the table's
// dtype, each bag stored as soon as its slots are summed. A bag longer
// than ITEMS loops over batches, the last one masked.
//
// ITEMS is 4. Measured on the H100 at DLRM-RM2's widths, 8 items a lane
// need more registers, so fewer warps fit, and ran slower at the serving
// shapes; 2 leave too few loads a thread. A batch of L = 1 small enough
// that one bag a group fills at most half the card (32 warps an SM:
// serve_p99 in bf16) takes ITEMS = 1 instead: every load is already in
// flight, and the shortest chain per thread wins.
//
// The Pallas kernel accumulates in the table's dtype (bf16 for a bf16
// table); this one sums in float32 and rounds once, which is closer to the
// exact sum. Bags are independent, so there is no reduction across blocks,
// and the ragged edge of B is masked, not padded. Row loads keep the normal
// caching: the small Criteo fields repeat rows that L2 serves.
#include "elem.cuh"

namespace repro {
namespace {

constexpr int kBagThreads = 128;

// VEC elements of a row, read in one 16-byte load when VEC * sizeof(T)
// is 16 (the caller guarantees the alignment), else element by element.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Piece {
  T e[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Piece<T, VEC> load_piece(const T* __restrict__ p) {
  Piece<T, VEC> r;
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    r = *reinterpret_cast<const Piece<T, VEC>*>(&raw);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) r.e[k] = __ldg(p + k);
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_piece(T* __restrict__ o,
                                            const float* acc) {
  Piece<T, VEC> r;
#pragma unroll
  for (int k = 0; k < VEC; ++k) r.e[k] = Elem<T>::from_f32(acc[k]);
  *reinterpret_cast<Piece<T, VEC>*>(o) = r;    // 16 bytes on the vector path
}

// log2 of the slots of a bag a group takes per batch: L rounded up to a
// power of two, at most ITEMS; the group's ITEMS items are ITEMS / slots
// bags.
inline int slot_shift(int L, int items) {
  int shift = 0;
  while ((1 << shift) < L && (2 << shift) <= items) ++shift;
  return shift;
}

// LANES lanes a bag; each lane has ITEMS (bag, slot) items' row pieces in
// flight: ITEMS >> shift bags of 1 << shift slots (one bag of ITEMS slots
// a batch when L > ITEMS).
template <typename T, int VEC, int LANES, int ITEMS>
__global__ void __launch_bounds__(kBagThreads)
    embedding_bag_kernel(const T* __restrict__ table, long long R, int d,
                         const void* __restrict__ idx, int idx64,
                         const T* __restrict__ w, T* __restrict__ out, int B,
                         int L, int slot_bits) {
  constexpr int kGroups = kWarp / LANES;                // bags side by side
  constexpr int kHeld = (ITEMS + LANES - 1) / LANES;    // ids a lane reads
  // slot_shift(L, 1) is 0: at ITEMS = 1 the compiler drops the shifts
  const int shift = ITEMS == 1 ? 0 : slot_bits;
  const int slots = 1 << shift;
  const int lane = threadIdx.x % kWarp;
  const int g = lane / LANES, p = lane % LANES;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
      kWarp * kGroups * (ITEMS >> shift);
  if (b0 >= B) return;                                  // the whole warp
  const int chunks = d / VEC;
  const bool one_batch = L <= ITEMS;
  const int batches = one_batch ? 1 : (L + ITEMS - 1) / ITEMS;
  // item e of the group: bag b0 + (e >> shift) * kGroups + g, slot
  // j0 + (e & (slots - 1)); lane p of the group reads the id and weight of
  // items p, p + LANES, ...
  for (int c0 = 0; c0 < chunks; c0 += LANES) {
    const int c = c0 + p;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int bt = 0; bt < batches; ++bt) {
      const int j0 = bt * ITEMS;
      // 1. ids and weights, coalesced across the warp
      long long held_id[kHeld];
      float held_w[kHeld];
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int e = p + k * LANES;
        const long long bag = b0 + (e >> shift) * kGroups + g;
        const int j = j0 + (e & (slots - 1));
        long long id = -1;
        float wt = 1.0f;
        if (e < ITEMS && bag < B && j < L) {
          const long long at = bag * L + j;
          id = idx64 ? __ldg(static_cast<const long long*>(idx) + at)
                     : static_cast<long long>(
                           __ldg(static_cast<const int*>(idx) + at));
          if (w) wt = Elem<T>::to_f32(__ldg(w + at));
          if (id >= R) id = -1;
        }
        held_id[k] = id;
        held_w[k] = wt;
      }
      // 2. every valid item's row piece in flight before any add
      Piece<T, VEC> row[ITEMS];
      unsigned ok = 0;
#pragma unroll
      for (int e = 0; e < ITEMS; ++e) {
        const long long id =
            __shfl_sync(kFull, held_id[e / LANES], g * LANES + e % LANES);
        if (id >= 0 && c < chunks) {
          ok |= 1u << e;
          row[e] = load_piece<T, VEC>(table + id * d +
                                      static_cast<long long>(c) * VEC);
        }
      }
      // 3. the sums in slot order; a bag that ends in this batch is stored
#pragma unroll
      for (int e = 0; e < ITEMS; ++e) {
        const float wt =
            __shfl_sync(kFull, held_w[e / LANES], g * LANES + e % LANES);
        if (ok >> e & 1u) {
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            acc[k] = __fadd_rn(acc[k],
                               __fmul_rn(Elem<T>::to_f32(row[e].e[k]), wt));
        }
        if (one_batch && (e & (slots - 1)) == slots - 1) {
          const long long bag = b0 + (e >> shift) * kGroups + g;
          if (bag < B && c < chunks)
            store_piece<T, VEC>(out + bag * d + c * VEC, acc);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
        }
      }
    }
    if (!one_batch && b0 + g < B && c < chunks)
      store_piece<T, VEC>(out + (b0 + g) * d + c * VEC, acc);
  }
}

template <typename T, int VEC, int LANES, int ITEMS>
cudaError_t launch_items(const T* table, long long R, int d, const void* idx,
                         int idx64, const T* w, T* out, int B, int L,
                         cudaStream_t stream) {
  const int shift = slot_shift(L, ITEMS);
  const long long bags_per_warp = (kWarp / LANES) * (ITEMS >> shift);
  const long long warps = (B + bags_per_warp - 1) / bags_per_warp;
  const unsigned blocks = static_cast<unsigned>(
      (warps * kWarp + kBagThreads - 1) / kBagThreads);
  embedding_bag_kernel<T, VEC, LANES, ITEMS>
      <<<blocks, kBagThreads, 0, stream>>>(table, R, d, idx, idx64, w, out,
                                           B, L, shift);
  return cudaGetLastError();
}

// ITEMS of a launch (see the header): 1 for an L = 1 batch whose grid at
// one bag a group fits in 32 warps an SM, else 4.
inline int choose_items(int B, int L, int lanes) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long long groups_per_warp = kWarp / lanes;
  const long long warps = (B + groups_per_warp - 1) / groups_per_warp;
  return L <= 1 && warps <= 32LL * sms ? 1 : 4;
}

template <typename T, int VEC, int LANES>
cudaError_t launch_lanes(const T* table, long long R, int d, const void* idx,
                         int idx64, const T* w, T* out, int B, int L,
                         cudaStream_t stream) {
  if (choose_items(B, L, LANES) == 1)
    return launch_items<T, VEC, LANES, 1>(table, R, d, idx, idx64, w, out, B,
                                          L, stream);
  return launch_items<T, VEC, LANES, 4>(table, R, d, idx, idx64, w, out, B, L,
                                        stream);
}

template <typename T, int VEC>
cudaError_t launch_vec(const T* table, long long R, int d, const void* idx,
                       int idx64, const T* w, T* out, int B, int L,
                       cudaStream_t stream) {
  const int chunks = d / VEC;
  int lanes = 1;
  while (lanes < chunks && lanes < kWarp) lanes *= 2;
  switch (lanes) {
    case 1:
      return launch_lanes<T, VEC, 1>(table, R, d, idx, idx64, w, out, B, L,
                                     stream);
    case 2:
      return launch_lanes<T, VEC, 2>(table, R, d, idx, idx64, w, out, B, L,
                                     stream);
    case 4:
      return launch_lanes<T, VEC, 4>(table, R, d, idx, idx64, w, out, B, L,
                                     stream);
    case 8:
      return launch_lanes<T, VEC, 8>(table, R, d, idx, idx64, w, out, B, L,
                                     stream);
    case 16:
      return launch_lanes<T, VEC, 16>(table, R, d, idx, idx64, w, out, B, L,
                                      stream);
    default:
      return launch_lanes<T, VEC, 32>(table, R, d, idx, idx64, w, out, B, L,
                                      stream);
  }
}

template <typename T>
cudaError_t launch(const void* table, long long R, int d, const void* idx,
                   int idx64, const void* w, void* out, int B, int L,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (B == 0) return cudaGetLastError();
  const bool vec = d % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* t = static_cast<const T*>(table);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (vec)
    return launch_vec<T, kVec>(t, R, d, idx, idx64, wt, o, B, L, stream);
  return launch_vec<T, 1>(t, R, d, idx, idx64, wt, o, B, L, stream);
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
