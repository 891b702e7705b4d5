// Row sources of the port's kernels: where a kernel's float32 rows come
// from. One kernel body serves both the pre-gathered form (rows already
// float32 in device memory) and the index-fused form (rows gathered by id
// from the resident corpus and dequantized in the kernel), so at float32
// residency the fused kernels run the very instructions of the unfused
// ones on the very values.
//
// Dequant rounds where CorpusStore.take rounds: bf16 is the exact widen
// (bits << 16); int8 is float(q8) * scale rounded to float32 by
// __fmul_rn, so nvcc cannot contract it into a later FMA (q8*s - x would
// otherwise become fmaf(q8, s, -x), rounded once instead of twice).
#pragma once

#include <stdint.h>

#include <type_traits>
#include <utility>

#include "common.cuh"

namespace repro {

enum Residency : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int R>
struct CorpusElem;

template <>
struct CorpusElem<kF32> {
  using T = float;
  __device__ static float get(const T* p, float, int d) { return p[d]; }
};

template <>
struct CorpusElem<kBF16> {
  using T = unsigned short;
  __device__ static float get(const T* p, float, int d) {
    return __uint_as_float(static_cast<unsigned>(p[d]) << 16);
  }
};

template <>
struct CorpusElem<kI8> {
  using T = signed char;
  __device__ static float get(const T* p, float s, int d) {
    return __fmul_rn(static_cast<float>(p[d]), s);
  }
};

// Pre-gathered float32 rows: row i is rows[i * D, (i + 1) * D).
struct GatheredRows {
  static constexpr bool kById = false, kScaled = false;
  const float* __restrict__ rows;
  struct Row {
    const float* p;
  };
  __device__ Row at(size_t i, int D) const { return {rows + i * D}; }
  __device__ Row row(size_t i, int D) const { return at(i, D); }
  __device__ float get(const Row& r, int d) const { return r.p[d]; }
  __host__ __device__ const void* base() const { return rows; }
};

// Rows by id from the resident corpus: row i is corpus row max(ids[i], 0)
// (-1 padding is clamped by id()), dequantized per residency R. ``at``
// takes the clamped id, so a kernel can read a block's ids once.
template <int R>
struct CorpusRows {
  static constexpr bool kById = true;
  static constexpr bool kScaled = R == kI8;
  using T = typename CorpusElem<R>::T;
  const T* __restrict__ data;
  const float* __restrict__ scales;  // (N, 1), int8 only
  const int64_t* __restrict__ ids;
  struct Row {
    const T* p;
    float s;
  };
  __device__ int64_t id(size_t i) const { return ids[i] > 0 ? ids[i] : 0; }
  __device__ Row at(int64_t id, int D) const {
    return {data + static_cast<size_t>(id) * D, kScaled ? scales[id] : 1.f};
  }
  __device__ Row row(size_t i, int D) const { return at(id(i), D); }
  __device__ float get(const Row& r, int d) const {
    return CorpusElem<R>::get(r.p, r.s, d);
  }
  __host__ __device__ const void* base() const { return data; }
};

// Whether a row source's rows are float32 in device memory (copied by
// cp.async as they are) or need a dequant.
template <class Rows>
constexpr bool kF32Rows = std::is_same_v<
    decltype(std::declval<typename Rows::Row>().p), const float*>;

// Bytes of one stored element of a row source.
template <class Rows>
constexpr int kRowElemBytes = sizeof(*std::declval<typename Rows::Row>().p);

// Call fn(rows) with the CorpusRows<R> for a runtime residency; returns
// cudaErrorInvalidValue for an unknown one.
template <class Fn>
inline cudaError_t with_corpus_rows(int residency, const void* data,
                                    const void* scales, const void* ids,
                                    Fn fn) {
  const float* sc = static_cast<const float*>(scales);
  const int64_t* id = static_cast<const int64_t*>(ids);
  switch (residency) {
    case kF32:
      fn(CorpusRows<kF32>{static_cast<const float*>(data), sc, id});
      return cudaSuccess;
    case kBF16:
      fn(CorpusRows<kBF16>{static_cast<const unsigned short*>(data), sc, id});
      return cudaSuccess;
    case kI8:
      fn(CorpusRows<kI8>{static_cast<const signed char*>(data), sc, id});
      return cudaSuccess;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro
