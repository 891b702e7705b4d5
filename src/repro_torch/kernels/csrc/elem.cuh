// Element types of the kernels that take float32 or bfloat16 tensors
// (embedding_bag, decode_attn, flash_attn): the dtype code the wrappers
// pass, and exact conversions to and from float32. bf16 travels as its
// 16-bit pattern; widening is the exact ``bits << 16``, narrowing rounds
// to nearest even as ``Tensor.to(torch.bfloat16)`` does.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {

enum DType : int { kDTypeF32 = 0, kDTypeBF16 = 1 };

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ __forceinline__ static float to_f32(float x) { return x; }
  __device__ __forceinline__ static float from_f32(float x) { return x; }
};

template <>
struct Elem<uint16_t> {
  __device__ __forceinline__ static float to_f32(uint16_t x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  __device__ __forceinline__ static uint16_t from_f32(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

// Read n consecutive elements of type T as float32 through one 16-byte
// load when n * sizeof(T) == 16 and p is 16-byte aligned (the caller
// guarantees both), else element by element.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float* f) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = Elem<T>::to_f32(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = Elem<T>::to_f32(__ldg(p + k));
  }
}

}  // namespace repro
