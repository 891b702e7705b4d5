// Shared device helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace repro {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// The opt-in limit above which dynamic shared memory needs
// cudaFuncAttributeMaxDynamicSharedMemorySize.
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Raise a kernel's dynamic shared-memory cap when it needs more than the
// default 48 KB (the launch is refused otherwise, and cudaGetLastError()
// reports it to the Python wrapper).
template <typename Kernel>
inline void allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kDefaultSmem)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
}

}  // namespace repro
