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

// cp.async of 4 or 16 bytes from device to shared memory (16: both
// addresses 16-byte aligned), and the wait for all of a thread's copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
