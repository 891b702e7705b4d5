// Plain-C helpers of the kernel library (no kernels here).
#include "common.cuh"

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
