// Plain-C helpers of the kernel library (no kernels here).
#include "common.cuh"

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most dynamic shared memory a block may opt in to on ``device``
// (bytes), or -1 if the runtime cannot say.
extern "C" int repro_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}
