// The generic MLP measure: the network description (MLPNet) shared by its
// score and grad kernels, and the score kernel. The grad kernels' body is
// mlp_grad.cuh.
//
//   f(x, q) = sigmoid(MLP([x | q])),  MLP = L dense layers, ReLU between
//   layers, the last of width 1
//
// The depth L is a runtime value up to kMaxMLPLayers, carried with the
// layer widths and the weight pointers in a by-value kernel parameter
// (MLPNet). The score kernel's layout is deepfm.cuh's: the whole network
// is staged once per block into shared memory, every hidden layer's
// weight matrix with a row stride of (cols + 1) floats (stage_padded), so
// that a warp reading one row across 32 columns hits 32 distinct banks.
// The last layer (H, 1) is staged as a plain vector and is a dot product
// plus warp_sum. One warp owns one row at a time, its lanes split the
// hidden units (dense_warp), and the row's input [x | q] and every
// pre-activation z_i stay in the warp's scratch slice, never in device
// memory. (mlp_net also sizes two gradient buffers per warp that the
// score kernel leaves unused; they stay, so that the shared-memory limit
// the wrappers check, and so the set of networks they take, does not
// move.)
#pragma once

#include "common.cuh"
#include "deepfm.cuh"
#include "rows.cuh"

namespace repro {

constexpr int kMaxMLPLayers = 8;
constexpr int kMLPThreads = kDeepFMThreads;         // 8 warps
constexpr int kMLPRowsPerBlock = kDeepFMRowsPerBlock;  // one row per warp

// The network as the kernels take it: dim[0] = dx + dq, dim[L] = 1, layer
// i maps dim[i] -> dim[i + 1] with w[i] row-major (dim[i], dim[i + 1]).
// The host fills the shared-memory offsets (in floats) once per launch.
struct MLPNet {
  const float* w[kMaxMLPLayers];
  const float* b[kMaxMLPLayers];
  int dim[kMaxMLPLayers + 1];
  int woff[kMaxMLPLayers];  // staged weights of layer i
  int boff[kMaxMLPLayers];  // staged bias of layer i
  int inoff[kMaxMLPLayers];  // layer i's input in the warp's scratch:
                             // [x | q] for i = 0, else z_{i-1}
  int layers;
  int dx, dq;
  int weight_floats;   // the staged network
  int scratch_floats;  // one warp's slice
  int gmax;            // the widest hidden layer (backward buffers)
};

// Fill ``net`` from the weight pointers and widths; returns false for a
// depth outside [1, kMaxMLPLayers] or a last layer wider than 1.
inline bool mlp_net(MLPNet& net, const void* const* ws,
                    const void* const* bs, const int* dims, int layers,
                    int dx, int dq) {
  if (layers < 1 || layers > kMaxMLPLayers || dims[0] != dx + dq ||
      dims[layers] != 1)
    return false;
  net.layers = layers;
  net.dx = dx;
  net.dq = dq;
  int off = 0, z = 0, gmax = 0;
  for (int i = 0; i <= layers; ++i) net.dim[i] = dims[i];
  for (int i = 0; i < layers; ++i) {
    net.w[i] = static_cast<const float*>(ws[i]);
    net.b[i] = static_cast<const float*>(bs[i]);
    const int out = dims[i + 1];
    const bool last = i == layers - 1;
    net.woff[i] = off;
    off += last ? dims[i] : dims[i] * (out + 1);
    net.boff[i] = off;
    off += out;
    net.inoff[i] = z;
    z += dims[i];
    if (!last) gmax = out > gmax ? out : gmax;
  }
  net.weight_floats = off;
  net.gmax = gmax;
  // in + every z_i + two gradient buffers + the row slice
  net.scratch_floats = z + 2 * gmax + dx;
  return true;
}

// Dynamic shared memory of an MLP kernel block: the staged network and
// one scratch slice per warp.
inline size_t mlp_smem_bytes(const MLPNet& net) {
  return sizeof(float) * (static_cast<size_t>(net.weight_floats) +
                          static_cast<size_t>(kMLPThreads / kWarp) *
                              net.scratch_floats);
}

// Block-wide copy of the network into shared memory. The caller must
// __syncthreads() before reading.
__device__ inline void mlp_stage(float* sm, const MLPNet& net) {
  const int L = net.layers;
  for (int i = 0; i < L - 1; ++i)
    stage_padded(sm + net.woff[i], net.w[i], net.dim[i], net.dim[i + 1]);
  const int H = net.dim[L - 1];
  for (int u = threadIdx.x; u < H; u += blockDim.x)
    sm[net.woff[L - 1] + u] = net.w[L - 1][u];
  for (int i = 0; i < L; ++i)
    for (int u = threadIdx.x; u < net.dim[i + 1]; u += blockDim.x)
      sm[net.boff[i] + u] = net.b[i][u];
}

// One warp's forward pass over the row (x, q); ``scr`` is the warp's
// scratch slice. Leaves [x | q] at scr[0:dim[0]] and each hidden
// pre-activation z_i at scr + inoff[i + 1] for a backward pass, and returns
// the score in every lane.
__device__ inline float mlp_forward_warp(const float* sm, const MLPNet& net,
                                         const float* __restrict__ x,
                                         const float* __restrict__ q,
                                         float* scr, int lane) {
  const int L = net.layers;
  for (int k = lane; k < net.dx; k += kWarp) scr[k] = x[k];
  for (int k = lane; k < net.dq; k += kWarp) scr[net.dx + k] = q[k];
  __syncwarp();
  for (int i = 0; i < L - 1; ++i) {
    const float* in = scr + net.inoff[i];
    float* z = scr + net.inoff[i + 1];
    const float* W = sm + net.woff[i];
    const float* bias = sm + net.boff[i];
    if (i == 0)
      dense_warp<false>(in, net.dim[0], W, bias, net.dim[1], z, lane);
    else
      dense_warp<true>(in, net.dim[i], W, bias, net.dim[i + 1], z, lane);
    __syncwarp();
  }
  // the last layer: a dot product with the (relu'd, past layer 0) input
  const float* in = scr + net.inoff[L - 1];
  const float* w = sm + net.woff[L - 1];
  const int H = net.dim[L - 1];
  float lp = 0.f;
  if (L == 1) {
    for (int u = lane; u < H; u += kWarp) lp = fmaf(in[u], w[u], lp);
  } else {
    for (int u = lane; u < H; u += kWarp)
      lp = fmaf(fmaxf(in[u], 0.f), w[u], lp);
  }
  const float logit = warp_sum(lp) + sm[net.boff[L - 1]];
  return 1.f / (1.f + expf(-logit));
}

// ---------------------------------------------------------------------------
// The score kernel, one body for every row source (rows.cuh):
// GatheredRows for the pre-gathered kernels, CorpusRows<R> for the
// index-fused ones. Blocks of kMLPRowsPerBlock rows, one warp per row.
// ---------------------------------------------------------------------------

// f(x_r, q_r) for each row r; ``mask`` (nullable) is the adaptive prefix
// mask: a masked row scores -inf and its warp skips the MLP, and a block
// whose rows are all masked skips the weight staging as well.
template <class Rows>
__global__ void __launch_bounds__(kMLPThreads)
mlp_score_kernel(Rows rows, const float* __restrict__ query, int q_shared,
                 const unsigned char* __restrict__ mask, MLPNet net,
                 float* __restrict__ out, int M) {
  extern __shared__ float sm[];
  const int row0 = blockIdx.x * kMLPRowsPerBlock;
  const int row1 = min(row0 + kMLPRowsPerBlock, M);
  if (mask != nullptr) {
    const int r = row0 + threadIdx.x;
    const int live = threadIdx.x < kMLPRowsPerBlock && r < row1 && mask[r];
    if (!__syncthreads_or(live)) {
      if (r < row1 && threadIdx.x < kMLPRowsPerBlock) out[r] = -INFINITY;
      return;
    }
  }
  mlp_stage(sm, net);
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  float* scr = sm + net.weight_floats + warp * net.scratch_floats;
  float* slice = scr + net.scratch_floats - net.dx;
  for (int r = row0 + warp; r < row1; r += nwarps) {
    __syncwarp();  // the previous row's scratch reads are done
    if (mask != nullptr && !mask[r]) {
      if (lane == 0) out[r] = -INFINITY;
      continue;
    }
    const float* x = rows.load(r, net.dx, slice, lane);
    const float* q =
        q_shared ? query : query + static_cast<size_t>(r) * net.dq;
    const float val = mlp_forward_warp(sm, net, x, q, scr, lane);
    if (lane == 0) out[r] = val;
  }
}

template <class Rows>
inline cudaError_t launch_mlp_score(Rows rows, const void* query,
                                    int q_shared, const void* mask,
                                    const MLPNet& net, void* out, int M,
                                    void* stream) {
  if (M > 0) {
    const size_t smem = mlp_smem_bytes(net);
    allow_smem(mlp_score_kernel<Rows>, smem);
    const int grid = (M + kMLPRowsPerBlock - 1) / kMLPRowsPerBlock;
    mlp_score_kernel<Rows><<<grid, kMLPThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        rows, static_cast<const float*>(query), q_shared,
        static_cast<const unsigned char*>(mask), net,
        static_cast<float*>(out), M);
  }
  return cudaGetLastError();
}

}  // namespace repro
