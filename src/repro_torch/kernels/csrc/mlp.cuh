// The generic MLP measure's network description (MLPNet), shared by its
// score and grad kernels, whose body is mlp_grad.cuh, and the admission
// rule of all four (mlp_smem_bytes).
//
//   f(x, q) = sigmoid(MLP([x | q])),  MLP = L dense layers, ReLU between
//   layers, the last of width 1
//
// The depth L is a runtime value up to kMaxMLPLayers, carried with the
// layer widths and the weight pointers in a by-value kernel parameter
// (MLPNet). Which networks the kernels take is fixed by the layout of the
// port's first MLP kernels, one block staging the whole network with
// every hidden layer's rows padded to (cols + 1) floats, beside one
// scratch slice per warp for 8 warps (the row's input, every
// pre-activation, two gradient buffers of the widest hidden layer and the
// row): mlp_net sizes it (woff, boff, inoff, weight_floats,
// scratch_floats) and mlp_smem_bytes checks it, as net_args in
// kernels/mlp_score/ops.py does. The cluster body needs less shared memory
// for every network that rule admits (mlp_cluster_plan), so the set of
// networks the wrappers take does not move. MLPNet keeps its fields so
// that the kernels' parameters keep their layout.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kMaxMLPLayers = 8;
constexpr int kMLPAdmitWarps = 8;  // scratch slices in the admission rule

// The network as the kernels take it: dim[0] = dx + dq, dim[L] = 1, layer
// i maps dim[i] -> dim[i + 1] with w[i] row-major (dim[i], dim[i + 1]).
struct MLPNet {
  const float* w[kMaxMLPLayers];
  const float* b[kMaxMLPLayers];
  int dim[kMaxMLPLayers + 1];
  int woff[kMaxMLPLayers];   // the admission layout: layer i's weights,
  int boff[kMaxMLPLayers];   // its bias,
  int inoff[kMaxMLPLayers];  // its input in a warp's scratch slice
  int layers;
  int dx, dq;
  int weight_floats;   // the admission layout's staged network
  int scratch_floats;  // and one warp's slice
  int gmax;            // the widest hidden layer
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

// The admission rule's bytes: the staged network and one scratch slice per
// warp of 8.
inline size_t mlp_smem_bytes(const MLPNet& net) {
  return sizeof(float) * (static_cast<size_t>(net.weight_floats) +
                          static_cast<size_t>(kMLPAdmitWarps) *
                              net.scratch_floats);
}

}  // namespace repro
