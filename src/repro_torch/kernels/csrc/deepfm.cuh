// The DeepFM measure's weights as its kernels take them. All four
// (deepfm_score, deepfm_score_fused, deepfm_grad, deepfm_grad_fused) run
// the cluster body of mlp_grad.cuh over its DeepFM input policy.
//
//   f(x, q) = sigmoid(<x_fm, q_fm> + relu(relu([q_deep | x_deep] W0 + b0)
//                                         W1 + b1) W2 + b2)
#pragma once

#include "common.cuh"

namespace repro {

// The measure MLP's parameters in device memory (row-major, as the
// PyTorch tensors hold them).
struct DeepFMWeights {
  const float* w0;
  const float* b0;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
};

inline DeepFMWeights deepfm_weights(const void* w0, const void* b0,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* b2) {
  return {static_cast<const float*>(w0), static_cast<const float*>(b0),
          static_cast<const float*>(w1), static_cast<const float*>(b1),
          static_cast<const float*>(w2), static_cast<const float*>(b2)};
}

}  // namespace repro
