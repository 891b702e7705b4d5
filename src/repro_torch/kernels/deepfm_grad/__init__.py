from repro_torch.kernels.deepfm_grad.ops import deepfm_value_and_grad  # noqa: F401
