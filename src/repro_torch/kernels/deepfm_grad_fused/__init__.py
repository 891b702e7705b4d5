from repro_torch.kernels.deepfm_grad_fused.ops import deepfm_grad_fused  # noqa: F401
