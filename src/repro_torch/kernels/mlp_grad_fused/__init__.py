from repro_torch.kernels.mlp_grad_fused.ops import mlp_grad_fused  # noqa: F401
