from repro_torch.kernels.mlp_grad.ops import mlp_value_and_grad  # noqa: F401
