from repro_torch.kernels.mlp_score.ops import mlp_score  # noqa: F401
