from repro_torch.kernels.mlp_score_fused.ops import mlp_score_fused  # noqa: F401
