from repro_torch.kernels.neighbor_rank_fused.ops import neighbor_rank_fused  # noqa: F401
