from repro_torch.kernels.neighbor_rank.ops import neighbor_rank  # noqa: F401
