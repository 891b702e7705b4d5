from repro_torch.kernels.deepfm_score_fused.ops import deepfm_score_fused  # noqa: F401
