from repro_torch.kernels.deepfm_score.ops import deepfm_score  # noqa: F401
