from repro_torch.kernels.flash_attn.ops import flash_attention  # noqa: F401
