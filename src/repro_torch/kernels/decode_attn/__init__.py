from repro_torch.kernels.decode_attn.ops import decode_attention  # noqa: F401
