"""Hand-written CUDA kernels of the port (``csrc/``), one package per
kernel: ``ref.py`` holds the plain PyTorch version, ``ops.py`` the wrapper
that launches the kernel for CUDA tensors and counts its launches. The
``deepfm_*`` kernels carry the DeepFM measure, the ``mlp_*`` kernels the
generic MLP measure; the ``*_fused`` kernels take row ids into a resident
``CorpusStore`` (float32, bfloat16 or int8) and gather and dequantize the
rows themselves. ``embedding_bag``, ``decode_attention`` and
``flash_attention`` are the library kernels of the recommendation and
language models (off the search path), float32 or bfloat16."""
from repro_torch.kernels.decode_attn import decode_attention  # noqa: F401
from repro_torch.kernels.deepfm_grad import deepfm_value_and_grad  # noqa: F401
from repro_torch.kernels.deepfm_grad_fused import deepfm_grad_fused  # noqa: F401
from repro_torch.kernels.deepfm_score import deepfm_score  # noqa: F401
from repro_torch.kernels.deepfm_score_fused import deepfm_score_fused  # noqa: F401
from repro_torch.kernels.embedding_bag import embedding_bag  # noqa: F401
from repro_torch.kernels.flash_attn import flash_attention  # noqa: F401
from repro_torch.kernels.mlp_grad import mlp_value_and_grad  # noqa: F401
from repro_torch.kernels.mlp_grad_fused import mlp_grad_fused  # noqa: F401
from repro_torch.kernels.mlp_score import mlp_score  # noqa: F401
from repro_torch.kernels.mlp_score_fused import mlp_score_fused  # noqa: F401
from repro_torch.kernels.neighbor_rank import neighbor_rank  # noqa: F401
from repro_torch.kernels.neighbor_rank_fused import neighbor_rank_fused  # noqa: F401

KERNELS = (deepfm_score, neighbor_rank, deepfm_value_and_grad,
           deepfm_score_fused, neighbor_rank_fused, deepfm_grad_fused,
           mlp_score, mlp_score_fused, mlp_value_and_grad, mlp_grad_fused,
           embedding_bag, decode_attention, flash_attention)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        for path in getattr(fn, "path_launches", ()):
            fn.path_launches[path] = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def path_launch_counts() -> dict:
    """For each kernel with more than one implementation (the attention
    kernels: tensor-core and CUDA-core), its launches by path."""
    return {fn.__name__: dict(fn.path_launches) for fn in KERNELS
            if hasattr(fn, "path_launches")}
