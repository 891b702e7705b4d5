"""Hand-written CUDA kernels of the port (``csrc/``), one package per
kernel: ``ref.py`` holds the plain PyTorch version, ``ops.py`` the wrapper
that launches the kernel for CUDA tensors and counts its launches. The
``deepfm_*`` kernels carry the DeepFM measure, the ``mlp_*`` kernels the
generic MLP measure; the ``*_fused`` kernels take row ids into a resident
``CorpusStore`` (float32, bfloat16 or int8) and gather and dequantize the
rows themselves. ``embedding_bag``, ``decode_attention`` and
``flash_attention`` are the library kernels of the recommendation and
language models (off the search path), float32 or bfloat16. On the CPU
the search-path wrappers run their plain versions over fixed blocks of
rows (``_lib.cpu_row_blocks``), so a row's value does not depend on how
many rows share the call.

Launch accounting: a wrapper adds one to its ``launches`` where it
launches its kernel. Under a CUDA graph (``core/program.py``) the wrappers
run once, while the graph is captured, and the graph then replays their
kernels: the program moves the launches of its eager warm-up to
``warmup_launches``, takes the capture's own back out, and adds the
captured launches once per replay. So ``launch_counts()`` reads eager
launches plus captured launches x replays, and ``warmup_launch_counts()``
the warm-ups apart."""
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


for _fn in KERNELS:
    _fn.warmup_launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.warmup_launches = 0
        for path in getattr(fn, "path_launches", ()):
            fn.path_launches[path] = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def warmup_launch_counts() -> dict:
    """Launches of the eager warm-up runs before each graph capture."""
    return {fn.__name__: fn.warmup_launches for fn in KERNELS}


def launches_since(before: dict) -> dict:
    """{name: launches} counted since ``before = launch_counts()``, the
    kernels that launched only."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``delta`` x ``times`` to the counts (a negative ``times`` takes
    it back out)."""
    for fn in KERNELS:
        fn.launches += delta.get(fn.__name__, 0) * times


def move_to_warmup(delta: dict) -> None:
    """Move ``delta`` from the counts to ``warmup_launches``."""
    add_launches(delta, -1)
    for fn in KERNELS:
        fn.warmup_launches += delta.get(fn.__name__, 0)


def path_launch_counts() -> dict:
    """For each kernel with more than one implementation (the attention
    kernels: tensor-core and CUDA-core), its launches by path."""
    return {fn.__name__: dict(fn.path_launches) for fn in KERNELS
            if hasattr(fn, "path_launches")}
