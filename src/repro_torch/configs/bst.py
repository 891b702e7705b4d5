"""BST — Behavior Sequence Transformer (Alibaba) [arXiv:1905.06874] —
embed 32, history 20 (+target), 1 block x 8 heads, MLP 1024-512-256.
The retrieval_cand shape re-runs the transformer per candidate (true
cross-encoder) — the regime GUITAR targets."""
from repro_torch.configs.base import ArchDef, RECSYS_SHAPES, register
from repro_torch.models.recsys import BSTConfig


def config() -> BSTConfig:
    return BSTConfig(name="bst", n_items=4_000_000, embed_dim=32, seq_len=20,
                     n_blocks=1, n_heads=8, mlp=(1024, 512, 256))


def smoke_config() -> BSTConfig:
    return BSTConfig(name="bst-smoke", n_items=1000, embed_dim=16, seq_len=6,
                     n_blocks=1, n_heads=4, mlp=(32, 16))


ARCH = register(ArchDef(
    name="bst", family="recsys", make_config=config,
    make_smoke_config=smoke_config, shapes=RECSYS_SHAPES))
