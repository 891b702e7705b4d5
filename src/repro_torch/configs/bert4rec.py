"""BERT4Rec [arXiv:1904.06690] — embed 64, 2 blocks x 2 heads, seq 200,
bidirectional masked-item prediction. Item vocab scaled to 1M so the
retrieval_cand shape (1e6 candidates) is meaningful; training uses sampled
softmax (see recsys.bert4rec_sampled_loss)."""
from repro_torch.configs.base import ArchDef, RECSYS_SHAPES, register
from repro_torch.models.recsys import BERT4RecConfig


def config() -> BERT4RecConfig:
    return BERT4RecConfig(name="bert4rec", n_items=1_000_000, embed_dim=64,
                          n_blocks=2, n_heads=2, seq_len=200)


def smoke_config() -> BERT4RecConfig:
    return BERT4RecConfig(name="bert4rec-smoke", n_items=500, embed_dim=16,
                          n_blocks=2, n_heads=2, seq_len=12)


ARCH = register(ArchDef(
    name="bert4rec", family="recsys", make_config=config,
    make_smoke_config=smoke_config, shapes=RECSYS_SHAPES))
