"""DLRM RM2 [arXiv:1906.00091] — 13 dense + 26 sparse (Criteo), embed 64,
bot MLP 13-512-256-64, top MLP 512-512-256-1, dot interaction."""
from repro_torch.configs.base import ArchDef, RECSYS_SHAPES, register
from repro_torch.models.recsys import DLRMConfig


def config() -> DLRMConfig:
    return DLRMConfig(name="dlrm-rm2", embed_dim=64, bot_mlp=(512, 256, 64),
                      top_mlp=(512, 512, 256, 1))


def smoke_config() -> DLRMConfig:
    return DLRMConfig(name="dlrm-smoke", cardinalities=tuple([50] * 26),
                      embed_dim=8, bot_mlp=(16, 8), top_mlp=(16, 1))


ARCH = register(ArchDef(
    name="dlrm-rm2", family="recsys", make_config=config,
    make_smoke_config=smoke_config, shapes=RECSYS_SHAPES))
