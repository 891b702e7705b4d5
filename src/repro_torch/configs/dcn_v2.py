"""DCN-v2 [arXiv:2008.13535] — 13 dense + 26 sparse (Criteo cardinalities),
embed 16, 3 full-rank cross layers, deep MLP 1024-1024-512."""
from repro_torch.configs.base import ArchDef, RECSYS_SHAPES, register
from repro_torch.models.recsys import DCNConfig


def config() -> DCNConfig:
    return DCNConfig(name="dcn-v2", embed_dim=16, n_cross_layers=3,
                     deep_mlp=(1024, 1024, 512))


def smoke_config() -> DCNConfig:
    return DCNConfig(name="dcn-v2-smoke", cardinalities=tuple([50] * 26),
                     embed_dim=8, n_cross_layers=2, deep_mlp=(32, 16))


ARCH = register(ArchDef(
    name="dcn-v2", family="recsys", make_config=config,
    make_smoke_config=smoke_config, shapes=RECSYS_SHAPES))
