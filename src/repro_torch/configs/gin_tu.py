"""GIN (TU benchmark config) [arXiv:1810.00826] — 5 layers, d_hidden 64,
sum aggregator, learnable eps. Per-shape d_in/n_classes come from the shape
spec (cora / reddit / ogbn-products / molecule scales)."""
from repro_torch.configs.base import ArchDef, GNN_SHAPES, ShapeSpec, register
from repro_torch.models.gnn import GINConfig


def config(shape: ShapeSpec | None = None) -> GINConfig:
    d_in = shape["d_feat"] if shape else 1433
    n_classes = shape["n_classes"] if shape else 7
    pool = bool(shape and shape.name == "molecule")
    return GINConfig(name="gin-tu", n_layers=5, d_in=d_in, d_hidden=64,
                     n_classes=n_classes, train_eps=True, graph_pool=pool)


def smoke_config() -> GINConfig:
    return GINConfig(name="gin-smoke", n_layers=2, d_in=8, d_hidden=16,
                     n_classes=3)


ARCH = register(ArchDef(
    name="gin-tu", family="gnn", make_config=config,
    make_smoke_config=smoke_config, shapes=GNN_SHAPES,
    notes="GUITAR inapplicable (no query-item measure) — see DESIGN.md §5"))
