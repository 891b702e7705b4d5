"""Granite MoE 3B-a800m [hf:ibm-granite/granite-3.0-3b-a800m-base] —
32L, d_model 1536, 24 heads (GQA kv=8, head_dim 64), 40 experts top-8,
expert d_ff 512, vocab 49155, tied embeddings."""
from repro_torch.configs.base import ArchDef, LM_SHAPES, register
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
        n_kv_heads=8, vocab_size=49155, head_dim=64, rope_theta=10000.0,
        norm_type="rmsnorm", n_experts=40, moe_top_k=8, moe_d_ff=512,
        tie_embeddings=True, moe_groups=16)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, vocab_size=256, head_dim=16, n_experts=8, moe_top_k=2,
        moe_d_ff=32, tie_embeddings=True, moe_groups=2)


ARCH = register(ArchDef(
    name="granite-moe-3b-a800m", family="lm", make_config=config,
    make_smoke_config=smoke_config, shapes=LM_SHAPES))
