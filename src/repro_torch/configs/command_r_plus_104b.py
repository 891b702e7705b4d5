"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-plus; unverified-tier] —
64L, d_model 12288, 96 heads (GQA kv=8), d_ff 33792, vocab 256000.
Cohere-specific: parallel attention+FFN block, LayerNorm (no bias removed —
the pool entry says no-bias, we keep biasless projections), qk-norm, tied
embeddings."""
from repro_torch.configs.base import ArchDef, LM_SHAPES, register
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
        n_kv_heads=8, d_ff=33792, vocab_size=256000, head_dim=128,
        rope_theta=75_000_000.0, norm_type="layernorm", mlp_type="swiglu",
        parallel_block=True, qk_norm=True, tie_embeddings=True)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="command-r-plus-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=4, d_ff=256, vocab_size=512, head_dim=16,
        norm_type="layernorm", parallel_block=True, qk_norm=True,
        tie_embeddings=True)


ARCH = register(ArchDef(
    name="command-r-plus-104b", family="lm", make_config=config,
    make_smoke_config=smoke_config, shapes=LM_SHAPES))
