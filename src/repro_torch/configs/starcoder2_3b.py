"""StarCoder2-3B [arXiv:2402.19173; hf:bigcode/starcoder2-3b] —
30L, d_model 3072, 24 heads (GQA kv=2), d_ff 12288, vocab 49152.
GELU MLP with biases, LayerNorm, RoPE."""
from repro_torch.configs.base import ArchDef, LM_SHAPES, register
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-3b", n_layers=30, d_model=3072, n_heads=24,
        n_kv_heads=2, d_ff=12288, vocab_size=49152, head_dim=128,
        rope_theta=999999.4, norm_type="layernorm", mlp_type="gelu",
        use_bias=True)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=192, vocab_size=512, head_dim=16,
        norm_type="layernorm", mlp_type="gelu", use_bias=True)


ARCH = register(ArchDef(
    name="starcoder2-3b", family="lm", make_config=config,
    make_smoke_config=smoke_config, shapes=LM_SHAPES))
