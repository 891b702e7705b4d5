"""Yi-9B [arXiv:2403.04652; hf:01-ai/Yi-9B] — llama-arch dense GQA.
48L, d_model 4096, 32 heads (GQA kv=4), d_ff 11008, vocab 64000."""
from repro_torch.configs.base import ArchDef, LM_SHAPES, register
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="yi-9b", n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab_size=64000, head_dim=128, rope_theta=5_000_000.0,
        norm_type="rmsnorm", mlp_type="swiglu")


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="yi-9b-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=16, rope_theta=5_000_000.0)


ARCH = register(ArchDef(
    name="yi-9b", family="lm", make_config=config,
    make_smoke_config=smoke_config, shapes=LM_SHAPES))
