"""DeepSeek-V3 671B [arXiv:2412.19437] — 61L (first 3 dense), d_model 7168,
128 heads MLA (q_lora 1536, kv_lora 512, nope 128 / rope 64 / v 128),
MoE: 1 shared + 256 routed experts (d_ff 2048) top-8 sigmoid router,
vocab 129280, MTP depth-1."""
from repro_torch.configs.base import ArchDef, LM_SHAPES, register
from repro_torch.models.deepseek import DeepSeekConfig


def config() -> DeepSeekConfig:
    return DeepSeekConfig(
        name="deepseek-v3-671b", n_layers=61, n_dense_layers=3, d_model=7168,
        n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        dense_d_ff=18432, moe_d_ff=2048, n_experts=256, moe_top_k=8,
        n_shared_experts=1, vocab_size=129280, use_mtp=True, moe_groups=16)


def smoke_config() -> DeepSeekConfig:
    return DeepSeekConfig(
        name="deepseek-v3-smoke", n_layers=4, n_dense_layers=1, d_model=64,
        n_heads=4, q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, dense_d_ff=128, moe_d_ff=32,
        n_experts=8, moe_top_k=2, n_shared_experts=1, vocab_size=256,
        use_mtp=True, moe_groups=2)


ARCH = register(ArchDef(
    name="deepseek-v3-671b", family="lm", make_config=config,
    make_smoke_config=smoke_config, shapes=LM_SHAPES,
    notes="optimizer moments in bf16 (OptimizerConfig.moment_dtype): "
          "671B parameters' float32 moments alone are 5.4 TB; one H100 "
          "holds the published widths only with the depth cut"))
