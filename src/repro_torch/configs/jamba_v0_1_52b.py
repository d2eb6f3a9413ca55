"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887; hf]"""
from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=65536,
        num_experts=16, top_k=2, attn_period=8, moe_period=2,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2, rope_theta=0.0,
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256,
        capacity_factor=4.0, num_experts=4, top_k=2, attn_period=4, moe_period=2,
        mamba_d_state=8, mamba_d_conv=4, mamba_expand=2, rope_theta=0.0,
    )
