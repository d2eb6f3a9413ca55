"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=163840,
        num_experts=64, top_k=6,
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=96, vocab_size=256,
        capacity_factor=8.0, num_experts=8, top_k=2,
    )
