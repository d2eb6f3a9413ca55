"""mixtral-8x22b [moe] — 8 experts top-2, GQA kv=8, SWA. [arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=32768,
        num_experts=8, top_k=2, sliding_window=4096,
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        capacity_factor=4.0, num_experts=4, top_k=2, sliding_window=16,
    )
