"""llama3.2-3b [dense] — small llama3, GQA kv=8. [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=8192, vocab_size=128256, rope_theta=500000.0,
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-smoke", family="dense",
        num_layers=2, d_model=48, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, rope_theta=500000.0,
    )
