"""command-r-plus-104b [dense] — GQA kv=8, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
        d_ff=33792, vocab_size=256000,
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=176, vocab_size=256,
    )
