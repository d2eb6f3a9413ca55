"""qwen1.5-110b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=49152, vocab_size=152064, qkv_bias=True,
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=192, vocab_size=256, qkv_bias=True,
    )
