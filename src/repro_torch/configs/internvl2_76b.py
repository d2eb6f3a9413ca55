"""internvl2-76b [vlm] — InternViT (STUB patch embeddings) + InternLM2-style
LM backbone, GQA kv=8. [arXiv:2404.16821; unverified]"""
from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", family="vlm",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=28672, vocab_size=128256,
        frontend="vision_stub", num_patches=256,
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        frontend="vision_stub", num_patches=8,
    )
