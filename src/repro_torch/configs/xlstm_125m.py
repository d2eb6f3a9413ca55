"""xlstm-125m [ssm] — alternating sLSTM + mLSTM blocks, d_ff=0 (cell-only
blocks). [arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304, slstm_every=2, rope_theta=0.0,
        tie_embeddings=False,
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=256, slstm_every=2, rope_theta=0.0,
    )
