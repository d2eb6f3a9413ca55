"""whisper-tiny [audio] — enc-dec, conv frontend STUB (precomputed frame
embeddings via input_specs). [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
        d_ff=1536, vocab_size=51865,
        encoder_layers=4, norm="layernorm", act="gelu", rope_theta=0.0,
        frontend="audio_stub", max_target_len=448, tie_embeddings=True,
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        encoder_layers=2, norm="layernorm", act="gelu", rope_theta=0.0,
        frontend="audio_stub", max_target_len=32, tie_embeddings=True,
    )
