"""Model configuration shared by the zoo (the port's own copy of ``repro.models.config``)."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "silu"                 # silu (SwiGLU) | gelu (plain MLP)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_period: int = 1               # MoE every `moe_period`-th layer

    # --- attention variants --------------------------------------------------
    sliding_window: int = 0           # 0 = full attention

    # --- hybrid (jamba) -------------------------------------------------------
    attn_period: int = 0              # 1 attention layer per `attn_period`
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- ssm (xlstm) -----------------------------------------------------------
    slstm_every: int = 2              # sLSTM every n-th layer (rest mLSTM)

    # --- encoder-decoder (whisper) ---------------------------------------------
    encoder_layers: int = 0
    max_target_len: int = 448

    # --- modality frontends (STUBS by assignment) -------------------------------
    frontend: str = "none"            # none | audio_stub | vision_stub
    num_patches: int = 256            # vlm: patch embeddings prepended

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context? (assignment's long_500k rule)"""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> list[str]:
        """Sub-layer kinds of one scan super-block (see transformer.py)."""
        if self.family == "hybrid":
            kinds = []
            for i in range(self.attn_period):
                kind = "attn" if i == self.attn_period - 1 else "mamba"
                ff = "moe" if (i % 2 == 1 and self.is_moe) else "mlp"
                kinds.append(f"{kind}+{ff}")
            return kinds
        if self.family == "ssm":
            return ["slstm" if i % self.slstm_every == 1 else "mlstm"
                    for i in range(self.num_layers)]
        ff = "moe" if self.is_moe else "mlp"
        return [f"attn+{ff}"]

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        qd, kvd = self.q_dim, self.kv_dim
        attn = D * qd + 2 * D * kvd + qd * D
        if self.qkv_bias:
            attn += qd + 2 * kvd
        if self.act == "silu":
            mlp = 3 * D * F
        else:
            mlp = 2 * D * F
        per_layer = 2 * D  # norms
        if self.family == "ssm":
            # xlstm block ~ qkv + gates + out proj (approximation documented)
            per_layer += 4 * D * D + 4 * D
            blocks = self.num_layers * per_layer
        elif self.family == "hybrid":
            d_in = self.mamba_expand * D
            mamba = D * 2 * d_in + d_in * self.mamba_d_conv + d_in * (self.mamba_d_state * 2 + 1) + d_in * D
            n_attn = self.num_layers // self.attn_period
            n_mamba = self.num_layers - n_attn
            n_moe = self.num_layers // 2 if self.is_moe else 0
            n_mlp = self.num_layers - n_moe
            blocks = (n_attn * attn + n_mamba * mamba
                      + n_moe * self.num_experts * mlp + n_mlp * mlp
                      + self.num_layers * 2 * D)
        elif self.is_moe:
            blocks = self.num_layers * (attn + self.num_experts * mlp + D * self.num_experts + per_layer)
        else:
            blocks = self.num_layers * (attn + mlp + per_layer)
        emb = V * D * (1 if self.tie_embeddings else 2)
        enc = self.encoder_layers * (attn + mlp + per_layer) if self.is_encoder_decoder else 0
        # cross attention for enc-dec decoders
        if self.is_encoder_decoder:
            blocks += self.num_layers * attn
        return int(emb + blocks + enc)

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of num_experts)."""
        if not self.is_moe:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        mlp = (3 if self.act == "silu" else 2) * D * F
        if self.family == "hybrid":
            n_moe = self.num_layers // 2
        else:
            n_moe = self.num_layers // self.moe_period
        inactive = n_moe * (self.num_experts - self.top_k) * mlp
        return int(self.param_count() - inactive)
