"""Decoder-only LM for the dense family: prefill and one-token decode.

The port of the dense path of ``repro/models/transformer.py``. The
reference stacks each block's params along a leading ``[L, ...]`` axis and
scans over it; here ``DecoderLM.blocks`` is an ``nn.ModuleList`` of ``L``
``Block``s and the scan is a Python loop. The other families (MoE, hybrid
Mamba, xLSTM, the vision stub) and ``lm_loss`` are ROADMAP.md, Queue 1, item
7, "The rest of ``models/``", and raise.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn
from .config import ModelConfig
from .layers import (CDTYPE, apply_mlp, apply_norm, embed_params, embed_tokens,
                     mlp_params, norm_params, param, unembed)
from .sharding import ShardCtx

KIND = "attn+mlp"   # the dense family's one layer kind


def check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.layer_kinds() != [KIND]:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; repro_torch "
            "runs the dense family (ROADMAP.md, Queue 1, item 7, 'The rest of "
            "models/', lists the rest)")


class Block(nn.ModuleDict):
    """One dense layer: ``norm1``, ``attn``, ``norm2``, ``mlp`` (layer i of
    the reference's stacked ``blocks`` params)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__({
            "norm1": norm_params(cfg, generator, device),
            "norm2": norm_params(cfg, generator, device),
            "attn": attn.attn_params(cfg, generator, device),
            "mlp": mlp_params(cfg, generator, device),
        })


class DecoderLM(nn.Module):
    """The params of a dense decoder: ``embed`` (``tok``, ``out``),
    ``final_norm`` and ``blocks``. Drawn from ``generator`` on its device,
    or left uninitialised on ``device`` when ``generator`` is None."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        check_dense(cfg)
        self.cfg = cfg
        self.embed = embed_params(cfg, generator, device)
        self.final_norm = norm_params(cfg, generator, device)
        self.blocks = nn.ModuleList(Block(cfg, generator, device)
                                    for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device


def init_params(cfg: ModelConfig, generator: torch.Generator) -> DecoderLM:
    return DecoderLM(cfg, generator)


def cast_matrices(params: DecoderLM, dtype: torch.dtype) -> DecoderLM:
    """A DecoderLM whose matrices are ``params``' cast to ``dtype``; the
    vectors (norms, biases) are shared, still f32."""
    out = DecoderLM(params.cfg, device="meta")
    with torch.no_grad():
        for name, w in params.named_parameters():
            mod, leaf = name.rsplit(".", 1)
            out.get_submodule(mod)[leaf] = param(w.to(dtype)) if w.dim() >= 2 else w
    return out


def _cast_block(p: Block) -> dict:
    """Every f32 param of a block in bf16 (the reference's cast_params_once
    casts every f32 leaf of the stacked blocks, norms included)."""
    return {name: {k: (w.to(CDTYPE) if w.dtype == torch.float32 else w)
                   for k, w in group.items()}
            for name, group in p.items()}


def _apply_block(cfg: ModelConfig, p, x, ctx: ShardCtx | None):
    h = apply_norm(cfg, p["norm1"], x)
    out, _ = attn.self_attention(cfg, p["attn"], h, causal=True,
                                 bf16=bool(ctx and ctx.bf16_attn), ctx=ctx)
    x = x + out
    h = apply_norm(cfg, p["norm2"], x)
    return x + apply_mlp(cfg, p["mlp"], h)


def backbone(cfg: ModelConfig, params: DecoderLM, x, ctx: ShardCtx | None):
    """x [B,S,D] -> [B,S,D] hidden states (no remat: nothing runs backward)."""
    cast = ctx is not None and ctx.cast_params_once
    for blk in params.blocks:
        x = _apply_block(cfg, _cast_block(blk) if cast else blk, x, ctx)
    return apply_norm(cfg, params.final_norm, x)


def embed_inputs(cfg: ModelConfig, params: DecoderLM, batch, ctx: ShardCtx | None):
    """Token embedding. Returns (x [B,S,D], loss mask)."""
    tokens = batch["tokens"]
    x = embed_tokens(params.embed, tokens)
    return x, torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Decode cache ``{"k", "v"}``, each ``[L, B, Smax(|window), Hkv, Dh]``."""
    S = min(max_len, cfg.sliding_window) if cfg.sliding_window > 0 else max_len
    shape = (cfg.num_layers, batch, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=CDTYPE, device=device),
            "v": torch.zeros(shape, dtype=CDTYPE, device=device)}


def _decode_block(cfg: ModelConfig, p, x, cache_k, cache_v, pos: int):
    h = apply_norm(cfg, p["norm1"], x)
    out, _, _ = attn.decode_attention(cfg, p["attn"], h, cache_k, cache_v, pos)
    x = x + out
    h = apply_norm(cfg, p["norm2"], x)
    return x + apply_mlp(cfg, p["mlp"], h)


def decode_step(cfg: ModelConfig, params: DecoderLM, tokens, cache, pos: int,
                ctx: ShardCtx | None = None):
    """tokens [B,1] -> (logits [B,1,V], cache). ``pos`` is the position of
    ``tokens``; each layer's cache slice is written in place."""
    x = embed_tokens(params.embed, tokens)
    for i, blk in enumerate(params.blocks):
        x = _decode_block(cfg, blk, x, cache["k"][i], cache["v"][i], pos)
    x = apply_norm(cfg, params.final_norm, x)
    return unembed(cfg, params.embed, x), cache


def prefill(cfg: ModelConfig, params: DecoderLM, batch, ctx: ShardCtx | None = None):
    """Prefill forward: last-position logits [B,1,V] (no cache is written,
    as in the reference; the Engine fills its cache by decoding)."""
    x, _ = embed_inputs(cfg, params, batch, ctx)
    h = backbone(cfg, params, x, ctx)
    return unembed(cfg, params.embed, h[:, -1:, :])
