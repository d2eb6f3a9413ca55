"""Whisper-style encoder-decoder backbone (the conv frontend is a stub:
``input_specs`` supplies precomputed frame embeddings).

The port of ``repro/models/whisper.py``. ``EncDecLM`` holds the reference's
params: ``embed``, ``pos_enc`` [8192, D], ``pos_dec`` [max_target_len, D],
``enc`` and ``dec`` (``nn.ModuleList``s, layer i of the reference's stacked
leaves), ``enc_norm`` and ``final_norm``. As in the reference, the encoder
and the decoder call ``self_attention`` without the knobs of a
``ShardCtx``, so they run ``_sdpa`` and no kernel; under a mesh they get a
ctx of the mesh alone (``_attn_ctx``), so each rank attends its own share
(``attention._on_rank_share``). With grad mode on, each encoder and
decoder layer is recomputed in the backward pass (``sharding.remat``; the reference
checkpoints every layer in full whatever its ``remat``, which the port's
``ctx.remat`` may change: the values are the same).
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn
from .config import ModelConfig
from .layers import (CDTYPE, apply_mlp, apply_norm, dense_init, embed_params,
                     embed_tokens, mlp_params, norm_params, softmax_xent, unembed)
from .sharding import ShardCtx, batch_spec, constrain, dense, remat, split_ready


def _enc_block_params(cfg: ModelConfig, generator=None, device=None) -> nn.ModuleDict:
    return nn.ModuleDict({
        "norm1": norm_params(cfg, generator, device),
        "attn": attn.attn_params(cfg, generator, device),
        "norm2": norm_params(cfg, generator, device),
        "mlp": mlp_params(cfg, generator, device),
    })


def _dec_block_params(cfg: ModelConfig, generator=None, device=None) -> nn.ModuleDict:
    return nn.ModuleDict({
        "norm1": norm_params(cfg, generator, device),
        "attn": attn.attn_params(cfg, generator, device),
        "norm2": norm_params(cfg, generator, device),
        "xattn": attn.attn_params(cfg, generator, device),
        "norm3": norm_params(cfg, generator, device),
        "mlp": mlp_params(cfg, generator, device),
    })


class EncDecLM(nn.Module):
    """The params of the encoder-decoder (see the module docstring). Drawn
    from ``generator`` on its device, or left uninitialised on ``device``
    when ``generator`` is None."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = embed_params(cfg, generator, device)
        self.pos_enc = dense_init(generator, (8192, cfg.d_model), scale=0.01, device=device)
        self.pos_dec = dense_init(generator, (cfg.max_target_len, cfg.d_model), scale=0.01,
                                  device=device)
        self.enc = nn.ModuleList(_enc_block_params(cfg, generator, device)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(_dec_block_params(cfg, generator, device)
                                 for _ in range(cfg.num_layers))
        self.enc_norm = norm_params(cfg, generator, device)
        self.final_norm = norm_params(cfg, generator, device)

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device


def init_params(cfg: ModelConfig, generator: torch.Generator) -> EncDecLM:
    return EncDecLM(cfg, generator)


def _positions(table, n: int):
    """The first n rows of ``table``, tiled when n exceeds it (long-prefill
    shapes; stub-safe)."""
    if n > table.shape[0]:
        table = table.repeat(-(-n // table.shape[0]), 1)
    return table[:n].to(CDTYPE)


def encode(cfg: ModelConfig, params: EncDecLM, frames, ctx: ShardCtx | None = None):
    """frames [B, T, D] (stub conv output) -> encoder states [B, T, D]."""
    bs = batch_spec(ctx)
    x = frames.to(CDTYPE) + _positions(params.pos_enc, frames.shape[1])[None]
    x = constrain(ctx, x, bs, None, None)
    actx = _attn_ctx(ctx)

    def layer(p, h):
        a = apply_norm(cfg, p["norm1"], h)
        out = attn.self_attention(cfg, p["attn"], a, causal=False, ctx=actx)
        h = h + constrain(ctx, out, bs, None, None)
        a = apply_norm(cfg, p["norm2"], h)
        return h + constrain(ctx, apply_mlp(cfg, p["mlp"], a), bs, None, None)
    for p in params.enc:
        x = remat(ctx, layer, p, x)
    return apply_norm(cfg, params.enc_norm, x)


def _attn_ctx(ctx: ShardCtx | None) -> ShardCtx | None:
    """The ctx the encoder's and the decoder's attention get: the mesh
    alone (no flash kernel, no context parallelism, as the reference's
    attention without a ctx), or None without a mesh."""
    if ctx is None or ctx.mesh is None:
        return None
    return ShardCtx(mesh=ctx.mesh, batch_axes=ctx.batch_axes, model_axis=ctx.model_axis)


def _memory_kv(cfg: ModelConfig, p, memory):
    """One decoder layer's cross-attention K/V of the encoder states,
    ``[B,T,kv_dim]`` each, as projected."""
    return dense(memory, p["xattn"]["wk"]), dense(memory, p["xattn"]["wv"])


def decode_train(cfg: ModelConfig, params: EncDecLM, tokens, memory,
                 ctx: ShardCtx | None = None):
    """Teacher-forced decoder. tokens [B,S]; memory [B,T,D]."""
    bs = batch_spec(ctx)
    x = embed_tokens(params.embed, tokens) + _positions(params.pos_dec, tokens.shape[1])[None]
    # the embedding's rows come batch-sharded (XLA propagates the tokens'
    # sharding; DTensor's embedding rule would shard the rows otherwise)
    x = constrain(ctx, x, bs, None, None)
    actx = _attn_ctx(ctx)

    def layer(p, h, mem):
        a = apply_norm(cfg, p["norm1"], h)
        out = attn.self_attention(cfg, p["attn"], a, causal=True, ctx=actx)
        h = h + constrain(ctx, out, bs, None, None)
        a = apply_norm(cfg, p["norm2"], h)
        out = attn.cross_attention(cfg, p["xattn"], a, _memory_kv(cfg, p, mem), actx)
        h = h + constrain(ctx, out, bs, None, None)
        a = apply_norm(cfg, p["norm3"], h)
        return h + constrain(ctx, apply_mlp(cfg, p["mlp"], a), bs, None, None)
    for p in params.dec:
        x = remat(ctx, layer, p, x, memory)
    return apply_norm(cfg, params.final_norm, x)


def seq2seq_loss(cfg: ModelConfig, params: EncDecLM, batch, ctx: ShardCtx | None = None):
    """batch: frames [B,T,D] (stub), tokens [B,S], labels [B,S]."""
    memory = encode(cfg, params, batch["frames"], ctx)
    h = decode_train(cfg, params, batch["tokens"], memory, ctx)
    logits = constrain(ctx, unembed(cfg, params.embed, h), batch_spec(ctx), None, "model")
    return softmax_xent(logits, batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Self-attn KV cache for the decoder + cross-attn memory K/V."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "self": {"k": torch.zeros(shape, dtype=CDTYPE, device=device),
                 "v": torch.zeros(shape, dtype=CDTYPE, device=device)},
        "mem_kv": None,  # filled by prefill_memory below (shape depends on T)
    }


def prefill_memory(cfg: ModelConfig, params: EncDecLM, frames, ctx: ShardCtx | None = None):
    """Encode audio and precompute cross-attention K/V per decoder layer:
    ([L,B,T,Hkv,Dh], [L,B,T,Hkv,Dh])."""
    memory = encode(cfg, params, frames, ctx)
    B, T, _ = memory.shape

    def heads(t):
        return split_ready(t, -1, cfg.num_kv_heads).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    kvs = [_memory_kv(cfg, p, memory) for p in params.dec]
    return torch.stack([heads(k) for k, _ in kvs]), torch.stack([heads(v) for _, v in kvs])


def decode_step(cfg: ModelConfig, params: EncDecLM, tokens, cache, pos: int,
                ctx: ShardCtx | None = None):
    """One decoder token against cached memory K/V. tokens [B,1]; the
    self-attention cache is written in place."""
    row = min(max(pos, 0), cfg.max_target_len - 1)
    x = embed_tokens(params.embed, tokens) + params.pos_dec[row:row + 1].to(CDTYPE)[None]
    x = constrain(ctx, x, batch_spec(ctx), None, None)   # as decode_train's
    mk, mv = cache["mem_kv"]
    for j, p in enumerate(params.dec):
        a = apply_norm(cfg, p["norm1"], x)
        out, _, _ = attn.decode_attention(cfg, p["attn"], a, cache["self"]["k"][j],
                                          cache["self"]["v"][j], pos, ctx)
        x = x + out
        a = apply_norm(cfg, p["norm2"], x)
        x = x + attn.decode_cross_attention(cfg, p["xattn"], a, (mk[j], mv[j]))
        a = apply_norm(cfg, p["norm3"], x)
        x = x + apply_mlp(cfg, p["mlp"], a)
    x = apply_norm(cfg, params.final_norm, x)
    return unembed(cfg, params.embed, x), cache
