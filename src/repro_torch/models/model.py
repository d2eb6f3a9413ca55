"""Family dispatch: one API over the port's whole model zoo.

    init_fn(cfg, generator, device, V)             -> params (DecoderLM | EncDecLM)
    loss_fn(cfg, params, batch, ctx)               -> scalar (train objective)
    prefill_fn(cfg, params, batch, ctx)            -> last-position logits
                                                      (whisper: memory K/V)
    init_cache(cfg, batch, max_len, device, V)     -> decode cache
    decode_fn(cfg, params, tokens, cache, pos, ctx) -> (logits, cache)
    input_specs(cfg, seq_len, global_batch, mode)  -> meta-tensor stand-ins
    scan_trip_hints(cfg, seq_len, mode)            -> while-loop trip counts

The port of ``repro/models/model.py``: every family, on one device or,
under a ``ShardCtx`` with a mesh, as eager SPMD on DTensor params and
inputs (``launch/shardings.py`` places them).
``loss_fn`` is differentiable (grad mode follows the caller, as the
reference's ``loss_fn`` is a plain function that ``jax.value_and_grad``
differentiates; ``train/train_step.py``); the serving entry points run
under ``torch.no_grad()``.
"""
from __future__ import annotations

import torch

from ..core.graph import resolve_device
from . import transformer as tfm
from . import whisper as wsp
from .config import ModelConfig
from .layers import CDTYPE
from .sharding import ShardCtx, on_mesh


def init_fn(cfg: ModelConfig, generator: torch.Generator | int = 0, device=None,
            V: int = 1):
    """Random params drawn from ``generator`` (a ``torch.Generator`` on the
    target device, or an int seed for one made on ``device``; ``None`` =
    the card, which must exist). ``V``: the MoE's virtual expert shards
    (the model axis' size; ``moe.moe_layout``)."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=resolve_device(device)).manual_seed(generator)
    if cfg.is_encoder_decoder:
        return wsp.init_params(cfg, generator)
    return tfm.init_params(cfg, generator, V=V)


def loss_fn(cfg: ModelConfig, params, batch, ctx: ShardCtx | None = None):
    """Mean next-token cross-entropy (f32 scalar) of ``batch`` (``tokens``,
    ``labels``; ``frames`` or ``patch_embeds`` for the stub frontends).
    Under a mesh ctx it is a replicated DTensor scalar."""
    with on_mesh(ctx):
        if cfg.is_encoder_decoder:
            return wsp.seq2seq_loss(cfg, params, batch, ctx)
        return tfm.lm_loss(cfg, params, batch, ctx)


@torch.no_grad()
def prefill_fn(cfg: ModelConfig, params, batch, ctx: ShardCtx | None = None):
    """``batch["tokens"]`` [B, S] int -> last-position logits [B, 1, V];
    for the encoder-decoder ``batch["frames"]`` [B, T, D] -> the decoder's
    cross-attention K/V, each [L, B, T, Hkv, Dh]."""
    with on_mesh(ctx):
        if cfg.is_encoder_decoder:
            return wsp.prefill_memory(cfg, params, batch["frames"], ctx)
        return tfm.prefill(cfg, params, batch, ctx)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None, V: int = 1):
    """The decode cache (``V`` is the reference's argument; no cache leaf
    depends on it)."""
    dev = resolve_device(device)
    if cfg.is_encoder_decoder:
        cache = wsp.init_cache(cfg, batch, min(max_len, cfg.max_target_len), device=dev)
        # cross-attn memory of `max_len` encoder frames
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        cache["mem_kv"] = (torch.zeros(shape, dtype=CDTYPE, device=dev),
                           torch.zeros(shape, dtype=CDTYPE, device=dev))
        return cache
    return tfm.init_cache(cfg, batch, max_len, dev)


@torch.no_grad()
def decode_fn(cfg: ModelConfig, params, tokens, cache, pos: int,
              ctx: ShardCtx | None = None):
    """tokens [B, 1] at position ``pos`` -> (logits [B, 1, V], cache); the
    cache is updated in place."""
    with on_mesh(ctx):
        if cfg.is_encoder_decoder:
            return wsp.decode_step(cfg, params, tokens, cache, int(pos), ctx)
        return tfm.decode_step(cfg, params, tokens, cache, int(pos), ctx)


# ---------------------------------------------------------------------------
# dry-run stand-ins
# ---------------------------------------------------------------------------

def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, seq_len: int, global_batch: int, mode: str):
    """Meta-tensor stand-ins for every model input (no allocation), with
    the reference's shapes and dtypes.

    mode: train | prefill | decode  (decode: one token + cache of seq_len)
    """
    B, S = global_batch, seq_len
    i32 = torch.int32
    if mode in ("train", "prefill"):
        if cfg.is_encoder_decoder:
            tgt = min(S, cfg.max_target_len) if mode == "prefill" else min(S, 4096)
            return {
                "frames": _spec((B, S, cfg.d_model), CDTYPE),
                "tokens": _spec((B, tgt), i32),
                "labels": _spec((B, tgt), i32),
            }
        if cfg.frontend == "vision_stub":
            s_txt = S - cfg.num_patches
            return {
                "tokens": _spec((B, s_txt), i32),
                "labels": _spec((B, s_txt), i32),
                "patch_embeds": _spec((B, cfg.num_patches, cfg.d_model), CDTYPE),
            }
        return {"tokens": _spec((B, S), i32), "labels": _spec((B, S), i32)}
    if mode == "decode":
        return {"tokens": _spec((B, 1), i32)}
    raise ValueError(mode)


def scan_trip_hints(cfg: ModelConfig, seq_len: int, mode: str,
                    slstm_chunk: int = 1) -> list[int]:
    """Trip counts of the reference's ``while`` loops of a lowered step, in
    nesting order (depth 1 first); see DESIGN.md §7."""
    if cfg.is_encoder_decoder:
        return [cfg.encoder_layers, cfg.num_layers]
    if cfg.family == "hybrid":
        return [cfg.num_layers // cfg.attn_period]
    if cfg.family == "ssm":
        # unrolled layers; each sLSTM block is one depth-1 time scan
        return [max(seq_len // max(slstm_chunk, 1), 1) if mode != "decode" else 1]
    return [cfg.num_layers]
