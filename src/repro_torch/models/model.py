"""Family dispatch: the serving API over the port's model zoo.

    init_fn(cfg, generator)                        -> params (DecoderLM)
    prefill_fn(cfg, params, batch, ctx)            -> last-position logits
    init_cache(cfg, batch, max_len, device)        -> KV cache
    decode_fn(cfg, params, tokens, cache, pos, ctx) -> (logits, cache)

The port of ``repro/models/model.py`` for the dense family. The other
families raise ``NotImplementedError`` (ROADMAP.md, Queue 1, item 7, "The
rest of ``models/``"); ``loss_fn`` (training), ``input_specs`` and
``scan_trip_hints`` (the JAX dry-run) are not ported.
"""
from __future__ import annotations

import torch

from ..core.graph import resolve_device
from . import transformer as tfm
from .config import ModelConfig
from .sharding import ShardCtx


def init_fn(cfg: ModelConfig, generator: torch.Generator | int = 0,
            device=None) -> tfm.DecoderLM:
    """Random params drawn from ``generator`` (a ``torch.Generator`` on the
    target device, or an int seed for one made on ``device``; ``None`` =
    the card, which must exist)."""
    tfm.check_dense(cfg)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=resolve_device(device)).manual_seed(generator)
    return tfm.init_params(cfg, generator)


@torch.no_grad()
def prefill_fn(cfg: ModelConfig, params, batch, ctx: ShardCtx | None = None):
    """``batch["tokens"]`` [B, S] int -> last-position logits [B, 1, V]."""
    tfm.check_dense(cfg)
    return tfm.prefill(cfg, params, batch, ctx)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    tfm.check_dense(cfg)
    return tfm.init_cache(cfg, batch, max_len, resolve_device(device))


@torch.no_grad()
def decode_fn(cfg: ModelConfig, params, tokens, cache, pos: int,
              ctx: ShardCtx | None = None):
    """tokens [B, 1] at position ``pos`` -> (logits [B, 1, V], cache); the
    cache is updated in place."""
    tfm.check_dense(cfg)
    return tfm.decode_step(cfg, params, tokens, cache, int(pos), ctx)
