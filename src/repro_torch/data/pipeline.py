"""Deterministic synthetic data pipeline (the port of
``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step, arch): after a restart at
step s the pipeline regenerates precisely the batches s, s+1, ... The
numbers are drawn with numpy exactly as the reference draws them, so a
batch equals the reference's bit for bit; only the container differs:
torch tensors on ``device`` (int32 ``tokens`` and ``labels``, bf16
``frames`` and ``patch_embeds``).

The stream is a mixture of Zipf-distributed tokens with induced bigram
structure, so small models actually learn (loss decreases).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.graph import resolve_device
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0


def _batch_tokens(cfg: ModelConfig, dc: DataConfig, step: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng((dc.seed * 1_000_003 + step) & 0xFFFFFFFF)
    B, S = dc.global_batch, dc.seq_len
    V = cfg.vocab_size
    # zipf-ish marginal
    base = rng.zipf(1.5, size=(B, S + 1)).astype(np.int64)
    base = np.clip(base, 1, V - 1)
    # induced structure: with p=0.5, next token = f(prev) (learnable bigram)
    follow = (base[:, :-1] * 2654435761 + 12345) % V
    coin = rng.random((B, S)) < 0.5
    seq = np.where(coin, follow, base[:, 1:])
    seq = np.concatenate([base[:, :1], seq[:, :-1]], axis=1)
    labels = np.where(coin, follow, base[:, 1:])
    return seq.astype(np.int32), labels.astype(np.int32)


def _bf16(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(a).to(dev).to(torch.bfloat16)


def make_batch(cfg: ModelConfig, dc: DataConfig, step: int, device=None) -> dict:
    """The batch of ``step`` on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    tokens, labels = _batch_tokens(cfg, dc, step)
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    if cfg.frontend == "vision_stub":
        rng = np.random.default_rng(dc.seed * 7 + step)
        batch["patch_embeds"] = _bf16(
            rng.standard_normal((dc.global_batch, cfg.num_patches, cfg.d_model),
                                np.float32) * 0.02, dev)
    if cfg.is_encoder_decoder:
        rng = np.random.default_rng(dc.seed * 13 + step)
        batch["frames"] = _bf16(
            rng.standard_normal((dc.global_batch, dc.seq_len, cfg.d_model),
                                np.float32) * 0.02, dev)
        tgt = min(dc.seq_len, cfg.max_target_len)
        batch["tokens"] = batch["tokens"][:, :tgt]
        batch["labels"] = batch["labels"][:, :tgt]
    return batch


def host_shard(batch: dict, host_id: int, num_hosts: int) -> dict:
    """The slice of the global batch this host feeds (multi-host deployments)."""
    def slc(x):
        per = x.shape[0] // num_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: slc(v) for k, v in batch.items()}
