"""Batched serving engine: prefill + decode with a KV cache.

The port of ``repro/serve/engine.py``. As in the reference, a request's
prompt is stepped through ``decode_fn`` one position at a time (exact with
the cache), then the engine decodes greedily or samples at a temperature.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models import model as M
from ..models.config import ModelConfig
from ..models.layers import CDTYPE
from ..models.sharding import ShardCtx
from ..models.transformer import cast_matrices


@dataclasses.dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens: int = 0

    @property
    def tok_per_s(self) -> float:
        return self.tokens / self.decode_s if self.decode_s else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 ctx: ShardCtx | None = None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.ctx = ctx
        self.device = params.device
        # The weight matrices in the compute dtype, cast once: the same
        # values the reference casts inside every jitted decode step (every
        # family uses each matrix only after a cast to it). Vectors (norms,
        # biases, gates) stay f32, as the functions use them.
        self._cparams = cast_matrices(params, CDTYPE)

    def generate(self, prompts: np.ndarray, steps: int, temperature: float = 0.0,
                 seed: int = 0) -> tuple[np.ndarray, ServeStats]:
        """prompts [B, P] int -> generated [B, steps] int32.

        ``temperature > 0`` samples from softmax(logits / temperature) with
        a ``torch.Generator`` seeded by ``seed`` on the engine's device."""
        cfg, dev = self.cfg, self.device
        B, P = prompts.shape
        stats = ServeStats()
        cache = M.init_cache(cfg, B, self.max_len, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64, device=dev)

        _sync(dev)
        t0 = time.perf_counter()
        logits = None
        for i in range(P):
            logits, cache = M.decode_fn(cfg, self._cparams, toks[:, i:i + 1], cache, i,
                                        self.ctx)
        _sync(dev)
        stats.prefill_s = time.perf_counter() - t0

        out = []
        t0 = time.perf_counter()
        last = torch.argmax(logits[:, -1], dim=-1)[:, None]
        for i in range(steps):
            logits, cache = M.decode_fn(cfg, self._cparams, last, cache, P + i, self.ctx)
            if temperature > 0:
                probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
                last = torch.multinomial(probs, 1, generator=gen)
            else:
                last = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(last)
        result = torch.cat(out, dim=1).to(torch.int32).cpu().numpy() if out else \
            np.zeros((B, 0), np.int32)
        _sync(dev)
        stats.decode_s = time.perf_counter() - t0
        stats.tokens = B * steps
        return result, stats

