"""Weights from the JAX package into the port.

``params_from_jax`` takes the params pytree of ``repro.models.model.init_fn``
(or a trained one) as nested dicts of numpy arrays and returns the port's
``DecoderLM`` (``whisper.EncDecLM`` for the encoder-decoder). The reference
stacks each layer's leaves along a leading axis (``blocks``; the hybrid's
``blocks.sub{i}`` over its super-blocks; whisper's ``enc`` and ``dec``);
the port holds one module per layer, so every stacked leaf is split along
axis 0. The xLSTM stack (``layer{i}``) and the other leaves (``embed``,
norms, ``patch_proj``, ``pos_enc``, ``pos_dec``) are copied as they are.
Weight matrices keep the reference's ``[in, out]`` layout (the port applies
them as ``x @ w``), so none is transposed. Nothing here imports JAX: the
caller converts its arrays with ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.graph import resolve_device
from .config import ModelConfig
from .layers import param
from .transformer import DecoderLM, set_param
from .whisper import EncDecLM


def params_from_jax(cfg: ModelConfig, params, device=None):
    """``params`` as nested dicts of arrays -> the port's params on ``device``."""
    dev = resolve_device(device)
    model = (EncDecLM if cfg.is_encoder_decoder else DecoderLM)(cfg, device="meta")
    leaves = set()
    for name, w in list(model.named_parameters()):
        parts = name.split(".")
        # <stack>.<i>.<path> <- <stack>[<path>][i]; any other name <- its path
        stacked = len(parts) > 1 and parts[1].isdigit()
        path = [parts[0]] + parts[2:] if stacked else parts
        src = params
        for key in path:
            src = src[key]
        src = np.asarray(src)
        if stacked:
            src = src[int(parts[1])]
        if tuple(src.shape) != tuple(w.shape):
            raise ValueError(f"{name}: reference shape {src.shape}, port {tuple(w.shape)}")
        set_param(model, name, param(torch.as_tensor(np.array(src, dtype=np.float32),
                                                     device=dev)))
        leaves.add(".".join(path))
    # every leaf of the reference must have been taken (one per stacked leaf)
    n_ref = sum(1 for _ in _leaves(params))
    if n_ref != len(leaves):
        raise ValueError(f"the reference's params hold {n_ref} leaves, the port's "
                         f"{cfg.name} has {len(leaves)}")
    return model


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
