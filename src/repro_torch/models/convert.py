"""Weights from the JAX package into the port.

``params_from_jax`` takes the params pytree of ``repro.models.model.init_fn``
(or a trained one) as nested dicts of numpy arrays and returns the port's
``DecoderLM``. The reference stacks each block's leaves along a leading
``[L, ...]`` axis; the port holds one ``Block`` per layer, so every stacked
leaf is split along axis 0. Weight matrices keep the reference's ``[in,
out]`` layout (the port applies them as ``x @ w``), so none is transposed.
Nothing here imports JAX: the caller converts its arrays with ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.graph import resolve_device
from .config import ModelConfig
from .layers import param
from .transformer import DecoderLM


def params_from_jax(cfg: ModelConfig, params, device=None) -> DecoderLM:
    """``params`` as nested dicts of arrays -> ``DecoderLM`` on ``device``."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, device="meta")
    for name, w in list(model.named_parameters()):
        parts = name.split(".")
        if parts[0] == "blocks":   # blocks.<i>.<group>.<leaf> <- blocks[group][leaf][i]
            src = np.asarray(params["blocks"][parts[2]][parts[3]])[int(parts[1])]
        else:                      # <group>.<leaf>
            src = np.asarray(params[parts[0]][parts[1]])
        if tuple(src.shape) != tuple(w.shape):
            raise ValueError(f"{name}: reference shape {src.shape}, port {tuple(w.shape)}")
        mod, leaf = name.rsplit(".", 1)
        model.get_submodule(mod)[leaf] = param(
            torch.as_tensor(np.array(src, dtype=np.float32), device=dev))
    # every leaf of the reference must have been taken (one per stacked leaf)
    names = {n.split(".", 2)[2] if n.startswith("blocks.") else n
             for n, _ in model.named_parameters()}
    n_ref = sum(1 for _ in _leaves(params))
    if n_ref != len(names):
        raise ValueError(f"the reference's params hold {n_ref} leaves, the port's "
                         f"{cfg.name} has {len(names)}")
    return model


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
