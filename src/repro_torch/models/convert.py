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
caller converts its arrays with ``np.asarray``. ``to_reference_tree`` goes
the other way (the checkpoint writes the reference's layout with it).
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
    """``params`` as nested dicts of arrays -> the port's params on ``device``.
    The MoE's expert leaves ``[V, E_loc, ...]`` come across at the V they
    were made for (``moe_virtual_shards``)."""
    dev = resolve_device(device)
    if cfg.is_encoder_decoder:
        model = EncDecLM(cfg, device="meta")
    else:
        model = DecoderLM(cfg, device="meta", V=moe_virtual_shards(params))
    leaves = set()
    for name, w in list(model.named_parameters()):
        path, _ = reference_path(name)
        src = reference_leaf(params, name)
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


def moe_virtual_shards(tree) -> int:
    """V of the reference's params: dim -4 of an MoE ``w_gate`` leaf (``[..,
    V, E_loc, D, F_v]``), 1 without one."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "moe" and isinstance(v, dict) and "w_gate" in v:
                return int(np.shape(v["w_gate"])[-4])
            got = moe_virtual_shards(v)
            if got != 1:
                return got
    return 1


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def reference_path(name: str) -> tuple[list[str], int | None]:
    """The reference's key path of the port's parameter ``name`` and the
    layer index along its stacked leading axis (``None`` if unstacked):
    ``<stack>.<i>.<path>`` is ``<stack>/<path>`` [i]; any other name is its
    own path."""
    parts = name.split(".")
    if len(parts) > 1 and parts[1].isdigit():
        return [parts[0]] + parts[2:], int(parts[1])
    return parts, None


def reference_leaf(tree, name: str) -> np.ndarray:
    """The slice of the reference's nested dicts ``tree`` that the port's
    parameter ``name`` holds."""
    path, i = reference_path(name)
    for key in path:
        tree = tree[key]
    tree = np.asarray(tree)
    return tree[i] if i is not None else tree


def to_reference_tree(named: dict) -> dict:
    """Tensors keyed by the port's parameter names (``named_parameters()``,
    or the optimizer's ``mu``/``nu``) -> the reference's nested dicts of
    numpy arrays, each stacked leaf stacked again along axis 0."""
    stacks: dict[tuple, dict[int, np.ndarray]] = {}
    tree: dict = {}
    for name, w in named.items():
        path, i = reference_path(name)
        a = host_array(w)
        if i is None:
            _put(tree, path, a)
        else:
            stacks.setdefault(tuple(path), {})[i] = a
    for path, layers in stacks.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"{'/'.join(path)}: layers {sorted(layers)} are not 0..L-1")
        _put(tree, list(path), np.stack([layers[i] for i in range(len(layers))]))
    return tree


def host_array(w) -> np.ndarray:
    """A host copy of ``w``: a tensor (a DTensor gathered whole first) or
    an array."""
    if not isinstance(w, torch.Tensor):
        return np.asarray(w)
    if hasattr(w, "full_tensor"):
        w = w.full_tensor()
    return w.detach().to("cpu", copy=True).numpy()


def _put(tree: dict, path: list[str], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value
