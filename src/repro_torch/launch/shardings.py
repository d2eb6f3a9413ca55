"""Param, batch and cache specs (FSDP(data) x TP(model) baseline), and
their DTensor placements (the port of ``repro/launch/shardings.py``).

DESIGN.md §5: weights are 2D-sharded ('data', 'model') (ZeRO-3 gather per
layer), activations batch-sharded over ('pod', 'data'), attention heads /
d_ff / vocab sharded over 'model' (Megatron TP). xLSTM (125M) replicates
weights; see DESIGN.md §6.

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dim, ``None``, an axis name, or a tuple of axis names (major
first). The rule tables name the reference's STACKED key paths
(``blocks/attn/wq`` with a leading layer dim); the port holds one module
per layer, so ``param_specs`` names each port leaf by its reference path
(``models.convert.reference_path``), takes the reference's spec at the
stacked rank and drops the stacked dim. ``cache_specs`` walks the port's
cache (the reference's layout) with the reference's key paths.
``models.sharding.spec_placements`` turns a spec into placements;
``sanitize_spec`` first drops an axis that does not divide its dim, as
XLA's specs require (DTensor would shard unevenly).
"""
from __future__ import annotations

import re
from typing import NamedTuple

import torch

from ..models.config import ModelConfig
from ..models.convert import reference_path
from ..models.sharding import ShardCtx, axis_size, batch_spec, spec_placements

# (regex over path, base spec for the UNSTACKED leaf, trailing dims it names)
_RULES: list[tuple[str, tuple]] = [
    (r"embed/tok$", ("model", "data")),
    (r"embed/out$", ("data", "model")),
    (r"pos_(enc|dec)$", (None, None)),
    (r"patch_proj$", (None, None)),
    (r"(attn|xattn)/w[qkv]$", ("data", "model")),
    (r"(attn|xattn)/wo$", ("model", "data")),
    (r"(attn|xattn)/b[qkv]$", ("model",)),
    (r"mlp/w_(gate|up)$", ("data", "model")),
    (r"mlp/w_down$", ("model", "data")),
    (r"mlp/b_up$", ("model",)),
    (r"mlp/b_down$", (None,)),
    (r"moe/router$", (None, None)),
    (r"moe/w_(gate|up)$", ("model", None, "data", None)),
    (r"moe/w_down$", ("model", None, None, "data")),
    (r"mamba/in_proj$", ("data", "model")),
    (r"mamba/out_proj$", ("model", "data")),
    (r"mamba/conv_w$", (None, "model")),
    (r"mamba/w_[BC]$", ("model", None)),
    (r"mamba/w_dt$", ("model", None)),
    (r"mamba/(b_dt|A_log|D_skip)$", (None,)),
    # xLSTM (small model): replicated weights
    (r"(mlstm|slstm)/", ()),
    (r"norm", ()),  # norm vectors replicated
]

# TP2D ("resident weights", serving): every weight matrix is sharded over
# BOTH axes jointly on its TP dimension: no per-layer ZeRO all-gather, only
# the small per-layer activation all-reduce.
_BOTH = ("data", "model")
_RULES_TP2D: list[tuple[str, tuple]] = [
    (r"embed/tok$", (_BOTH, None)),
    (r"embed/out$", (None, _BOTH)),
    (r"pos_(enc|dec)$", (None, None)),
    (r"patch_proj$", (None, None)),
    (r"(attn|xattn)/w[qkv]$", (None, _BOTH)),
    (r"(attn|xattn)/wo$", (_BOTH, None)),
    (r"(attn|xattn)/b[qkv]$", (_BOTH,)),
    (r"mlp/w_(gate|up)$", (None, _BOTH)),
    (r"mlp/w_down$", (_BOTH, None)),
    (r"mlp/b_up$", (_BOTH,)),
    (r"mlp/b_down$", (None,)),
    (r"moe/router$", (None, None)),
    (r"moe/w_(gate|up)$", ("model", None, "data", None)),
    (r"moe/w_down$", ("model", None, None, "data")),
    (r"mamba/in_proj$", (None, _BOTH)),
    (r"mamba/out_proj$", (_BOTH, None)),
    (r"mamba/conv_w$", (None, _BOTH)),
    (r"mamba/w_[BC]$", (_BOTH, None)),
    (r"mamba/w_dt$", (_BOTH, None)),
    (r"mamba/(b_dt|A_log|D_skip)$", (None,)),
    (r"(mlstm|slstm)/", ()),
    (r"norm", ()),
]

# SEQPAR (sequence parallelism, dense archs): activations shard over
# (batch x sequence); weights ZeRO-shard over `data` only and replicate
# over `model`.
_RULES_SEQPAR: list[tuple[str, tuple]] = [
    (r"embed/tok$", (None, "data")),
    (r"embed/out$", ("data", None)),
    (r"pos_(enc|dec)$", (None, None)),
    (r"patch_proj$", (None, None)),
    (r"(attn|xattn)/w[qkvo]$", ("data", None)),
    (r"(attn|xattn)/b[qkv]$", (None,)),
    (r"mlp/w_(gate|up|down)$", ("data", None)),
    (r"mlp/b_(up|down)$", (None,)),
    (r"moe/router$", (None, None)),
    (r"moe/w_(gate|up)$", ("model", None, "data", None)),
    (r"moe/w_down$", ("model", None, None, "data")),
    (r"mamba/(in_proj|out_proj)$", ("data", None)),
    (r"mamba/conv_w$", (None, None)),
    (r"mamba/w_[BC]$", ("data", None)),
    (r"mamba/w_dt$", ("data", None)),
    (r"mamba/(b_dt|A_log|D_skip)$", (None,)),
    (r"(mlstm|slstm)/", ()),
    (r"norm", ()),
]

_MODE_RULES = {"fsdp": _RULES, "tp2d": _RULES_TP2D, "seqpar": _RULES_SEQPAR}


def spec_for(path: str, ndim: int, mode: str = "fsdp") -> tuple:
    """The reference's spec of the leaf at key path ``path`` (stacked, as
    the reference names it) of rank ``ndim``."""
    for pat, base in _MODE_RULES[mode]:
        if re.search(pat, path):
            if len(base) > ndim:
                base = base[len(base) - ndim:]
            return (None,) * (ndim - len(base)) + tuple(base)
    return (None,) * ndim


def leaf_spec(name: str, ndim: int, mode: str = "fsdp") -> tuple:
    """The spec of the port's parameter ``name`` (rank ``ndim``): the
    reference's spec of its stacked leaf, without the stacked dim."""
    path, layer = reference_path(name)
    if layer is None:
        return spec_for("/".join(path), ndim, mode)
    return spec_for("/".join(path), ndim + 1, mode)[1:]


def param_specs(params, mode: str = "fsdp") -> dict:
    """{port parameter name: spec} of ``params`` (a model or a dict)."""
    named = (dict(params.named_parameters()) if isinstance(params, torch.nn.Module)
             else dict(params))
    return {name: leaf_spec(name, w.dim(), mode) for name, w in named.items()}


class Sharding(NamedTuple):
    """Where a tensor lives: the counterpart of a ``NamedSharding``."""
    mesh: object
    placements: tuple


def param_shardings(params, mesh, mode: str = "fsdp") -> dict:
    """{port parameter name: ``Sharding`` on ``mesh``} (sanitized specs)."""
    named = (dict(params.named_parameters()) if isinstance(params, torch.nn.Module)
             else dict(params))
    return {name: Sharding(mesh, tuple(spec_placements(
                sanitize_spec(spec, named[name].shape, mesh), mesh)))
            for name, spec in param_specs(named, mode).items()}


def tree_paths(tree, prefix: str = ""):
    """(key path, leaf) of a nested dict/tuple of tensors, with JAX's path
    names: dict keys in sorted order, tuple items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def tree_map(fn, tree, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


def batch_specs(cfg: ModelConfig, batch_tree, ctx: ShardCtx) -> dict:
    """{key path: spec} of a batch: dim 0 over the batch axes."""
    bs = batch_spec(ctx)
    return {path: (bs,) + (None,) * (leaf.dim() - 1) for path, leaf in tree_paths(batch_tree)}


def cache_specs(cfg: ModelConfig, cache_tree, ctx: ShardCtx) -> dict:
    """{key path: spec} of a decode cache. KV caches: batch over data axes, kv heads over model; SSM states:
    batch over data, heads over model (hybrid) or replicated (xlstm)."""
    bs = batch_spec(ctx)
    msize = ctx.model_size

    def one(p, leaf):
        nd = leaf.dim()
        if re.search(r"(^|/)(k|v)$", p) or "mem_kv" in p:
            # [L?, B, S, Hkv, Dh]: kv heads over `model` when they divide it;
            # otherwise the sequence (flash-decode style)
            H, S = leaf.shape[-2], leaf.shape[-3]
            if H % msize == 0:
                base = (bs, None, "model", None)
            elif S % msize == 0:
                base = (bs, "model", None, None)
            else:
                base = (bs, None, None, None)
        elif re.search(r"/h$", p) and nd >= 4:      # mamba h [.., B, H, N, P]
            base = (bs, "model", None, None)
        elif re.search(r"/conv$", p):               # [.., B, K-1, d_in]
            base = (bs, None, "model")
        else:
            # xlstm states and misc: batch over data only (batch dim 0)
            return (bs,) + (None,) * (nd - 1)
        return (None,) * (nd - len(base)) + base

    return {path: one(path, leaf) for path, leaf in tree_paths(cache_tree)}


def sanitize_spec(spec: tuple, shape, mesh) -> tuple:
    """Drop axis names on dims they do not evenly divide (whisper's odd
    vocab 51865 cannot be vocab-parallel over 16 devices; that dim falls
    back to replicated)."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        size = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            size *= axis_size(mesh, a)
        out.append(entry if shape[i] % size == 0 else None)
    return tuple(out)


def local_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    """The shard shape of a ``shape`` tensor under a sanitized ``spec``."""
    out = list(shape)
    for i, entry in enumerate(spec):
        for a in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            out[i] //= axis_size(mesh, a)
    return tuple(out)


def to_meta(t: torch.Tensor, spec: tuple, mesh):
    """A meta DTensor of ``t``'s shape and dtype on ``mesh``, placed as the
    sanitized ``spec`` says (the counterpart of the reference's ``to_sds``:
    a stand-in that allocates nothing)."""
    from torch.distributed.tensor import DTensor
    spec = sanitize_spec(spec, t.shape, mesh)
    local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype, device="meta")
    return DTensor.from_local(local, mesh, spec_placements(spec, mesh), run_check=False,
                              shape=t.shape, stride=_contiguous_stride(t.shape))


def distribute(t: torch.Tensor, spec: tuple, mesh):
    """``t`` (the same full value on every rank) as a DTensor placed as the
    sanitized ``spec`` says: each rank keeps its own shard, no collective."""
    from torch.distributed.tensor import distribute_tensor
    spec = sanitize_spec(spec, t.shape, mesh)
    return distribute_tensor(t, mesh, spec_placements(spec, mesh), src_data_rank=None)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(s)
    return tuple(reversed(stride))


def shard_state(state, mesh, mode: str = "fsdp"):
    """A ``TrainState`` with its params and moments placed on ``mesh`` by
    ``param_specs`` (each rank keeps its shards); the step stays."""
    from ..train.optimizer import OptState
    shard_params(state.params, mesh, mode)
    specs = param_specs(state.params, mode)
    mu, nu = ({k: distribute(t, specs[k], mesh) for k, t in d.items()}
              for d in (state.opt.mu, state.opt.nu))
    return state._replace(opt=OptState(state.opt.step, mu, nu))


def shard_params(params: torch.nn.Module, mesh, mode: str = "fsdp",
                 meta: bool = False) -> torch.nn.Module:
    """Every parameter of ``params`` replaced, in place, by a DTensor
    parameter placed by ``param_specs`` on ``mesh``: shards of its values
    (``distribute``), or meta stand-ins (``meta``)."""
    from ..models.transformer import set_param
    place = to_meta if meta else distribute
    specs = param_specs(params, mode)
    for name, w in list(params.named_parameters()):
        with torch.no_grad():
            d = place(w.detach(), specs[name], mesh)
        set_param(params, name, torch.nn.Parameter(d, requires_grad=w.requires_grad))
    return params


def place_tree(tree, specs: dict, mesh, meta: bool = False):
    """A batch or cache tree as DTensors placed by ``specs`` ({key path:
    spec}, as ``batch_specs``/``cache_specs`` give)."""
    place = to_meta if meta else distribute
    return tree_map(lambda path, leaf: place(leaf, specs[path], mesh), tree)
