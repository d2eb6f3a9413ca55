"""Gradient compression: int8 error-feedback quantization for slow links
(the port of ``repro/train/compression.py``).

Per-chunk symmetric int8 quantization with error feedback: the residual is
carried to the next step, so nothing is lost over time. ``compressed_psum``
is the error-feedback int8 all-reduce MEAN over the processes of
``torch.distributed`` (the reference's ``psum`` over a pod axis inside
``shard_map``): every process quantizes on one shared grid (an all-reduce
MAX of the per-chunk scales), the int8 payloads sum exactly in int32 (an
all-reduce SUM), and the sum dequantizes with the shared scale: on the
wire one f32 scale a chunk and the int8 payload widened to int32, as the
reference's ``pmax`` and ``psum`` move them. ``reduce_compressed``
is the same reduction as a function of the stacked per-process values
(one process standing for several); without a process group the world
size is 1 and nothing is exchanged.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils._pytree import tree_map

CHUNK = 2048


class CompressionState(NamedTuple):
    residual: Any  # error-feedback residuals, same tree as the gradients


def init_compression_state(grads) -> CompressionState:
    """f32 zero residuals over the gradients' tree."""
    return CompressionState(residual=tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads))


def quantize_int8(x: torch.Tensor, scale: torch.Tensor | None = None):
    """Per-chunk symmetric int8 quantization. Returns (q [chunks, CHUNK]
    int8, scales [chunks] f32). A precomputed ``scale`` (e.g. the max
    across processes) may be passed so the int32 sum of payloads
    dequantizes exactly."""
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % CHUNK
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, CHUNK)
    if scale is None:
        scale = flat.abs().amax(dim=1) / 127.0
    q = torch.clamp(torch.round(flat / torch.clamp_min(scale[:, None], 1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = q.float() * scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return flat.reshape(-1)[:n].reshape(shape)


def compress_with_feedback(g: torch.Tensor, residual: torch.Tensor, scale=None):
    """(quantized payload, new residual). dequantize(payload) + residual' == g + residual."""
    target = g.float() + residual
    q, scale = quantize_int8(target, scale)
    approx = dequantize_int8(q, scale, g.shape)
    return (q, scale), target - approx


def reduce_compressed(g: torch.Tensor, residual: torch.Tensor):
    """The compressed mean over the leading axis of ``g`` and ``residual``
    ([P, ...], one row per process): (means [P, ...], new residuals
    [P, ...]), every row of ``means`` the same. Row i is what process i
    gets from ``compressed_psum``."""
    P = g.shape[0]
    local = torch.stack([quantize_int8(g[i].float() + residual[i])[1] for i in range(P)])
    shared = local.amax(dim=0)                       # the pmax of the scales
    qs, res = zip(*(compress_with_feedback(g[i], residual[i], shared) for i in range(P)))
    qsum = torch.stack([q for q, _ in qs]).to(torch.int32).sum(dim=0)
    out = dequantize_int8(qsum, shared, g.shape[1:]) / P
    return out.to(g.dtype).expand(g.shape).clone(), torch.stack(res)


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, group=None):
    """Error-feedback int8 all-reduce MEAN over the processes of ``group``
    (``torch.distributed``'s default group when it is initialized; else
    this process alone). Returns (mean, new residual).

    The reference's wire format: an all-reduce MAX of the local per-chunk
    scales (f32, one a chunk), then an all-reduce SUM of the int8 payloads
    as int32, which is exact: the result is ``reduce_compressed`` of every
    process's values, bit for bit."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        out, res = reduce_compressed(g[None], residual[None])
        return out[0], res[0]
    _, scale = quantize_int8(g.float() + residual)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    (q, scale), res = compress_with_feedback(g, residual, scale)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    out = dequantize_int8(qsum, scale, g.shape) / dist.get_world_size(group)
    return out.to(g.dtype), res
