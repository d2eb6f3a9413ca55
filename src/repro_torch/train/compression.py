"""Gradient compression: int8 error-feedback quantization for slow links
(the port of ``repro/train/compression.py``).

Per-chunk symmetric int8 quantization with error feedback: the residual is
carried to the next step, so nothing is lost over time. ``compressed_psum``
is the error-feedback int8 all-reduce MEAN over the processes of
``torch.distributed`` (the reference's ``psum`` over a pod axis inside
``shard_map``): every process quantizes on one shared grid (the max of the
per-chunk scales), the int8 payloads sum exactly in int32, and the sum
dequantizes with the shared scale. The reduction itself is
``reduce_compressed``, a function of the stacked per-process values, so it
runs the same whether the values came from an ``all_gather`` or from one
process standing for several; without a process group the world size is 1
and nothing is exchanged. The gather moves the f32 values, so the int8
wire format shows in the arithmetic here, not yet in the traffic.
"""
from __future__ import annotations

import torch

CHUNK = 2048


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
    this process alone). Returns (mean, new residual)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        out, res = reduce_compressed(g[None], residual[None])
        return out[0], res[0]
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    gs = [torch.empty_like(g) for _ in range(world)]
    rs = [torch.empty_like(residual) for _ in range(world)]
    dist.all_gather(gs, g.contiguous(), group=group)
    dist.all_gather(rs, residual.contiguous(), group=group)
    out, res = reduce_compressed(torch.stack(gs), torch.stack(rs))
    return out[rank], res[rank]
