"""Kernel dispatch for the port: by the device of the tensors.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref.py``);
a CUDA tensor goes to the hand-written kernel, which raises if it cannot
launch. There is no environment switch and no fallback: on the card, the
path runs the kernels or fails.
"""
from __future__ import annotations

import torch

from . import ref
from .coarsen_kernels import contract_edges_cuda, hem_propose_cuda
from .flashattn import flash_attention_cuda
from .lp_gain import lp_gain_cuda
from .mapcost import mapcost_cuda
from .powf import powf_cuda, powf_ref
from .split import gather_rows_cuda


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel route for device {t.device}")
    return False


def mapcost(rows, cols, ewgt, pe_of, g_below, dvec) -> torch.Tensor:
    """J(C, D, Pi) over directed edge arrays (padding weight must be 0)."""
    if _on_cuda(rows):
        return mapcost_cuda(rows, cols, ewgt, pe_of, g_below, dvec)
    return ref.mapcost_ref(rows, cols, ewgt, pe_of, g_below, dvec)


def gather_rows(src, idx) -> torch.Tensor:
    """Masked-compaction gather for the split op: out[b,j] = src[clip(idx[b,j])]."""
    if _on_cuda(src):
        return gather_rows_cuda(src, idx)
    return ref.gather_rows_ref(src, idx)


def hem_propose(adj, adw, jit, matched) -> torch.Tensor:
    """Per-row HEM proposal scan over the [N, DEG] ELL adjacency, or over
    every lane of a batch ([B, N, DEG], ``matched`` [B, N]) at once."""
    if _on_cuda(adj):
        return hem_propose_cuda(adj, adw, jit, matched)
    return ref.hem_propose_ref(adj, adw, jit, matched)


def contract_edges(cand, candw):
    """Row-local merge/dedup/accumulate for contraction (sentinel = N),
    over ``cand`` [N, D2] or every lane of a batch, [B, N, D2]."""
    sent = cand.shape[-2]
    if _on_cuda(cand):
        return contract_edges_cuda(cand, candw, sent)
    return ref.contract_edges_ref(cand, candw, sent)


def lp_gain(adj, adw, part, k: int):
    """Per-vertex (conn, best, gain) over the [N, DEG] ELL adjacency, for
    labels ``part`` [N] or [R, N] (the restarts of a partition call); over
    every lane of a batch for ``adj`` [B, N, DEG] and ``part`` [B, R, N]."""
    if _on_cuda(adj):
        return lp_gain_cuda(adj, adw, part, k)
    return ref.lp_gain_ref(adj, adw, part, k)


def flash_attention(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Tiled-softmax SDPA. q [B, S, H, D], k/v [B, S, Hkv, D] -> [B, S, H, D].

    Query head h reads KV head h // (H // Hkv), as the reference's
    ``jnp.repeat`` expands them. On the card the kernel reads this layout in
    place; the plain version expands and flattens the heads itself.
    """
    if _on_cuda(q):
        return flash_attention_cuda(q, k, v, causal, window)
    return ref.flash_bshd_ref(q, k, v, causal, window)


def powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """The C library's ``powf(x, y)`` elementwise on f32 ``x``, ``0 < y < 1``,
    bit for bit (the reference's XLA program calls it on the CPU)."""
    if _on_cuda(x):
        return powf_cuda(x, y)
    return torch.from_numpy(powf_ref(x.numpy(), y)).reshape(x.shape)
