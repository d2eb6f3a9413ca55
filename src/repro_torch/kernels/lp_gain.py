"""CUDA kernel for label-propagation gains: ``csrc/lp_gain.cu``.

``lp_gain_cuda`` replaces the TPU kernel
``repro/kernels/lp_gain.py:lp_gain_pallas`` and computes, in one launch for
all R restarts of every lane of a batch, what its body computes (the
reference vmaps it over the lanes of a dispatch, which puts a lane axis in
its grid): per vertex the connectivity to each block, the best other block
and its gain. Each row's ELL ids and weights are
read once for all restarts, and every sum runs in slot order, so the result
is bitwise the plain version ``kernels/ref.py:lp_gain_ref``.
"""
from __future__ import annotations

import torch

from . import _build

MAX_DEG = 64   # a row's live slots are one 64-bit mask
MAX_K = 64     # at most 64 sums per thread in shared memory
MAX_LANES = 65535   # the lanes are the grid's y axis


def lp_gain_cuda(adj, adw, part, k: int):
    """``(conn [R, N, k] f32, best [R, N] i32, gain [R, N] f32)`` for the
    ELL adjacency ``adj``/``adw`` ``[N, DEG]`` and labels ``part`` ``[R, N]``
    (or ``[N]``, giving outputs without the ``R`` axis). The lanes of a
    batch take ``adj``/``adw`` ``[B, N, DEG]`` and ``part`` ``[B, R, N]``
    (ids lane-local) and give ``[B, R, ...]``, all in one launch; B = 1 is
    the launch of one graph.

    Padding slots (``adj >= N``) are skipped, as the TPU kernel's body does.
    The JAX package's plain version instead counts them in block 0 with
    their weight; the two agree because ``ell_adjacency`` writes weight 0 on
    every padding slot.
    """
    _build.require_cuda("lp_gain", adj, adw, part)
    _build.require_dtype("lp_gain", adj, torch.int32)
    _build.require_dtype("lp_gain", adw, torch.float32)
    _build.require_dtype("lp_gain", part, torch.int32)
    lanes = adj.dim() == 3
    if adj.dim() not in (2, 3) or adw.shape != adj.shape:
        raise ValueError("lp_gain: adj and adw must be [N, DEG] or [B, N, DEG] of one shape")
    N, DEG = adj.shape[-2:]
    B = adj.shape[0] if lanes else 1
    if (part.dim() != 3 or part.shape[0] != B) if lanes else part.dim() not in (1, 2):
        raise ValueError("lp_gain: part must be [N] or [R, N], or [B, R, N] with "
                         "adj [B, N, DEG]")
    if part.shape[-1] != N:
        raise ValueError(f"lp_gain: part's last axis must be N = {N}")
    if not 1 <= DEG <= MAX_DEG:
        raise ValueError(f"lp_gain: DEG must be in [1, {MAX_DEG}], got {DEG}")
    if not 2 <= k <= MAX_K:
        raise ValueError(f"lp_gain: k must be in [2, {MAX_K}], got {k}")
    if not B <= MAX_LANES:
        raise ValueError(f"lp_gain: at most {MAX_LANES} lanes, got {B}")
    parts = part if lanes else (part[None] if part.dim() == 1 else part)[None]
    R = parts.shape[1]
    conn = torch.empty(B, R, N, k, dtype=torch.float32, device=adj.device)
    best = torch.empty(B, R, N, dtype=torch.int32, device=adj.device)
    gain = torch.empty(B, R, N, dtype=torch.float32, device=adj.device)
    if N and R and B:
        _build.launch("lp_gain", "lp_gain_f32", adj.device, adj.data_ptr(),
                      adw.data_ptr(), parts.data_ptr(), conn.data_ptr(),
                      best.data_ptr(), gain.data_ptr(), N, DEG, k, R, B)
    if lanes:
        return conn, best, gain
    if part.dim() == 1:
        return conn[0, 0], best[0, 0], gain[0, 0]
    return conn[0], best[0], gain[0]
