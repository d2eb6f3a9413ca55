"""CUDA kernels for coarsening: HEM proposals and the contraction merge.

``hem_propose_cuda`` launches ``csrc/hem_propose.cu`` and
``contract_edges_cuda`` launches ``csrc/contract_edges.cu``; they replace
the TPU kernels ``repro/kernels/coarsen_kernels.py:hem_propose_pallas`` and
``contract_edges_pallas``. Both are bitwise the plain versions in
``kernels/ref.py`` (``hem_propose_ref``, ``contract_edges_ref``): the score
is the one fused multiply-add the reference rounds once, the reductions
are max/min, and a weight total adds the id's weights in slot order from
+0.0, which is bitwise the reference's fixed add chain (the chain's other
terms are +0.0).
"""
from __future__ import annotations

import torch

from . import _build

MAX_DEG = 64   # the ELL width the kernels take (contract_edges: 2 * MAX_DEG)
MAX_LANES = 65535   # hem_propose's lanes are the grid's y axis


def hem_propose_cuda(adj, adw, jit, matched) -> torch.Tensor:
    """Per-row HEM proposal over the [N, DEG] ELL adjacency; [N] i32, N = none.
    The lanes of a batch take [B, N, DEG] and ``matched`` [B, N] (ids
    lane-local) and give [B, N], in one launch."""
    _build.require_cuda("hem_propose", adj, adw, jit, matched)
    _build.require_dtype("hem_propose", adj, torch.int32)
    _build.require_dtype("hem_propose", matched, torch.int32)
    _build.require_dtype("hem_propose", adw, torch.float32)
    _build.require_dtype("hem_propose", jit, torch.float32)
    if adj.dim() not in (2, 3):
        raise ValueError("hem_propose: adj must be [N, DEG] or [B, N, DEG]")
    N, DEG = adj.shape[-2:]
    B = adj.shape[0] if adj.dim() == 3 else 1
    if adw.shape != adj.shape or jit.shape != adj.shape or matched.shape != adj.shape[:-1]:
        raise ValueError("hem_propose: adj/adw/jit must be [(B,) N, DEG] and matched [(B,) N]")
    if not 1 <= DEG <= MAX_DEG:
        raise ValueError(f"hem_propose: DEG must be in [1, {MAX_DEG}], got {DEG}")
    if not B <= MAX_LANES:
        raise ValueError(f"hem_propose: at most {MAX_LANES} lanes, got {B}")
    prop = torch.empty(adj.shape[:-1], dtype=torch.int32, device=adj.device)
    if N and B:
        _build.launch("hem_propose", "hem_propose_f32", adj.device, adj.data_ptr(),
                      adw.data_ptr(), jit.data_ptr(), matched.data_ptr(),
                      prop.data_ptr(), N, DEG, B)
    return prop


def contract_edges_cuda(cand, candw, sent: int):
    """Row-local merge/dedup/accumulate: ``(nbr [N, D2], w [N, D2], cnt [N])``.
    The lanes of a batch, ``cand`` [B, N, D2] with ``sent`` = N, run as the
    B * N rows of one launch (every row is on its own); the outputs keep the
    lane axis."""
    _build.require_cuda("contract_edges", cand, candw)
    _build.require_dtype("contract_edges", cand, torch.int32)
    _build.require_dtype("contract_edges", candw, torch.float32)
    if cand.dim() not in (2, 3) or candw.shape != cand.shape:
        raise ValueError("contract_edges: cand and candw must share a [(B,) N, D2] shape")
    D2 = cand.shape[-1]
    T = cand.numel() // D2 if D2 else 0
    if not 1 <= D2 <= 2 * MAX_DEG:
        raise ValueError(f"contract_edges: D2 must be in [1, {2 * MAX_DEG}], got {D2}")
    nbr = torch.empty_like(cand)
    w = torch.empty_like(candw)
    cnt = torch.empty(cand.shape[:-1], dtype=torch.int32, device=cand.device)
    if T:
        _build.launch("contract_edges", "contract_edges_f32", cand.device,
                      cand.data_ptr(), candw.data_ptr(), nbr.data_ptr(),
                      w.data_ptr(), cnt.data_ptr(), T, D2, int(sent))
    return nbr, w, cnt
