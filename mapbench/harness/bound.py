"""The yardstick of the kernels: the card's peaks, and the bytes and
operations each mapping kernel's launch needs, from its arguments.

Frozen from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``F32_OPS_PER_S`` and
``_bound`` at lines 219-220 and 285; the counts of ``_contract_case``,
``_lp_gain_case``, ``_hem_case``, ``_mapcost_case`` at lines 375-454 and of
the ``gather_rows`` check at line 2706). Bytes count each input byte read
once and each output byte written once; where the work depends on the
data, what these inputs need. One change from the original: ``gather_rows``
counts ``min(len(src), idx.numel())`` source elements, since one launch
reads at most one per index.

Each count is a function of the launch's arguments that returns
``(bytes, operations)``; a count that depends on the data may be a 0-dim
tensor on the card, read once the profiled pass has ended.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA's data sheet)
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores


def bound_ms(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of bytes over peak
    bandwidth and operations over peak rate, in ms."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def lp_gain(adj, adw, part, k):
    """adj/adw [B, N, DEG] (or [N, DEG]), part [B, R, N] (or [R, N], [N]):
    ids and weights read, labels read, conn [.., k], best and gain written.
    Operations: one add per live slot and restart."""
    lanes = adj if adj.dim() == 3 else adj[None]
    B, N, DEG = lanes.shape
    R = part.shape[-2] if part.dim() >= 2 else 1
    live = (adj < N).sum()
    return 8 * B * N * DEG + 4 * B * R * N + B * R * N * (4 * k + 8), R * live


def hem_propose(adj, adw, jit, matched):
    """The ids, weights and jitters of every unmatched row (a matched row
    proposes nothing from its flag alone), every row's flag and proposal.
    Operations: one score (a multiply, an add, a fused multiply-add) per
    valid slot."""
    N, DEG = adj.shape[-2:]
    free = matched == 0
    u = torch.arange(N, device=adj.device)[:, None]
    nbr_free = free.gather(-1, adj.clamp(0, N - 1).long().reshape(*free.shape[:-1], -1))
    valid = free[..., None] & (adj < N) & (adj != u) & nbr_free.view(adj.shape)
    return 12 * DEG * free.sum() + 8 * matched.numel(), 4 * valid.sum()


def contract_edges(cand, candw):
    """cand/candw [B, N, D2] (or [N, D2]): B * N rows of D2 slots read and
    written, one count per row. Operations: one compare-add for each pair
    of live slots of a row."""
    N, D2 = cand.shape[-2:]
    T = cand.numel() // D2
    live = (cand != N).sum(-1, dtype=torch.int64)
    return 16 * T * D2 + 4 * T, (live * live).sum()


def gather_rows(src, idx):
    """One source element per index at most, the index read, out written."""
    return 4 * (min(src.numel(), idx.numel()) + 2 * idx.numel()), 0


def mapcost(rows, cols, ewgt, pe, g_below, dvec):
    """The three edge arrays and the PE ids, each read once. Operations: a
    multiply and an add per edge."""
    M, N = rows.shape[0], pe.shape[0]
    return 12 * M + 4 * N, 2 * M


COUNTS = {"lp_gain": lp_gain, "hem_propose": hem_propose,
          "contract_edges": contract_edges, "gather_rows": gather_rows,
          "mapcost": mapcost}

