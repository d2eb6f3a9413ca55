"""Coarsening: heavy-edge matching (HEM) + contraction on the ELL layout.

Matching is multi-round handshaking: every unmatched vertex proposes to
its heaviest unmatched neighbour (deterministic jittered tie-breaks,
re-salted per round so tie-locked configurations break up) and mutual
proposals are contracted. Proposals come from the ``hem_propose`` kernel
over the padded ``[N, DEG]`` ELL adjacency; contraction merges each coarse
row's (<= 2) member rows with the ``contract_edges`` kernel and writes the
result straight into the relabelled CSR (a permutation, so the result is
deterministic and ``rows`` stays sorted). Rows beyond the DEG cap are
truncated; coarsening is a heuristic, and cut and balance are always
evaluated on the untruncated fine graph. Every routine takes one graph or
the lanes of a batch (a ``[B, ...]`` Graph): one kernel launch covers
every lane, ids stay lane-local and coarse ids are compacted per lane.

The segment path (:func:`hem_match` / :func:`contract`, ``coarsen_once``
with ``ell_deg=None``) is the reference's exact edge-array formulation: a
``scatter_reduce`` max/min proposal pass per round and a sort-based
contraction whose weight sums run in entry order (``graph.segment_sum``).
It has no degree cap and runs no kernel; ``partition(coarsen="segment")``
takes it.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import (F32, I32, Graph, _sorted_offsets, as_lanes, default_ell_deg,
                    edge_mask, ell_adjacency, lane_cumsum, lane_offsets, resolve_device,
                    segment_sum, sorted_segment_sum, vertex_mask)
from .refine import _MASK32, _u32
from ..kernels import ops as kops
from ..kernels.ref import fma_f32

_HASH_A = 2654435761
_HASH_B = 40503
# per-round salt stride: any odd constant; mixed into the edge jitter so
# round r+1 re-rolls every tie-break
_ROUND_SALT = 101159


def _i32(x: int) -> int:
    """Wrap a Python int to int32, as the reference's traced salts wrap."""
    return ((x + 2**31) % 2**32) - 2**31


def _edge_jitter(rows: torch.Tensor, cols: torch.Tensor, salt: int) -> torch.Tensor:
    """Deterministic per-edge jitter in [0, 1), symmetric in (u, v): the
    reference's uint32 hash, computed in i64 masked to 32 bits."""
    u = rows.long() & _MASK32
    v = cols.long() & _MASK32
    a, b = torch.minimum(u, v), torch.maximum(u, v)
    s = _u32(_u32(salt) * 0x9E3779B9)
    h = ((a * _HASH_A) & _MASK32) ^ ((b * _HASH_B) & _MASK32) ^ s
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _MASK32
    return (h & 0xFFFFFF).to(torch.float32) / float(1 << 24)


def hem_match_ell(g: Graph, adj: torch.Tensor, adw: torch.Tensor,
                  rounds: int = 3, salt: int = 0) -> torch.Tensor:
    """Heavy-edge matching over the ELL adjacency. Returns cluster labels
    [N]: matched pairs share the smaller endpoint's id, unmatched vertices
    point to themselves. The lanes of a batch (``g`` [B, ...], ``adj``/``adw``
    [B, N, DEG]) give [B, N]; every lane draws the same salts and hashes its
    lane-local ids, as it would alone."""
    gb, single = as_lanes(g)
    if single:
        adj, adw = adj[None], adw[None]
    N = gb.N
    idx = torch.arange(N, dtype=I32, device=gb.device)
    u2d = idx[:, None].expand(adj.shape)
    labels = idx.expand(adj.shape[:2])
    matched = (~vertex_mask(gb)).to(I32)   # padding can never match
    for r in range(rounds):
        jit_ = _edge_jitter(u2d, adj, _i32(salt * 7 + 13 + r * _ROUND_SALT))
        prop = kops.hem_propose(adj, adw, jit_, matched)
        proposal = torch.where((prop < N) & (matched == 0), prop, idx)
        mutual = (proposal != idx) & (proposal.gather(1, proposal.long()) == idx)
        leader = torch.minimum(idx, proposal)
        new_match = mutual & (matched == 0)
        labels = torch.where(new_match, leader, labels)
        matched = matched | new_match.to(I32)
    return labels[0] if single else labels


def contract_candidates(g: Graph, labels: torch.Tensor, adj: torch.Tensor,
                        adw: torch.Tensor):
    """The coarse ids and the contract_edges input of a matching.

    Returns ``(newid [N], n_coarse, vwgt_c [N], cand [N, 2*DEG],
    candw [N, 2*DEG])``: coarse row u's candidates are the ELL rows of its
    (<= 2) fine members mapped through ``newid``, with padding and
    intra-cluster edges set to the sentinel N (weight 0). The lanes of a
    batch give each with a leading [B] axis (coarse ids compacted per lane).
    """
    gb, single = as_lanes(g)
    if single:
        labels, adj, adw = labels[None], adj[None], adw[None]
    B, N = labels.shape
    dev = gb.device
    vmask = vertex_mask(gb)
    idx = torch.arange(N, dtype=I32, device=dev)
    is_leader = vmask & (labels == idx)
    rank = lane_cumsum(is_leader.to(I32)) - 1
    n_coarse = is_leader.sum(1, dtype=I32)
    newid = torch.where(vmask, rank.gather(1, labels.long()), N - 1).to(I32)

    # coarse row u's fine members: the leader and (if matched) its partner;
    # writes of non-members go to each lane's trash slot N, cut off afterwards
    members = idx.expand(B, N)
    memA = torch.full((B, N + 1), N, dtype=I32, device=dev)
    memA.scatter_(1, torch.where(is_leader, rank, N).long(), members)
    nonleader = vmask & (labels != idx)
    memB = torch.full((B, N + 1), N, dtype=I32, device=dev)
    memB.scatter_(1, torch.where(nonleader, rank.gather(1, labels.clamp(0, N - 1).long()),
                                 N).long(), members)
    memA, memB = memA[:, :N], memB[:, :N]
    hasA = memA < N
    hasB = memB < N

    # exact pair sum (each coarse vertex has <= 2 members; pad rows -> 0)
    vwgt_c = (torch.where(hasA, gb.vwgt.gather(1, memA.clamp(0, N - 1).long()), 0.0)
              + torch.where(hasB, gb.vwgt.gather(1, memB.clamp(0, N - 1).long()), 0.0))

    def member_cands(mem, has):
        rowsel = mem.clamp(0, N - 1).long()[:, :, None].expand(adj.shape)
        a = adj.gather(1, rowsel)             # [B, N, DEG] member neighbour ids
        w = adw.gather(1, rowsel)
        cn = newid.gather(1, a.clamp(0, N - 1).long().view(B, -1)).view(a.shape)
        ok = has[:, :, None] & (a < N) & (cn != idx[:, None])  # drop pad + intra
        return torch.where(ok, cn, N), torch.where(ok, w, 0.0)

    candA, candwA = member_cands(memA, hasA)
    candB, candwB = member_cands(memB, hasB)
    cand = torch.cat([candA, candB], dim=2).to(I32)
    candw = torch.cat([candwA, candwB], dim=2)
    out = (newid, n_coarse, vwgt_c, cand, candw)
    return tuple(x[0] for x in out) if single else out


def contract_ell(g: Graph, labels: torch.Tensor, adj: torch.Tensor,
                 adw: torch.Tensor) -> tuple[Graph, torch.Tensor]:
    """Contract matched pairs via the row-merge kernel (sort-free).

    Returns (coarse graph with the SAME padded shapes, fine->coarse map
    [N]); for the lanes of a batch a [B, ...] Graph and [B, N], from one
    ``contract_edges`` launch over every lane's rows.
    """
    gb, single = as_lanes(g)
    if single:
        labels, adj, adw = labels[None], adj[None], adw[None]
    B, N, M = labels.shape[0], gb.N, gb.M
    dev = gb.device
    newid, n_coarse, vwgt_c, cand, candw = contract_candidates(gb, labels, adj, adw)
    nbr, wsum, cnt = kops.contract_edges(cand, candw)

    indptr_c = torch.cat([torch.zeros(B, 1, dtype=I32, device=dev),
                          lane_cumsum(cnt)], dim=1)
    m_coarse = indptr_c[:, -1]

    first = nbr < N
    rank_in_row = lane_cumsum(first.to(I32).view(-1, first.shape[-1])).view(first.shape) - 1
    dest = torch.where(first, indptr_c[:, :N, None] + rank_in_row, M)
    dest = torch.where(dest < M, dest, M)       # out of range: each lane's trash slot
    dest = (dest + lane_offsets(B, M + 1, dev)[:, :, None]).reshape(-1)
    rowid = torch.arange(N, dtype=I32, device=dev)[:, None].expand(nbr.shape[1:])
    rows_c = torch.full((B, M + 1), N - 1, dtype=I32, device=dev)
    rows_c.view(-1)[dest] = rowid.expand(nbr.shape).reshape(-1)
    cols_c = torch.full((B, M + 1), N - 1, dtype=I32, device=dev)
    cols_c.view(-1)[dest] = nbr.reshape(-1)
    ewgt_c = torch.zeros(B, M + 1, dtype=adw.dtype, device=dev)
    ewgt_c.view(-1)[dest] = wsum.reshape(-1)
    gc = Graph(vwgt=vwgt_c, rows=rows_c[:, :M].contiguous(), cols=cols_c[:, :M].contiguous(),
               ewgt=ewgt_c[:, :M].contiguous(), indptr=indptr_c, n=n_coarse, m=m_coarse)
    if single:
        return Graph(*(a[0] for a in gc)), newid[0]
    return gc, newid


# ---------------------------------------------------------------------------
# segment path (exact, sort-based; plain PyTorch on either device)
# ---------------------------------------------------------------------------

def hem_match(g: Graph, rounds: int = 3, salt: int = 0) -> torch.Tensor:
    """Heavy-edge matching over the edge arrays. Returns cluster labels
    [N] ([B, N] for the lanes of a batch): matched pairs share the smaller
    endpoint's id; unmatched vertices point to themselves.

    The score ``w * (1 + j) + j`` is rounded once, as XLA fuses it on the
    CPU; an empty row's best is ``-inf`` and its proposal ``INT32_MAX``,
    the reference's ``segment_max``/``segment_min`` identities.
    """
    gb, single = as_lanes(g)
    B, N = gb.vwgt.shape
    dev = gb.device
    emask = edge_mask(gb)
    rows, cols = gb.rows.long(), gb.cols.long()
    idx = torch.arange(N, dtype=I32, device=dev)
    labels = idx.expand(B, N)
    matched = ~vertex_mask(gb)   # padding can never match
    ninf = torch.full((B, N), float("-inf"), dtype=F32, device=dev)
    none = torch.full((B, N), torch.iinfo(torch.int32).max, dtype=I32, device=dev)
    milli = torch.tensor(1e-3, dtype=F32, device=dev)
    for r in range(rounds):
        free_edge = (emask & ~matched.gather(1, rows) & ~matched.gather(1, cols)
                     & (rows != cols))
        jit_ = _edge_jitter(gb.rows, gb.cols, _i32(salt * 7 + 13 + r * _ROUND_SALT)) * milli
        score = torch.where(free_edge, fma_f32(gb.ewgt, 1.0 + jit_, jit_), float("-inf"))
        row_best = ninf.scatter_reduce(1, rows, score, "amax")
        is_best = free_edge & (score >= row_best.gather(1, rows)) & torch.isfinite(score)
        # tie-break: smallest column among best-scoring edges
        prop_col = none.scatter_reduce(1, rows, torch.where(is_best, gb.cols, N), "amin")
        proposal = torch.where((prop_col < N) & ~matched, prop_col, idx)
        mutual = (proposal != idx) & (proposal.gather(1, proposal.long()) == idx)
        leader = torch.minimum(idx, proposal)
        new_match = mutual & ~matched
        labels = torch.where(new_match, leader, labels)
        matched = matched | new_match
    return labels[0] if single else labels


def contract(g: Graph, labels: torch.Tensor) -> tuple[Graph, torch.Tensor]:
    """Contract the clusters of ``labels``. Returns (coarse graph with the
    SAME padded shapes, fine->coarse vertex map [N]); for the lanes of a
    batch a [B, ...] Graph and [B, N].

    Edges are sorted by (coarse u, coarse v) with two stable sorts, so each
    coarse edge's fine copies are one contiguous run, summed in that order;
    the run heads land in order at the front of the coarse arrays. Each
    lane sorts its own row; the sums run over the flattened lanes, whose
    segment ids are offset per lane.
    """
    gb, single = as_lanes(g)
    if single:
        labels = labels[None]
    B, N, M = labels.shape[0], gb.N, gb.M
    dev = gb.device
    vmask = vertex_mask(gb)
    idx = torch.arange(N, dtype=I32, device=dev)
    ar_m = torch.arange(M, dtype=I32, device=dev)
    off_n, off_m = lane_offsets(B, N, dev), lane_offsets(B, M, dev)

    is_leader = vmask & (labels == idx)
    rank = lane_cumsum(is_leader.to(I32)) - 1
    n_coarse = is_leader.sum(1, dtype=I32)
    # fine -> coarse id; padding parked at N-1 with zero weight
    newid = torch.where(vmask, rank.gather(1, labels.long()), N - 1).to(I32)
    vwgt_c = segment_sum(torch.where(vmask, gb.vwgt, 0.0).reshape(-1),
                         (newid + off_n).to(I32).reshape(-1), B * N).view(B, N)

    cu = newid.gather(1, gb.rows.long())
    cv = newid.gather(1, gb.cols.long())
    valid = edge_mask(gb) & (cu != cv)
    # sort edges by (cu, cv), invalid ones parked at cu = N, last
    order1 = torch.sort(torch.where(valid, cv, N), dim=1, stable=True).indices
    cu1 = torch.where(valid, cu, N).gather(1, order1)
    cv1 = cv.gather(1, order1)
    w1 = torch.where(valid, gb.ewgt, 0.0).gather(1, order1)
    cu2, order2 = torch.sort(cu1, dim=1, stable=True)
    cv2, w2 = cv1.gather(1, order2), w1.gather(1, order2)

    valid_s = cu2 < N
    head = valid_s & ((ar_m == 0) | (cu2 != torch.roll(cu2, 1, dims=1))
                      | (cv2 != torch.roll(cv2, 1, dims=1)))
    seg = lane_cumsum(head.to(I32)) - 1   # dedup segment per slot
    agg_w = sorted_segment_sum(torch.where(valid_s, w2, 0.0).reshape(-1),
                               (seg.clamp(min=0) + off_m).to(I32).reshape(-1),
                               B * M).view(B, M)

    # heads go to their segment's slot; other writes to each lane's trash slot M
    slot = (torch.where(head, seg, M) + lane_offsets(B, M + 1, dev)).reshape(-1)
    rows_c = torch.full((B, M + 1), N - 1, dtype=I32, device=dev)
    rows_c.view(-1)[slot] = cu2.reshape(-1)
    cols_c = torch.full((B, M + 1), N - 1, dtype=I32, device=dev)
    cols_c.view(-1)[slot] = cv2.reshape(-1)
    m_coarse = head.sum(1, dtype=I32)
    in_range = ar_m < m_coarse[:, None]
    rows_c = torch.where(in_range, rows_c[:, :M], N - 1)
    cols_c = torch.where(in_range, cols_c[:, :M], N - 1)
    ewgt_c = torch.where(in_range, agg_w, 0.0)
    # the real rows are sorted: the CSR prefix is a binary search
    indptr_c = _sorted_offsets(torch.where(in_range, rows_c, N), N)[:, : N + 1]
    gc = Graph(vwgt=vwgt_c, rows=rows_c, cols=cols_c, ewgt=ewgt_c,
               indptr=indptr_c, n=n_coarse, m=m_coarse)
    if single:
        return Graph(*(a[0] for a in gc)), newid[0]
    return gc, newid


def coarsen_once(g: Graph, salt: int = 0, rounds: int = 3,
                 ell_deg: int | None = None) -> tuple[Graph, torch.Tensor]:
    """One HEM + contraction level, of one graph or of every lane of a
    batch at once. ``ell_deg=None`` runs the segment path; an int runs the
    ELL kernels (the adjacency is built once and shared by matching and
    contraction)."""
    if ell_deg is None:
        return contract(g, hem_match(g, rounds=rounds, salt=salt))
    adj, adw, _ = ell_adjacency(g, ell_deg)
    labels = hem_match_ell(g, adj, adw, rounds=rounds, salt=salt)
    return contract_ell(g, labels, adj, adw)


def coarsen_cascade(g: Graph, levels: int, ell_deg: int | None = None,
                    rounds: int = 3, device=None) -> tuple[np.ndarray, np.ndarray]:
    """The coarsening cascade alone: the per-level sizes ``(ns [levels],
    ms [levels])`` of the ELL path (the cap defaults to
    ``default_ell_deg(N, M)`` of the padded shapes), the telemetry behind
    ``stats["coarsen"]``. Only the current graph is kept (memory does not
    grow with ``levels``), and the sizes are stacked on the device and
    fetched once. ``g`` is moved to ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    g = g.to(dev)
    deg = default_ell_deg(g.N, g.M) if ell_deg is None else ell_deg
    if levels == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    sizes, cur = [], g
    for lvl in range(levels):
        cur, _ = coarsen_once(cur, salt=(lvl + 1) * 131 + 7, rounds=rounds, ell_deg=deg)
        sizes.append(torch.stack([cur.n, cur.m]))
    ns, ms = torch.stack(sizes, dim=1).cpu().numpy()
    return ns, ms
