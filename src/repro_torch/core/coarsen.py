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
evaluated on the untruncated fine graph.

This slice ports the ELL path, the one the fused v-cycle runs; the
reference's segment path (``hem_match``/``contract``) waits for a later
slice.
"""
from __future__ import annotations

import torch

from .graph import I32, Graph, ell_adjacency, vertex_mask
from .refine import _MASK32, _u32
from ..kernels import ops as kops

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
    point to themselves."""
    N = g.N
    idx = torch.arange(N, dtype=I32, device=g.device)
    u2d = idx[:, None].expand(adj.shape)
    labels = idx
    matched = (~vertex_mask(g)).to(I32)   # padding can never match
    for r in range(rounds):
        jit_ = _edge_jitter(u2d, adj, _i32(salt * 7 + 13 + r * _ROUND_SALT))
        prop = kops.hem_propose(adj, adw, jit_, matched)
        proposal = torch.where((prop < N) & (matched == 0), prop, idx)
        mutual = (proposal != idx) & (proposal[proposal] == idx)
        leader = torch.minimum(idx, proposal)
        new_match = mutual & (matched == 0)
        labels = torch.where(new_match, leader, labels)
        matched = matched | new_match.to(I32)
    return labels


def contract_candidates(g: Graph, labels: torch.Tensor, adj: torch.Tensor,
                        adw: torch.Tensor):
    """The coarse ids and the contract_edges input of a matching.

    Returns ``(newid [N], n_coarse, vwgt_c [N], cand [N, 2*DEG],
    candw [N, 2*DEG])``: coarse row u's candidates are the ELL rows of its
    (<= 2) fine members mapped through ``newid``, with padding and
    intra-cluster edges set to the sentinel N (weight 0).
    """
    N = g.N
    dev = g.device
    vmask = vertex_mask(g)
    idx = torch.arange(N, dtype=I32, device=dev)
    is_leader = vmask & (labels == idx)
    rank = torch.cumsum(is_leader.to(I32), 0, dtype=I32) - 1
    n_coarse = is_leader.sum(dtype=I32)
    newid = torch.where(vmask, rank[labels], N - 1).to(I32)

    # coarse row u's fine members: the leader and (if matched) its partner;
    # writes of non-members go to the trash slot N, cut off afterwards
    memA = torch.full((N + 1,), N, dtype=I32, device=dev)
    memA[torch.where(is_leader, rank, N)] = idx
    nonleader = vmask & (labels != idx)
    memB = torch.full((N + 1,), N, dtype=I32, device=dev)
    memB[torch.where(nonleader, rank[labels.clamp(0, N - 1)], N)] = idx
    memA, memB = memA[:N], memB[:N]
    hasA = memA < N
    hasB = memB < N

    # exact pair sum (each coarse vertex has <= 2 members; pad rows -> 0)
    vwgt_c = (torch.where(hasA, g.vwgt[memA.clamp(0, N - 1)], 0.0)
              + torch.where(hasB, g.vwgt[memB.clamp(0, N - 1)], 0.0))

    def member_cands(mem, has):
        rowsel = mem.clamp(0, N - 1)
        a = adj[rowsel]                       # [N, DEG] member neighbour ids
        w = adw[rowsel]
        cn = newid[a.clamp(0, N - 1)]         # coarse-mapped neighbour
        ok = has[:, None] & (a < N) & (cn != idx[:, None])  # drop pad + intra
        return torch.where(ok, cn, N), torch.where(ok, w, 0.0)

    candA, candwA = member_cands(memA, hasA)
    candB, candwB = member_cands(memB, hasB)
    cand = torch.cat([candA, candB], dim=1).to(I32)
    candw = torch.cat([candwA, candwB], dim=1)
    return newid, n_coarse, vwgt_c, cand, candw


def contract_ell(g: Graph, labels: torch.Tensor, adj: torch.Tensor,
                 adw: torch.Tensor) -> tuple[Graph, torch.Tensor]:
    """Contract matched pairs via the row-merge kernel (sort-free).

    Returns (coarse graph with the SAME padded shapes, fine->coarse map [N]).
    """
    N, M = g.N, g.M
    dev = g.device
    newid, n_coarse, vwgt_c, cand, candw = contract_candidates(g, labels, adj, adw)
    nbr, wsum, cnt = kops.contract_edges(cand, candw)

    indptr_c = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                          torch.cumsum(cnt, 0, dtype=I32)])
    m_coarse = indptr_c[-1]

    first = nbr < N
    rank_in_row = torch.cumsum(first.to(I32), 1, dtype=I32) - 1
    dest = torch.where(first, indptr_c[:N, None] + rank_in_row, M).reshape(-1)
    dest = torch.where(dest < M, dest, M)       # out of range: dropped
    rowid = torch.arange(N, dtype=I32, device=dev)[:, None].expand(nbr.shape).reshape(-1)
    rows_c = torch.full((M + 1,), N - 1, dtype=I32, device=dev)
    rows_c[dest] = rowid
    cols_c = torch.full((M + 1,), N - 1, dtype=I32, device=dev)
    cols_c[dest] = nbr.reshape(-1)
    ewgt_c = torch.zeros(M + 1, dtype=adw.dtype, device=dev)
    ewgt_c[dest] = wsum.reshape(-1)
    gc = Graph(vwgt=vwgt_c, rows=rows_c[:M], cols=cols_c[:M], ewgt=ewgt_c[:M],
               indptr=indptr_c, n=n_coarse, m=m_coarse)
    return gc, newid


def coarsen_once(g: Graph, salt: int = 0, rounds: int = 3,
                 ell_deg: int | None = None) -> tuple[Graph, torch.Tensor]:
    """One HEM + contraction level on the ELL kernels (the adjacency is
    built once and shared by matching and contraction)."""
    if ell_deg is None:
        raise NotImplementedError(
            "the segment coarsening path (ell_deg=None) is not ported yet "
            "(ROADMAP.md, Queue 1, item 6, 'Remaining core pieces')")
    adj, adw, _ = ell_adjacency(g, ell_deg)
    labels = hem_match_ell(g, adj, adw, rounds=rounds, salt=salt)
    return contract_ell(g, labels, adj, adw)
