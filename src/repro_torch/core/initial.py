"""Initial partition of the coarsest graph: greedy graph growing + LP polish.

Seeds are index-strided (generators and contraction preserve locality in id
order), then blocks grow by repeatedly admitting the unassigned vertices
with the strongest connectivity to each block, under capacity caps. Any
leftover (disconnected) vertices fall to the lightest block, then a
rebalanced LP pass polishes the result. Deterministic given ``salt``.
"""
from __future__ import annotations

import torch

from .graph import F32, I32, Graph, as_lanes, label_sums, row_cumsum, vertex_mask
from .refine import (_admit_by_argsort, _lookup, _rows_of, _vhash0, _vhashes, connectivity,
                     lp_refine, rebalance)


def initial_partition(g: Graph, k: int, Lmax: torch.Tensor, salt=0,
                      grow_rounds: int = 24, polish_rounds: int = 6,
                      backend: str = "auto", ell_deg: int | None = None) -> torch.Tensor:
    """[N] labelling for one int ``salt``; [R, N] for a list of R salts
    (the restarts of a partition call, run as a leading batch dimension).
    For the lanes of a batch (``g`` [B, ...], ``salt`` B lists of R,
    ``Lmax`` [B]) [B, R, N]: every step runs once for all B * R rows, each
    row with its lane's graph and capacity."""
    gb, single = as_lanes(g)
    B, N = gb.vwgt.shape
    if not single:
        shape = (B, len(salt[0]), N)
    elif isinstance(salt, (list, tuple)):
        shape, salt = (len(salt), N), [salt]
    else:
        shape, salt = (N,), [[salt]]
    salts = [int(x) for row in salt for x in row]
    R = len(salts) // B
    Lmax = torch.as_tensor(Lmax, dtype=F32, device=gb.device).reshape(-1)
    T = B * R
    dev = gb.device
    vmask = _rows_of(vertex_mask(gb), R)   # [T, N]: row b * R + r is lane b's
    vw = _rows_of(gb.vwgt, R)
    Lr = _rows_of(Lmax, R)[:, None]
    n = _rows_of(torch.clamp(gb.n, min=1), R)[:, None]

    def conn_of(parts):   # unassigned (k) adds nothing
        return connectivity(gb, parts.view(B, R, N), k).view(T, N, k)

    # --- seeds: k index-strided real vertices, hash-rotated by salt --------
    offset = torch.tensor([_vhash0(s) % 97 for s in salts], dtype=I32, device=dev)
    seed_pos = (torch.arange(k, dtype=I32, device=dev) * n) // k
    seed_pos = (seed_pos + offset[:, None]) % n
    part = torch.full((T, N), k, dtype=I32, device=dev)   # k == "unassigned"
    # with n < k seeds share a vertex and the last write wins (XLA's CPU
    # scatter, in order): the largest block id, on either device
    part.scatter_reduce_(1, seed_pos.long(), torch.arange(k, dtype=I32, device=dev).expand(T, k),
                         "amax", include_self=False)
    part = torch.where(vmask, part, k)

    # --- greedy growth -------------------------------------------------------
    for _ in range(grow_rounds):
        assigned = part < k
        conn = conn_of(part)
        W = _assigned_weights(part, assigned, vmask, vw, k)
        fits = (W[:, None, :] + vw[:, :, None]) <= Lr[:, :, None]
        score = torch.where(fits, conn, float("-inf"))
        best = torch.argmax(score, dim=-1).to(I32)
        sbest = score.max(dim=-1).values
        cand = vmask & ~assigned & (sbest > 0.0)
        # capacity prefix per target block (strongest connections first)
        accept = _admit_by_argsort(cand, best, sbest, vw, Lr - W, k)
        part = torch.where(accept, best, part)

    # --- leftovers -> lightest block with room (a few sweeps) ---------------
    for _ in range(8):
        assigned = part < k
        W = _assigned_weights(part, assigned, vmask, vw, k)
        lightest = torch.argmin(W, dim=-1).to(I32)[:, None]
        todo = vmask & ~assigned
        w_cum = row_cumsum(torch.where(todo, vw, 0.0))
        Wl = _lookup(W, lightest)
        ok = todo & ((Wl + w_cum) <= torch.maximum(Lr, Wl + vw))
        part = torch.where(ok, lightest, part)
    # anything still left: round-robin by hash (guaranteed assignment)
    left = vmask & (part >= k)
    fallback = (_vhashes(N, [s + 5 for s in salts], dev) % k).to(I32)
    part = torch.where(left, fallback, part)
    part = torch.where(vmask, part, 0).view(B, R, N)

    # polish with the caller's refinement backend and ELL cap
    polish = [[s + 11 for s in salts[b * R:(b + 1) * R]] for b in range(B)]
    part = lp_refine(gb, part, k, Lmax, rounds=polish_rounds, salt=polish,
                     backend=backend, ell_deg=ell_deg)
    part = rebalance(gb, part, k, Lmax, rounds=6, backend=backend, ell_deg=ell_deg)
    return part.view(shape)


def _assigned_weights(part, assigned, vmask, vw, k: int) -> torch.Tensor:
    """[T, k] vertex weight already assigned to each block, per row."""
    return label_sums(torch.where(assigned, part, 0),
                      torch.where(assigned & vmask, vw, 0.0), k)
