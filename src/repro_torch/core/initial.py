"""Initial partition of the coarsest graph: greedy graph growing + LP polish.

Seeds are index-strided (generators and contraction preserve locality in id
order), then blocks grow by repeatedly admitting the unassigned vertices
with the strongest connectivity to each block, under capacity caps. Any
leftover (disconnected) vertices fall to the lightest block, then a
rebalanced LP pass polishes the result. Deterministic given ``salt``.
"""
from __future__ import annotations

import torch

from .graph import I32, Graph, label_sums, row_cumsum, row_label_sums, vertex_mask
from .refine import _admit_by_argsort, _lookup, _vhash, _vhashes, lp_refine, rebalance


def initial_partition(g: Graph, k: int, Lmax: torch.Tensor, salt=0,
                      grow_rounds: int = 24, polish_rounds: int = 6,
                      backend: str = "auto", ell_deg: int | None = None) -> torch.Tensor:
    """[N] labelling for one int ``salt``; [R, N] for a list of R salts
    (the restarts of a partition call, run as a leading batch dimension)."""
    salts = [int(s) for s in salt] if isinstance(salt, (list, tuple)) else [int(salt)]
    R = len(salts)
    N = g.N
    dev = g.device
    vmask = vertex_mask(g)
    n = torch.clamp(g.n, min=1)

    # --- seeds: k index-strided real vertices, hash-rotated by salt --------
    offset = torch.tensor([int(_vhash(1, s, "cpu")[0]) % 97 for s in salts],
                          dtype=I32, device=dev)
    seed_pos = (torch.arange(k, dtype=I32, device=dev) * n) // k
    seed_pos = (seed_pos[None, :] + offset[:, None]) % n
    part = torch.full((R, N), k, dtype=I32, device=dev)   # k == "unassigned"
    # with n < k seeds share a vertex and the last write wins (XLA's CPU
    # scatter, in order): the largest block id, on either device
    part.scatter_reduce_(1, seed_pos.long(), torch.arange(k, dtype=I32, device=dev).expand(R, k),
                         "amax", include_self=False)
    part = torch.where(vmask, part, k)

    # --- greedy growth -------------------------------------------------------
    for _ in range(grow_rounds):
        assigned = part < k
        conn = row_label_sums(g, part[:, g.cols], g.ewgt, k)   # unassigned (k) adds nothing
        W = _assigned_weights(g, part, assigned, vmask, k)
        fits = (W[:, None, :] + g.vwgt[None, :, None]) <= Lmax
        score = torch.where(fits, conn, float("-inf"))
        best = torch.argmax(score, dim=-1).to(I32)
        sbest = score.max(dim=-1).values
        cand = vmask & ~assigned & (sbest > 0.0)
        # capacity prefix per target block (strongest connections first)
        accept = _admit_by_argsort(cand, best, sbest, g.vwgt, Lmax - W, k)
        part = torch.where(accept, best, part)

    # --- leftovers -> lightest block with room (a few sweeps) ---------------
    for _ in range(8):
        assigned = part < k
        W = _assigned_weights(g, part, assigned, vmask, k)
        lightest = torch.argmin(W, dim=-1).to(I32)[:, None]
        todo = vmask & ~assigned
        w_cum = row_cumsum(torch.where(todo, g.vwgt, 0.0))
        Wl = _lookup(W, lightest)
        ok = todo & ((Wl + w_cum) <= torch.maximum(Lmax, Wl + g.vwgt))
        part = torch.where(ok, lightest, part)
    # anything still left: round-robin by hash (guaranteed assignment)
    left = vmask & (part >= k)
    fallback = (_vhashes(N, [s + 5 for s in salts], dev) % k).to(I32)
    part = torch.where(left, fallback, part)
    part = torch.where(vmask, part, 0)

    # polish with the caller's refinement backend and ELL cap
    part = lp_refine(g, part, k, Lmax, rounds=polish_rounds,
                     salt=[s + 11 for s in salts], backend=backend, ell_deg=ell_deg)
    part = rebalance(g, part, k, Lmax, rounds=6, salt=[s + 17 for s in salts],
                     backend=backend, ell_deg=ell_deg)
    return part if isinstance(salt, (list, tuple)) else part[0]


def _assigned_weights(g: Graph, part, assigned, vmask, k: int) -> torch.Tensor:
    """[R, k] vertex weight already assigned to each block."""
    return label_sums(torch.where(assigned, part, 0),
                      torch.where(assigned & vmask, g.vwgt, 0.0), k)
