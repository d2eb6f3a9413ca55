"""The rgg family: random geometric graphs in the unit square, the paper's
rgg instances (the DIMACS rgg_n_2_<s> radius rule).

A frozen copy of ``src/repro_torch/core/graph.py:446`` ``gen_rgg``, so that a
later change to the program cannot change the benchmark's inputs: the same
point cloud (``default_rng(seed).random((n, 2))``), radius rule and cell
grid, and the same edge set, but built with array operations over all cells
at once, on the card where the run has one, instead of a Python loop over
the cells (2^20 vertices in about a second rather than ten). As in the
original, a pair in two neighbouring cells is kept only where the vertex of
the earlier cell has the smaller id.

A generator file (``mapbench/generators/<family>.py``) gives
``make(log2_n, seed, device)``: the undirected edge list ``(n, u, v)`` in
numpy, each edge listed once. The mapper's ``TaskGraph.from_edges`` sums
repeats and drops loops, and the reference (``mapbench/reference``) reads
the same raw lists.
"""
from __future__ import annotations

import numpy as np
import torch

# Offsets of the neighbouring cells each cell is paired with (the original's
# order; the cell itself comes first).
_OFFSETS = ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1))


def rgg(n: int, seed: int, radius_scale: float = 0.55, device="cpu"):
    """Random geometric graph in the unit square (the paper's rgg family):
    ``(n, u, v)`` with ``u < v`` for every edge. The points and their cells
    are made on the host as the original makes them; the candidate pairs and
    their distances on ``device`` (float64: the same roundings)."""
    rng = np.random.default_rng(seed)
    pts_h = rng.random((n, 2))
    r = radius_scale * np.sqrt(np.log(max(n, 2)) / n)
    nb = max(1, int(1.0 / r))
    cell = (pts_h / (1.0 / nb)).astype(np.int64)
    dev = torch.device(device)
    pts = torch.from_numpy(pts_h).to(dev)
    cell_id = torch.from_numpy(cell[:, 0] * nb + cell[:, 1]).to(dev)
    order = torch.sort(cell_id, stable=True).indices
    count = torch.bincount(cell_id, minlength=nb * nb)
    start = torch.cumsum(count, 0) - count
    ids = torch.arange(nb * nb, device=dev)
    cx, cy = ids // nb, ids % nb
    us, vs = [], []
    for dx, dy in _OFFSETS:
        ok = (cx + dx < nb) & (cy + dy >= 0) & (cy + dy < nb) & (count > 0)
        base = ids[ok]
        other = (cx[base] + dx) * nb + (cy[base] + dy)
        keep = count[other] > 0
        base, other = base[keep], other[keep]
        cb = count[other]
        pairs = count[base] * cb
        owner = torch.repeat_interleave(torch.arange(base.numel(), device=dev), pairs)
        local = torch.arange(owner.numel(), device=dev) - torch.repeat_interleave(
            torch.cumsum(pairs, 0) - pairs, pairs)
        u = order[start[base][owner] + local // cb[owner]]
        v = order[start[other][owner] + local % cb[owner]]
        ddx = pts[u, 0] - pts[v, 0]
        ddy = pts[u, 1] - pts[v, 1]
        keep = (ddx * ddx + ddy * ddy <= r * r) & (u < v)
        us.append(u[keep])
        vs.append(v[keep])
    return n, torch.cat(us).cpu().numpy(), torch.cat(vs).cpu().numpy()


def make(log2_n: int, seed: int, device="cpu"):
    """The rgg instance with 2**log2_n vertices made from ``seed``."""
    return rgg(1 << int(log2_n), int(seed), device=device)
