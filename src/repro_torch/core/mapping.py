"""Mapping phase: J(C, D, Pi) evaluation, greedy construction and pair-swap
refinement on the quotient (communication-model) graph G_M.

Hierarchical multisection needs only the identity mapping (paper §4); the
routines below serve ``refine_mapping=True`` and the two-phase baselines:

* ``greedy_mapping``  — Müller-Merbach-style construction: repeatedly place
  the unmapped block with the strongest communication to already-mapped
  blocks onto the free PE with minimal added cost.
* ``swap_refine``     — Brandfass/Schulz-Träff pairwise swaps, restricted to
  communicating pairs plus a random sample, with a vectorized delta-J.

Only ``evaluate_J`` runs on the graph's device (the ``mapcost`` kernel on
the card). The others are host numpy on k x k matrices, as in the reference:
``quotient_matrix`` fetches the edge arrays once and sums in float64 in edge
order (``np.add.at``), so that ``swap_refine``'s ``delta < -1e-12``
decisions see the same bits on every device. Float atomics on the card
would add in a timing-dependent order.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph import I32, Graph, resolve_device
from .hierarchy import Hierarchy, _tables
from ..kernels import ops as kops


def evaluate_J(g: Graph, h: Hierarchy, pe_of, device=None) -> float:
    """Total communication cost J(C, D, Pi) of a vertex->PE assignment.

    Runs the ``mapcost`` kernel on the card (its plain version on the CPU).
    ``g`` is moved to ``device`` (``None`` = the card); padded edge slots
    carry weight 0, so no mask is needed. ``pe_of`` is a tensor or any
    numpy-convertible sequence of one PE id per vertex.
    """
    dev = resolve_device(device)
    g = g.to(dev)
    if not isinstance(pe_of, torch.Tensor):
        pe_of = torch.from_numpy(np.asarray(pe_of))
    pe = pe_of.to(device=dev, dtype=I32)
    if pe.shape[0] > g.N:
        raise ValueError(
            f"pe_of has {pe.shape[0]} entries but the graph holds only "
            f"{int(g.n)} vertices (padded to N={g.N}); pass one PE id per "
            f"vertex of THIS graph")
    if pe.shape[0] < g.N:
        pe = torch.cat([pe, torch.zeros(g.N - pe.shape[0], dtype=I32, device=dev)])
    g_below, dvec = _tables(h, dev)
    return float(kops.mapcost(g.rows, g.cols, g.ewgt, pe.contiguous(), g_below, dvec))


def quotient_matrix(g: Graph, part: np.ndarray, k: int) -> np.ndarray:
    """Dense symmetric [k, k] float64 communication matrix between blocks.

    Fetches the real edge slots of ``g`` (on any device) to the host once."""
    m = int(g.m)
    rows = g.rows[:m].cpu().numpy()
    cols = g.cols[:m].cpu().numpy()
    w = g.ewgt[:m].cpu().numpy()
    part = np.asarray(part)
    pu = part[rows]
    pv = part[cols]
    mask = pu != pv
    C = np.zeros((k, k))
    np.add.at(C, (pu[mask], pv[mask]), w[mask])
    return (C + C.T) / 2.0  # directed edges stored twice -> symmetrize


def greedy_mapping(C: np.ndarray, h: Hierarchy) -> np.ndarray:
    """Map k blocks onto k PEs greedily (construction heuristic); int64."""
    k = C.shape[0]
    if k != h.k:
        raise ValueError(f"blocks ({k}) != PEs ({h.k})")
    D = h.distance_table()
    pe_of = np.full(k, -1, np.int64)
    free_pe = np.ones(k, bool)
    mapped = np.zeros(k, bool)

    first = int(np.argmax(C.sum(1)))
    pe_of[first] = 0
    free_pe[0] = False
    mapped[first] = True

    for _ in range(k - 1):
        conn = C[:, mapped].sum(1)
        conn[mapped] = -np.inf
        t = int(np.argmax(conn))
        # added cost of placing t on each free PE
        cost = (C[t, mapped][None, :] * D[:, pe_of[mapped]]).sum(1)
        cost[~free_pe] = np.inf
        p = int(np.argmin(cost))
        pe_of[t] = p
        free_pe[p] = False
        mapped[t] = True
    return pe_of


def map_cost_dense(C: np.ndarray, D: np.ndarray, pe_of: np.ndarray) -> float:
    return float((C * D[np.ix_(pe_of, pe_of)]).sum() / 2.0)


def swap_refine(C: np.ndarray, h: Hierarchy, pe_of: np.ndarray, max_passes: int = 10,
                sample: int = 4096, seed: int = 0) -> np.ndarray:
    """Pairwise-swap local search on the block->PE assignment.

    Each pass draws ``rng.integers(0, k, sample)`` twice from
    ``np.random.default_rng(seed)``, the reference's generator and order, so
    the same seed samples the same pairs."""
    k = C.shape[0]
    D = h.distance_table()
    rng = np.random.default_rng(seed)
    pe_of = pe_of.copy()

    iu, iv = np.nonzero(np.triu(C, 1) > 0)
    base_pairs = np.stack([iu, iv], 1) if iu.size else np.zeros((0, 2), np.int64)

    for _ in range(max_passes):
        if k >= 2:
            ru = rng.integers(0, k, sample)
            rv = rng.integers(0, k, sample)
            keep = ru < rv
            pairs = np.concatenate([base_pairs, np.stack([ru[keep], rv[keep]], 1)])
        else:
            pairs = base_pairs
        if pairs.shape[0] == 0:
            break
        a, b = pairs[:, 0], pairs[:, 1]
        pa, pb = pe_of[a], pe_of[b]
        # delta J of swapping the assignments of blocks a and b. With
        # cost_x_p = sum_j C[x,j] * D[p, pe_of[j]] over the OLD assignment,
        # symmetric D and C[x,x] = 0:
        #   J_now(pair) = cost_a_pa + cost_b_pb - C[a,b] * D[pa,pb]
        #   J_new(pair) = cost_a_pb + cost_b_pa + C[a,b] * D[pa,pb]
        cost_a_now = (C[a] * D[pa][:, pe_of]).sum(1)
        cost_b_now = (C[b] * D[pb][:, pe_of]).sum(1)
        cost_a_new = (C[a] * D[pb][:, pe_of]).sum(1)
        cost_b_new = (C[b] * D[pa][:, pe_of]).sum(1)
        delta = (cost_a_new + cost_b_new) - (cost_a_now + cost_b_now) \
            + 2.0 * C[a, b] * D[pa, pb]
        order = np.argsort(delta)
        improved = False
        touched = np.zeros(k, bool)
        for idx in order:
            if delta[idx] >= -1e-12:
                break
            x, y = int(a[idx]), int(b[idx])
            if touched[x] or touched[y]:
                continue
            # exact delta check before applying
            old = _pair_cost(C, D, pe_of, x, y)
            pe_of[x], pe_of[y] = pe_of[y], pe_of[x]
            new = _pair_cost(C, D, pe_of, x, y)
            if new >= old - 1e-12:
                pe_of[x], pe_of[y] = pe_of[y], pe_of[x]
                continue
            touched[x] = touched[y] = True
            improved = True
        if not improved:
            break
    return pe_of


def _pair_cost(C: np.ndarray, D: np.ndarray, pe_of: np.ndarray, x: int, y: int) -> float:
    cx = (C[x] * D[pe_of[x], pe_of]).sum()
    cy = (C[y] * D[pe_of[y], pe_of]).sum()
    return float(cx + cy - C[x, y] * D[pe_of[x], pe_of[y]])
