"""Plain reference of what a mapping must satisfy, from the benchmark's own
edge lists and hierarchy. NumPy (float64), and torch only for the control's
lower precision; it imports nothing of the program.

The paper's objective (arXiv:2504.01726, §2): PEs are numbered in mixed
radix over the hierarchy H = a_1 : ... : a_l (a_1 innermost); two PEs whose
ids first differ, counting from the outermost digit, at level i are d_i
apart (D = d_1 : ... : d_l), and a PE is 0 from itself. The cost of a
mapping is J = sum over undirected edges {u, v} of w(u, v) * d(pe_u, pe_v);
a mapping is eps-balanced when no PE holds more than (1 + eps) c(V) / k of
the vertex weight.
"""
from __future__ import annotations

import numpy as np


def distance_table(a, d) -> np.ndarray:
    """[k, k] float64 distances between the k = prod(a) PEs."""
    a = [int(x) for x in a]
    k = int(np.prod(a))
    pe = np.arange(k)
    digits = []
    rest = pe.copy()
    for ai in a:
        digits.append(rest % ai)
        rest = rest // ai
    table = np.zeros((k, k))
    for level, di in enumerate(d):  # innermost first: outer levels overwrite
        differ = digits[level][:, None] != digits[level][None, :]
        table[differ] = float(di)
    return table


def cost(u: np.ndarray, v: np.ndarray, w, pe_of: np.ndarray, table: np.ndarray) -> float:
    """J in float64 over the undirected edge list ``(u, v, w)``; ``w`` None
    is unit weights."""
    dist = table[pe_of[u], pe_of[v]]
    return float(dist.sum() if w is None else (np.asarray(w, np.float64) * dist).sum())


def cost_lower_precision(u, v, w, pe_of, table, dtype) -> float:
    """J as :func:`cost` computes it, with every value and the sum in
    ``dtype`` (a torch dtype): the control of the comparison."""
    import torch
    dist = torch.from_numpy(table[pe_of[u], pe_of[v]]).to(dtype)
    ww = torch.ones_like(dist) if w is None else torch.from_numpy(np.asarray(w)).to(dtype)
    return float(torch.sum(ww * dist, dtype=dtype))


def check(n: int, u, v, w, vwgt, pe_of, J, a, d, table=None) -> dict:
    """The numbers one mapping is judged by:

    * ``bad_pe``: entries of ``pe_of`` that are not a PE id, plus the
      difference between its length and ``n`` (0 for a valid mapping);
    * ``imbalance``: the heaviest PE's weight over c(V) / k, less 1;
    * ``J_gap``: |J reported - J of the reference| / J of the reference.
    """
    k = int(np.prod(a))
    table = distance_table(a, d) if table is None else table
    pe = np.asarray(pe_of)
    bad = int(abs(pe.shape[0] - n)) + int(((pe < 0) | (pe >= k)).sum())
    if bad:
        return {"bad_pe": bad, "imbalance": float("inf"), "J_gap": float("inf")}
    pe = pe.astype(np.int64)
    vw = np.ones(n) if vwgt is None else np.asarray(vwgt, np.float64)
    loads = np.bincount(pe, weights=vw, minlength=k)
    imbalance = float(loads.max() / (vw.sum() / k) - 1.0)
    j_ref = cost(u, v, w, pe, table)
    gap = abs(float(J) - j_ref) / j_ref if j_ref else float(abs(float(J)) > 0)
    return {"bad_pe": 0, "imbalance": imbalance, "J_gap": gap}
