"""Mapping phase: J(C, D, Pi) evaluation.

Hierarchical multisection needs only the identity mapping (paper §4). The
two-phase routines of the reference (``quotient_matrix``,
``greedy_mapping``, ``swap_refine``) serve ``refine_mapping=True`` and the
baselines; they wait for a later slice of the port.
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
