"""Baseline GPMP solvers the paper compares against (§3, §6.4).

* ``kaffpa_map_style``     — two-phase: flat k-way partition of G_C via
  recursive bisection (multisection over H = (2, ..., 2)), then greedy
  construction and pair-swap refinement on the quotient graph G_M.
  (KAFFPA-MAP [38])
* ``global_multisection``  — hierarchical multisection WITHOUT the adaptive
  imbalance (eps' = eps at every level), plus swap refinement. (GM [42])
* ``greedy_baseline``      — contiguous blocks placed greedily on G_M.
* ``random_mapping`` / ``identity_mapping`` — sanity floors.

The multisections run on ``device`` (``None`` = the card) through the same
kernels as ``shared_map``; the mapping phase on G_M is host numpy
(``core/mapping.py``), so a card run and a CPU run give the same ``pe_of``
wherever their multisections agree.
"""
from __future__ import annotations

import math

import numpy as np

from .graph import Graph, resolve_device
from .hierarchy import Hierarchy
from .mapping import evaluate_J, greedy_mapping, quotient_matrix, swap_refine
from .multisection import MultisectionResult, hierarchical_multisection


def identity_mapping(g: Graph, h: Hierarchy, seed: int = 0, device=None) -> np.ndarray:
    """Blocks of contiguous vertex ids -> PEs (what a naive launcher does);
    int64. Reads only the vertex count; ``device`` is checked as everywhere."""
    resolve_device(device)
    n = int(g.n)
    return (np.arange(n, dtype=np.int64) * h.k) // max(n, 1)


def random_mapping(g: Graph, h: Hierarchy, seed: int = 0, device=None) -> np.ndarray:
    """The contiguous blocks under a permutation of the PEs drawn from
    ``np.random.default_rng(seed)`` (the reference's draw); int64."""
    pe = identity_mapping(g, h, seed, device=device)
    return np.random.default_rng(seed).permutation(h.k)[pe]


def greedy_baseline(g: Graph, h: Hierarchy, seed: int = 0, device=None) -> np.ndarray:
    """Cheapest non-trivial mapping: contiguous-block partition + greedy
    quotient-graph placement (no multisection, no refinement, O(m + k^2));
    int64. The floor of the mapping service's degradation ladder."""
    g = g.to(resolve_device(device))
    part = identity_mapping(g, h, seed, device=g.device)
    C = quotient_matrix(g, part, h.k)
    return greedy_mapping(C, h)[part]


def global_multisection(g: Graph, h: Hierarchy, eps: float = 0.03, preset: str = "eco",
                        strategy: str = "bucket", seed: int = 0, backend: str = "auto",
                        device=None) -> MultisectionResult:
    """GM [42]: multisection with a FIXED eps per level + swap refinement.
    ``stats`` gains ``J_before_refine`` and ``J_after_refine`` (``mapcost``
    on the card); ``pe_of`` is int64."""
    dev = resolve_device(device)
    g = g.to(dev)
    res = hierarchical_multisection(g, h, eps=eps, preset=preset, strategy=strategy,
                                    seed=seed, adaptive=False, backend=backend, device=dev)
    res.stats["J_before_refine"] = evaluate_J(g, h, res.pe_of, device=dev)
    C = quotient_matrix(g, res.pe_of, h.k)
    pe_perm = swap_refine(C, h, np.arange(h.k, dtype=np.int64), seed=seed)
    res.pe_of = pe_perm[res.pe_of]
    res.stats["refined"] = True
    res.stats["J_after_refine"] = evaluate_J(g, h, res.pe_of, device=dev)
    return res


def kaffpa_map_style(g: Graph, h: Hierarchy, eps: float = 0.03, preset: str = "eco",
                     strategy: str = "bucket", seed: int = 0, backend: str = "auto",
                     device=None) -> MultisectionResult:
    """KAFFPA-MAP [38]: flat k-way first, then map the quotient graph.
    Needs a power-of-two k; ``pe_of`` is int64."""
    k = h.k
    lg = math.log2(k)
    if lg != int(lg):
        raise ValueError("kaffpa_map_style requires power-of-two k")
    dev = resolve_device(device)
    g = g.to(dev)
    # phase 1: recursive bisection == multisection over H=(2,)*log2(k)
    rb = Hierarchy(a=(2,) * int(lg), d=(1.0,) * int(lg))
    res = hierarchical_multisection(g, rb, eps=eps, preset=preset, strategy=strategy,
                                    seed=seed, adaptive=True, backend=backend, device=dev)
    part = res.pe_of  # k-way partition (block ids)
    # phase 2: greedy construction and swaps on G_M (k vertices)
    C = quotient_matrix(g, part, k)
    pe_perm = greedy_mapping(C, h)
    pe_perm = swap_refine(C, h, pe_perm, seed=seed)
    res.pe_of = pe_perm[part]
    res.stats["refined"] = True
    res.stats["J_after_refine"] = evaluate_J(g, h, res.pe_of, device=dev)
    return res
