"""Multilevel k-way partitioner (the KaFFPa/Mt-KaHyPar substrate).

V-cycle: HEM-coarsen until the graph is small, greedy-grow an initial
k-way partition, project back up with LP refinement + rebalance per level.
Presets FAST/ECO/STRONG trade rounds/restarts for quality; seeded restarts
run and the best balanced partition wins.

Every level keeps the input's padded shapes (N, M), as the reference's
fused v-cycle does, so the two compare array for array. PyTorch runs
eagerly: the reference's two ``lax.scan``s over levels are Python loops
that keep each level's fine graph, and its ``vmap`` over the lanes of a
batch is a Python loop too (lanes are independent, so the results are the
same). The restarts of one call run as a leading batch
dimension through the initial partition and the refinement; the
coarsening does not depend on the restart, so they share it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .coarsen import _i32, coarsen_once
from .graph import (F32, I32, Graph, default_ell_deg, edge_mask, exact_sums,
                    resolve_device, xla_sum)
from .initial import initial_partition
from .refine import batched_block_weights, lp_refine, rebalance, resolve_backend
from ..kernels.ref import fma_f32


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    refine_rounds: int      # LP rounds per uncoarsening level
    coarsest_polish: int    # LP rounds on the coarsest graph
    restarts: int           # seeded restarts
    vcycles: int            # extra refine-only cycles at the finest level

    @staticmethod
    def get(name: str) -> "Preset":
        return _PRESETS[name.lower()]


_PRESETS = {
    "fast": Preset("fast", refine_rounds=2, coarsest_polish=4, restarts=1, vcycles=0),
    "eco": Preset("eco", refine_rounds=4, coarsest_polish=8, restarts=2, vcycles=1),
    "strong": Preset("strong", refine_rounds=8, coarsest_polish=12, restarts=4, vcycles=2),
}


def num_levels(n: int, k: int, coarse_factor: int = 24,
               max_degree: int | None = None) -> int:
    """Static coarsening depth: HEM shrinks ~1.6x/level; stop near 24*k.

    ``max_degree`` guards against matching stalls: a degree-``d`` hub lets
    at most ``n - d`` pairs form per level. Star-like graphs (implied
    shrink < 1.15x) stop at one level; hub-heavy ones extend the depth
    (capped) so the coarsest graph still approaches the target size.
    """
    target = max(coarse_factor * k, 64)
    if n <= target:
        return 0
    base = max(1, math.ceil(math.log(n / target) / math.log(1.6)))
    if max_degree is None:
        return base
    pairs = max(1, min(n // 2, n - int(max_degree)))
    shrink = n / max(1.0, n - pairs)
    if shrink < 1.15:
        return 1
    shrink = min(1.6, shrink)
    lv = math.ceil(math.log(n / target) / math.log(shrink))
    return max(1, min(lv, 2 * base + 4))


def _lmax(g: Graph, k: int, eps: torch.Tensor) -> torch.Tensor:
    return (1.0 + eps) * g.total_weight() / k


def _coarsen_levels(g: Graph, levels: int, ell_deg: int | None, coarsen: str = "ell"):
    """The v-cycle's downward half: ``(fines, maps, coarsest)``, every level
    at the shapes (N, M). Its salts depend on the level alone, never on the
    restart, so the restarts of one call share it (the reference recomputes
    it in each ``vmap`` lane, with the same result). ``coarsen="ell"`` runs
    the coarsening kernels, with the refinement's ELL cap where the caller
    pinned one; ``"segment"`` the exact segment path, with no cap."""
    if coarsen not in ("ell", "segment"):
        raise ValueError(f"coarsen must be 'ell' or 'segment', got {coarsen!r}")
    deg_c = None if coarsen == "segment" else (
        ell_deg if ell_deg is not None else default_ell_deg(g.N, g.M))
    fines, maps, cur = [], [], g
    for lvl in range(levels):
        gc, newid = coarsen_once(cur, salt=(lvl + 1) * 131 + 7, ell_deg=deg_c)
        fines.append(cur)
        maps.append(newid)
        cur = gc
    return fines, maps, cur


def _partition_restarts(g: Graph, k: int, eps: torch.Tensor, preset: Preset,
                        salts: list[int], backend: str, ell_deg: int | None,
                        fines: list, maps: list, coarsest: Graph) -> torch.Tensor:
    """The seeded restarts of one call as a leading batch dimension: [R, N]
    labellings over the coarsening of :func:`_coarsen_levels` (with no
    levels, the initial partition of ``g`` itself)."""
    Lmax = _lmax(g, k, eps)
    part = initial_partition(coarsest, k, Lmax, salt=salts,
                             polish_rounds=preset.coarsest_polish, backend=backend,
                             ell_deg=ell_deg)
    for lvl in range(len(fines) - 1, -1, -1):
        gf = fines[lvl]
        part = part[:, maps[lvl]]   # project to the finer level
        part = lp_refine(gf, part, k, Lmax, rounds=preset.refine_rounds,
                         salt=[_i32(s + 1000 + lvl) for s in salts], backend=backend,
                         ell_deg=ell_deg)
        part = rebalance(gf, part, k, Lmax, rounds=4,
                         salt=[_i32(s + 2000 + lvl) for s in salts], backend=backend,
                         ell_deg=ell_deg)
    for cyc in range(preset.vcycles):
        part = lp_refine(g, part, k, Lmax, rounds=preset.refine_rounds,
                         salt=[_i32(s + 3000 + cyc) for s in salts], backend=backend,
                         ell_deg=ell_deg)
        part = rebalance(g, part, k, Lmax, rounds=4,
                         salt=[_i32(s + 4000 + cyc) for s in salts], backend=backend,
                         ell_deg=ell_deg)
    return part


def _partition_on(g: Graph, k: int, eps: torch.Tensor, levels: int,
                  preset_name: str, salt: int, backend: str,
                  ell_deg: int | None, coarsen: str = "ell") -> torch.Tensor:
    preset = Preset.get(preset_name)
    if k == 1:
        return torch.zeros(g.N, dtype=I32, device=g.device)
    with exact_sums(g):   # the card's fast sums where every order is exact
        fines, maps, coarsest = _coarsen_levels(g, levels, ell_deg, coarsen)
        salts = [_i32(_i32(salt) * 131 + r * 7919) for r in range(preset.restarts)]
        parts = _partition_restarts(g, k, eps, preset, salts, backend, ell_deg,
                                    fines, maps, coarsest)
        cut = xla_sum(torch.where((parts[:, g.rows] != parts[:, g.cols]) & edge_mask(g),
                                  g.ewgt, 0.0)) / 2.0
        excess = batched_block_weights(g, parts, k) - _lmax(g, k, eps)
    over = xla_sum(excess.clamp(min=0.0))   # fractions: XLA's order on either device
    # XLA fuses cut + 1e6 * over into one FMA: round once, as it does
    scores = fma_f32(over, torch.tensor(1e6, dtype=F32, device=g.device), cut)
    return parts[torch.argmin(scores)]


def partition(g: Graph, k: int, eps, levels: int, preset_name: str = "eco",
              salt: int = 0, backend: str = "auto", ell_deg: int | None = None,
              coarsen: str = "ell", device=None) -> torch.Tensor:
    """Balanced k-way partition of ``g`` minimizing edge-cut.

    The restarts run as a batch; the winner is the best *balanced*
    partition by edge-cut (unbalanced runs are heavily penalized).
    ``ell_deg`` pins the ELL degree cap of the ``"ell"`` refinement and of
    the coarsening; pass one computed from the REAL vertex and edge counts
    (the default, from the padded shapes, is skewed by the padding).
    ``coarsen`` picks the coarsening: ``"ell"`` (the kernels) or
    ``"segment"`` (the exact sort-based path, no cap; the refinement runs
    the same either way). ``g`` is moved to ``device`` (``None`` = the
    card) first.
    """
    dev = resolve_device(device)
    g = g.to(dev)
    backend = resolve_backend(backend, dev)
    eps_t = torch.as_tensor(eps, dtype=F32, device=dev)
    return _partition_on(g, k, eps_t, levels, preset_name, int(salt), backend, ell_deg,
                         coarsen)


def batched_partition(gs: Graph, k: int, eps: torch.Tensor, salts: list[int],
                      levels: int, preset: str, backend: str,
                      ell_deg: int | None = None) -> torch.Tensor:
    """Partition every lane of a stacked ``[B, ...]`` Graph: ``[B, N]`` i32.

    The dispatch unit of the planner strategies; the lanes run one after
    another (the reference vmaps them), each with its own eps and salt.
    """
    backend = resolve_backend(backend, gs.device)
    out = [_partition_on(Graph(*(a[i] for a in gs)), k, eps[i], levels, preset,
                         salts[i], backend, ell_deg)
           for i in range(len(salts))]
    return torch.stack(out)


def partition_host(g: Graph, k: int, eps: float, preset: str = "eco", salt: int = 0,
                   backend: str = "auto", coarsen: str = "ell",
                   device=None) -> torch.Tensor:
    """:func:`partition` with the level count and ELL cap chosen from the
    REAL sizes, not the padded shapes; the largest degree feeds
    ``num_levels``' matching-stall guard (star-like graphs)."""
    dev = resolve_device(device)
    g = g.to(dev)
    n, m = int(g.n), int(g.m)
    ind = g.indptr.cpu().numpy()
    maxdeg = int((ind[1:n + 1] - ind[:n]).max()) if n > 0 else 0
    lv = num_levels(n, k, max_degree=maxdeg)
    deg = default_ell_deg(n, m) if resolve_backend(backend, dev) == "ell" else None
    return partition(g, k, eps, lv, preset, salt, backend, deg, coarsen, device=dev)
