"""Multilevel k-way partitioner (the KaFFPa/Mt-KaHyPar substrate).

V-cycle: HEM-coarsen until the graph is small, greedy-grow an initial
k-way partition, project back up with LP refinement + rebalance per level.
Presets FAST/ECO/STRONG trade rounds/restarts for quality; seeded restarts
run and the best balanced partition wins.

Every level keeps the input's padded shapes (N, M), as the reference's
fused v-cycle does, so the two compare array for array. PyTorch runs
eagerly: the reference's two ``lax.scan``s over levels are Python loops
that keep each level's fine graph. Its ``vmap`` over the lanes of a batch
(:func:`batched_partition`) is a leading lane axis: one v-cycle runs every
lane of a dispatch, one coarsening per level, one initial partition, one
refinement and rebalance round for all lanes, each device operation and
kernel launch covering every lane (lanes are independent and ids stay
lane-local, so each lane's result is what it would be alone).
:func:`partition` is the case of one lane. The restarts of each lane run
as a second batch axis through the initial partition and the refinement
(B * R rows); the coarsening does not depend on the restart, so they share
it.

Spans (``core/spans.py``, recorded only while on): ``partitioner.batch``
per :func:`batched_partition` call, and under it, per chunk of lanes,
``partitioner.coarsen``, ``partitioner.initial``, ``partitioner.refine``
(projection and refinement up the levels, then the v-cycles) and
``partitioner.select``. They time the host issuing the v-cycle: the
card runs it asynchronously.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import spans
from .coarsen import _i32, coarsen_once
from .graph import (F32, I32, Graph, as_lanes, default_ell_deg, edge_mask, exact_sums,
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
    at the shapes (N, M), of one graph or of every lane of a batch at once.
    Its salts depend on the level alone, never on the lane or the restart,
    so the lanes draw the same salts and the restarts of a lane share it
    (the reference recomputes it in each ``vmap`` lane, with the same
    result). ``coarsen="ell"`` runs the coarsening kernels, with the
    refinement's ELL cap where the caller pinned one; ``"segment"`` the
    exact segment path, with no cap."""
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
                        salts: list[list[int]], backend: str, ell_deg: int | None,
                        fines: list, maps: list, coarsest: Graph) -> torch.Tensor:
    """The seeded restarts of every lane of the batch ``g`` [B, ...]:
    [B, R, N] labellings over the coarsening of :func:`_coarsen_levels`
    (with no levels, the initial partition of ``g`` itself); ``salts`` holds
    the R restart salts of each lane, ``eps`` [B] its imbalance."""
    Lmax = _lmax(g, k, eps)

    def shifted(d):   # every restart salt plus d, wrapped as the reference's i32
        return [[_i32(s + d) for s in row] for row in salts]
    with spans.span("partitioner.initial"):
        part = initial_partition(coarsest, k, Lmax, salt=salts,
                                 polish_rounds=preset.coarsest_polish, backend=backend,
                                 ell_deg=ell_deg)
    B, R, N = part.shape
    with spans.span("partitioner.refine"):
        for lvl in range(len(fines) - 1, -1, -1):
            gf = fines[lvl]
            part = part.gather(2, maps[lvl].long()[:, None, :].expand(B, R, N))   # project
            part = lp_refine(gf, part, k, Lmax, rounds=preset.refine_rounds,
                             salt=shifted(1000 + lvl), backend=backend, ell_deg=ell_deg)
            part = rebalance(gf, part, k, Lmax, rounds=4, backend=backend, ell_deg=ell_deg)
        for cyc in range(preset.vcycles):
            part = lp_refine(g, part, k, Lmax, rounds=preset.refine_rounds,
                             salt=shifted(3000 + cyc), backend=backend, ell_deg=ell_deg)
            part = rebalance(g, part, k, Lmax, rounds=4, backend=backend, ell_deg=ell_deg)
    return part


def _partition_lanes(g: Graph, k: int, eps: torch.Tensor, levels: int,
                     preset_name: str, salts: list[int], backend: str,
                     ell_deg: int | None, coarsen: str = "ell") -> torch.Tensor:
    """One v-cycle for every lane of the batch ``g`` [B, ...]: [B, N] i32,
    lane b with imbalance ``eps[b]`` and salt ``salts[b]``. The winner of
    each lane's restarts is picked per lane."""
    preset = Preset.get(preset_name)
    B, N = g.vwgt.shape
    if k == 1:
        return torch.zeros(B, N, dtype=I32, device=g.device)
    with exact_sums(g):   # the card's fast sums where every order is exact
        with spans.span("partitioner.coarsen"):
            fines, maps, coarsest = _coarsen_levels(g, levels, ell_deg, coarsen)
        rsalts = [[_i32(_i32(s) * 131 + r * 7919) for r in range(preset.restarts)]
                  for s in salts]
        parts = _partition_restarts(g, k, eps, preset, rsalts, backend, ell_deg,
                                    fines, maps, coarsest)
        with spans.span("partitioner.select"):   # each restart's cut and excess
            R = parts.shape[1]
            rows = g.rows.long()[:, None, :].expand(B, R, g.M)
            cols = g.cols.long()[:, None, :].expand(B, R, g.M)
            cut_edge = (parts.gather(2, rows) != parts.gather(2, cols)) & edge_mask(g)[:, None]
            cut = xla_sum(torch.where(cut_edge, g.ewgt[:, None], 0.0)) / 2.0        # [B, R]
            excess = batched_block_weights(g, parts, k) - _lmax(g, k, eps)[:, None, None]
    over = xla_sum(excess.clamp(min=0.0))   # fractions: XLA's order on either device
    # XLA fuses cut + 1e6 * over into one FMA: round once, as it does
    scores = fma_f32(over, torch.tensor(1e6, dtype=F32, device=g.device), cut)
    win = torch.argmin(scores, dim=1)
    return parts[torch.arange(B, device=g.device), win]


def partition(g: Graph, k: int, eps, levels: int, preset_name: str = "eco",
              salt: int = 0, backend: str = "auto", ell_deg: int | None = None,
              coarsen: str = "ell", device=None) -> torch.Tensor:
    """Balanced k-way partition of ``g`` minimizing edge-cut: the one-lane
    case of :func:`batched_partition`.

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
    gb, _ = as_lanes(g.to(dev))
    backend = resolve_backend(backend, dev)
    eps_t = torch.as_tensor(eps, dtype=F32, device=dev).reshape(1)
    return _partition_lanes(gb, k, eps_t, levels, preset_name, [int(salt)], backend,
                            ell_deg, coarsen)[0]


# Bytes one chunk of lanes of batched_partition may reckon with (see
# lane_bytes). A fixed constant, never the card's free memory, so a
# dispatch is cut into the same chunks on every run; lanes are independent,
# so the chunking never changes a result.
LANE_CHUNK_BYTES = 16 << 30


def lane_bytes(N: int, M: int, k: int, levels: int, restarts: int, deg: int) -> int:
    """Device bytes one lane of a partition call at the padded shapes (N, M)
    holds at its peak, reckoned: every level's fine graph and map (the
    v-cycle keeps them all), the ELL rows, jitters and contraction
    candidates of a level, and the refinement's [R, N, k] and [R, M, k]
    temporaries (the segmented connectivity sum). For rgg 2^20 on 4:8:6 it
    gives 6.9 GB at the root call (N 2^20, M 2^24, k 6, 19 levels, R 2, DEG
    24) and 4.7 GB for the 48 lanes of the last level (N 2^15, M 2^18, k 4,
    13 levels); on an H100 the two calls peaked at 7.0 GB and 4.9 GB."""
    graph = 4 * (3 * N + 3 * M)
    ell = 32 * N * deg
    rows = restarts * (26 * N * k + 6 * M * k + 8 * M)
    return (levels + 1) * graph + ell + rows


def lanes_per_chunk(per_lane: int) -> int:
    """How many lanes of ``per_lane`` reckoned bytes one chunk takes: as
    many as ``LANE_CHUNK_BYTES`` holds, at least one."""
    return max(1, LANE_CHUNK_BYTES // per_lane)


def batched_partition(gs: Graph, k: int, eps: torch.Tensor, salts: list[int],
                      levels: int, preset: str, backend: str,
                      ell_deg: int | None = None, coarsen: str = "ell") -> torch.Tensor:
    """Partition every lane of a stacked ``[B, ...]`` Graph: ``[B, N]`` i32,
    lane b with imbalance ``eps[b]`` and salt ``salts[b]``.

    The dispatch unit of the planner strategies, the reference's ``vmap``
    of :func:`partition` over the lanes: one v-cycle runs all lanes of a
    chunk together (:func:`_partition_lanes`). The lanes are cut into
    consecutive chunks whose :func:`lane_bytes` fit ``LANE_CHUNK_BYTES``;
    each lane's result is the same in any chunking and equals its own
    :func:`partition` call.
    """
    backend = resolve_backend(backend, gs.device)
    B = len(salts)
    deg = ell_deg if ell_deg is not None else default_ell_deg(gs.N, gs.M)
    per = lanes_per_chunk(lane_bytes(gs.N, gs.M, k, levels, Preset.get(preset).restarts, deg))
    with spans.span("partitioner.batch", lanes=B):
        out = [_partition_lanes(Graph(*(a[i:i + per] for a in gs)), k, eps[i:i + per],
                                levels, preset, salts[i:i + per], backend, ell_deg, coarsen)
               for i in range(0, B, per)]
        return out[0] if len(out) == 1 else torch.cat(out)


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
