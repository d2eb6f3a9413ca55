"""SharedMap public API (PyTorch port).

>>> from repro_torch.core.api import shared_map, SharedMapConfig
>>> res = shared_map(graph, hierarchy)          # on the card
>>> res = shared_map(graph, hierarchy, device="cpu")
>>> res = shared_map(TaskGraph.from_graph(graph), hierarchy, device="cpu")
>>> res.pe_of, res.J

With a mapping service installed (``serve/mapper.py``), ``shared_map`` is
answered by it: coalesced with concurrent requests, from its result cache
when it can, bit for bit the direct path's result either way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import spans
from .graph import Graph, resolve_device
from .hierarchy import Hierarchy
from .mapping import evaluate_J, quotient_matrix, swap_refine
from .multisection import hierarchical_multisection
from .taskgraph import TaskGraph


@dataclasses.dataclass(frozen=True)
class SharedMapConfig:
    eps: float = 0.03
    preset: str = "eco"          # fast | eco | strong
    strategy: str = "bucket"     # naive | layer | bucket | queue | device
    # ("device" = the fully device-resident level loop: fixed root-shape
    #  schedule, on-device split/eps/pe accumulation, exactly ONE
    #  device->host fetch per request; see core/multisection.py.)
    seed: int = 0
    adaptive: bool = True        # Lemma 5.1 adaptive imbalance
    backend: str = "auto"        # refinement: auto | ell | xla
    # ("ell" = the lp_gain kernel over the padded [N, DEG] adjacency;
    #  "auto" picks it on the card and "xla" on the CPU.)
    coarsen_telemetry: bool = False  # fill stats["coarsen"] with the root
    # graph's per-level coarsening sizes (one more pass on the device)
    refine_mapping: bool = False  # optional block<->PE swap pass. The paper's
    # SharedMap has none (§6.4); it evens the comparison against GM, which
    # refines (DESIGN.md §2.3).


@dataclasses.dataclass
class SharedMapResult:
    pe_of: np.ndarray
    J: float
    stats: dict


# An installed serve.mapper.MappingService (None = direct execution). The
# hook lives here so that core imports nothing of serve (serve imports core).
_SERVICE = None


def install_service(service) -> object | None:
    """Route ``shared_map`` through ``service`` (None = the direct path).
    Returns the previously installed service."""
    global _SERVICE
    prev = _SERVICE
    _SERVICE = service
    return prev


def current_service():
    return _SERVICE


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:<current>`` name one card."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def shared_map(g: Graph | TaskGraph, h: Hierarchy, config: SharedMapConfig | None = None,
               device=None) -> SharedMapResult:
    """Solve GPMP for communication graph ``g`` on hierarchy ``h``.

    ``g`` is a padded-CSR :class:`Graph`, moved to ``device`` (``None`` =
    the card, which must exist; pass ``device="cpu"`` to run the plain
    versions on the CPU), or a :class:`TaskGraph`, lowered through its
    memoized ``to_graph(device=...)``: ``shared_map(tg)`` and
    ``shared_map(tg.to_graph())`` give the same result bit for bit.

    With a service installed the request goes through it. ``device`` must
    then name the service's device: a request is never moved to another
    device than the one its caller asked for (``ValueError``).
    """
    cfg = config or SharedMapConfig()
    svc = _SERVICE
    if svc is not None:
        want = torch.device("cuda" if device is None else device)
        if not _same_device(want, svc.device):
            raise ValueError(f"shared_map(device={str(want)!r}): the installed mapping "
                             f"service runs on {str(svc.device)!r}")
        return svc.map(g, h, cfg)
    return shared_map_direct(g, h, cfg, device=device)


def shared_map_direct(g: Graph | TaskGraph, h: Hierarchy, cfg: SharedMapConfig,
                      checkpoint=None, resident=None, device=None) -> SharedMapResult:
    """The in-process path, and the one the mapping service falls back on
    for the strategies it does not coalesce (``naive``, ``queue``).
    ``checkpoint`` (optional zero-arg callable) is
    called between multisection levels; raising inside it aborts the run.
    ``resident`` overrides the planner strategies' device residency (None =
    the strategy's default); ``False`` runs the bitwise host-mirror twin."""
    with spans.span("map"):
        dev = resolve_device(device)
        g = g.to_graph(device=dev) if isinstance(g, TaskGraph) else g.to(dev)
        res = hierarchical_multisection(
            g, h, eps=cfg.eps, preset=cfg.preset, strategy=cfg.strategy,
            seed=cfg.seed, adaptive=cfg.adaptive, backend=cfg.backend,
            checkpoint=checkpoint, resident=resident,
            coarsen_telemetry=cfg.coarsen_telemetry, device=dev)
        with spans.span("map.finalize"):
            res.pe_of = finalize_mapping(g, h, cfg, res.pe_of, res.stats)
            J = evaluate_J(g, h, res.pe_of, device=dev)
        return SharedMapResult(pe_of=res.pe_of, J=J, stats=res.stats)


def finalize_mapping(g: Graph, h: Hierarchy, cfg: SharedMapConfig,
                     pe_of: np.ndarray, stats: dict) -> np.ndarray:
    """The post-multisection step: the optional block<->PE swap pass on the
    host (``quotient_matrix`` fetches the graph's edges once). The result
    stays int32, as the multisection's ``pe_of`` is. The service's planner
    path finalizes with this same function, so its results are the direct
    path's bit for bit."""
    if cfg.refine_mapping:
        C = quotient_matrix(g, pe_of, h.k)
        perm = swap_refine(C, h, np.arange(h.k, dtype=np.int32), seed=cfg.seed)
        pe_of = perm[pe_of].astype(np.int32, copy=False)
        stats["refined"] = True
    return pe_of
