"""Hierarchical multisection (the paper's §4), bucket strategy.

The communication graph is partitioned along the hierarchy
``H = a_1 : ... : a_l`` (top-down: first a_l, then a_{l-1}, ...), with the
adaptive imbalance of Lemma 5.1 applied at every sub-partition, so the
final k-way partition is eps-balanced and the identity mapping solves the
mapping phase.

This slice ports the reference's default: the ``bucket`` strategy (the
subgraphs of a level are grouped into power-of-two size buckets, one
batched partition call per bucket) with ``resident=True`` (every level's
subgraphs stay on the device in stacked per-group containers; only their
sizes and weights, needed for the bucket shapes and the f64 imbalance
rule, cross to the host per level). The ``layer``, ``device``, ``naive``
and ``queue`` strategies and ``resident=False`` raise
``NotImplementedError``.

Planner and executor are split as in the reference: :func:`plan_level`
turns a level into :class:`PlanGroup`s (pure bookkeeping),
:func:`dispatch_group_batch`/:func:`fetch_group_batch` run one batched
partition call for groups sharing an ``exec_key``, and
:class:`LevelPlanner` steps one hierarchy level by level. The reference's
``stats["compile_cache"]`` has no meaning without ``jit`` and is left out.

Transfer accounting: module-level counters (:func:`transfer_stats`,
:func:`reset_transfer_stats`) record every host<->device movement the
multisection makes: per-level metadata fetches (``d2h_meta_fetches``) and
the one final ``pe_of`` fetch (``d2h_array_fetches``).

Salts derive from a subgraph's position in the hierarchy, so results are
reproducible and equal to the reference's bucket strategy.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np
import torch

from .graph import (F32, I32, Graph, repad_device, resolve_device, split_blocks,
                    take_lanes)
from .hierarchy import Hierarchy, adaptive_epsilon
from .partition import batched_partition, num_levels
from .refine import resolve_backend

# ---------------------------------------------------------------------------
# host<->device transfer accounting
# ---------------------------------------------------------------------------

_XFER_LOCK = threading.Lock()


def _zero_xfer() -> dict:
    return {"h2d_bytes": 0, "h2d_transfers": 0,
            "d2h_bytes": 0, "d2h_array_fetches": 0,
            "d2h_meta_bytes": 0, "d2h_meta_fetches": 0}


_XFER = _zero_xfer()


def _acct(**kw) -> None:
    with _XFER_LOCK:
        for key, v in kw.items():
            _XFER[key] += int(v)


def transfer_stats() -> dict:
    """Snapshot of the process-wide transfer counters (see module doc)."""
    with _XFER_LOCK:
        return dict(_XFER)


def reset_transfer_stats() -> None:
    with _XFER_LOCK:
        _XFER.update(_zero_xfer())


def _next_pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


# ---------------------------------------------------------------------------
# device-resident level state and its operations
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _DeviceLevel:
    """One dispatch group's children, resident on the device: a stacked
    ``[B, ...]`` Graph plus the [B, N] original-vertex-id view."""

    g: Graph
    orig: torch.Tensor   # [B, N] ids into the ROOT graph (pad -> sentinel)
    depth: int


@dataclasses.dataclass
class _LaneRef:
    """Host-side metadata of one device-resident lane: all the planner needs
    (shape keys, eps inputs, salt derivation) without touching the arrays."""

    level: _DeviceLevel
    lane: int
    depth: int
    pe_base: int
    uid: int
    n: int = -1
    m: int = -1
    wsum: float = 0.0


def _root_op(g: Graph, N0: int, M0: int):
    """g -> ([1,...] repadded batch, [1, N0] orig ids, f32 total weight)."""
    g2 = repad_device(g, N0, M0)
    ar = torch.arange(N0, dtype=I32, device=g.device)
    orig = torch.where(ar < g2.n, ar, g2.n)   # sentinel = n (spare pe slot)
    batch = Graph(*(a[None] for a in g2))
    return batch, orig[None], torch.sum(g2.vwgt)


def _split_op(gb: Graph, parts: torch.Tensor, ob: torch.Tensor, arity: int,
              sent: torch.Tensor):
    """[B]-lane batch -> [B*arity]-lane children (+ orig ids + weights)."""
    out = [split_blocks(Graph(*(a[i] for a in gb)), parts[i], ob[i], arity, sent)
           for i in range(ob.shape[0])]
    ch = Graph(*(torch.cat(f) for f in zip(*(c for c, _, _ in out))))
    return ch, torch.cat([o for _, o, _ in out]), torch.cat([w for _, _, w in out])


def _gather_op(gb: Graph, ob: torch.Tensor, sel: torch.Tensor, Nd: int, Md: int,
               sent: torch.Tensor):
    """Select lanes of a [B,...] container and repad them to (Nd, Md): how
    resident bucket groups assemble their dispatch batches."""
    sub = repad_device(take_lanes(gb, sel), Nd, Md)
    o = ob.index_select(0, sel)
    Ns = o.shape[1]
    if Nd <= Ns:
        o = o[:, :Nd].contiguous()
    else:
        pad = sent.to(I32).expand(o.shape[0], Nd - Ns)
        o = torch.cat([o, pad], dim=1)
    return sub, o


def _scatter_op(pe: torch.Tensor, ob: torch.Tensor, parts: torch.Tensor,
                bases: torch.Tensor, N: int) -> torch.Tensor:
    """Leaf write: pe[orig[b, v]] = base[b] + part[b, v] (pads hit the
    sentinel slot; the buffer has one spare entry for exactly that)."""
    vals = bases[:, None] + parts[:, :N].to(I32)
    pe[ob.reshape(-1)] = vals.reshape(-1)
    return pe


# ---------------------------------------------------------------------------
# the level planner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanGroup:
    """One bucket dispatch planned from a single hierarchy's current level:
    members, padded shapes, arity, preset/backend, per-member eps and salts
    (position-derived, so independent of the batch a member rides in), and
    the stacked device batch with its [B, N] original-id view."""

    members: list
    N: int                # padded vertex shape of the dispatch
    M: int                # padded edge shape
    arity: int            # k of each member's sub-partition
    levels: int           # static coarsening depth for (N, arity)
    preset: str
    backend: str
    eps: list[float]
    salts: list[int]
    batch: Graph | None = None
    batch_orig: torch.Tensor | None = None

    @property
    def exec_key(self) -> tuple:
        """Groups with equal keys may be stacked into ONE dispatch."""
        return (self.N, self.M, self.arity, self.levels, self.preset, self.backend)


def _eps_for(hg, h: Hierarchy, eps: float, total_weight: float,
             adaptive: bool) -> float:
    if not adaptive:
        return eps
    d = hg.depth
    k_sub = int(np.prod(h.a[:d])) if d > 0 else 1
    return adaptive_epsilon(eps, total_weight, hg.wsum, h.k, k_sub, d)


def plan_level(work: list, h: Hierarchy, eps: float, preset: str, seed: int,
               total_weight: float, adaptive: bool, backend: str) -> list[PlanGroup]:
    """Group one level's pending subgraphs into power-of-two shape buckets."""
    groups: dict[tuple[int, int, int], list] = {}
    for hg in work:
        key = (_next_pow2(hg.n), _next_pow2(max(hg.m, 1)), h.a[hg.depth - 1])
        groups.setdefault(key, []).append(hg)
    return [PlanGroup(
        members=members, N=N, M=M, arity=arity, levels=num_levels(N, arity),
        preset=preset, backend=backend,
        eps=[_eps_for(m, h, eps, total_weight, adaptive) for m in members],
        salts=[seed * 100003 + m.uid for m in members])
        for (N, M, arity), members in groups.items()]


def dispatch_group_batch(groups: list[PlanGroup]) -> tuple:
    """ONE batched partition call for PlanGroups sharing ``exec_key``;
    returns a handle for :func:`fetch_group_batch`. The kernels run on the
    device's stream, so the call returns while the device works on."""
    key = groups[0].exec_key
    for gr in groups[1:]:
        if gr.exec_key != key:
            raise ValueError(f"mismatched exec keys: {gr.exec_key} != {key}")
    g0 = groups[0]
    if len(groups) == 1:
        batch = g0.batch
    else:
        batch = Graph(*(torch.cat(f) for f in zip(*(gr.batch for gr in groups))))
    dev = batch.vwgt.device
    eps = torch.tensor([e for gr in groups for e in gr.eps], dtype=F32, device=dev)
    salts = [s for gr in groups for s in gr.salts]
    parts = batched_partition(batch, g0.arity, eps, salts, g0.levels, g0.preset,
                              g0.backend)
    return parts, groups


def fetch_group_batch(handle: tuple) -> list:
    """One ``[B_i, N]`` device slice per group; no transfer, the labels feed
    the next level's on-device split."""
    parts, groups = handle
    out, ofs = [], 0
    for gr in groups:
        out.append(parts[ofs: ofs + len(gr.members)])
        ofs += len(gr.members)
    return out


def execute_group_batch(groups: list[PlanGroup]) -> list:
    """Dispatch + fetch in one call. Lanes are independent, so a member's
    partition is the same whatever batch it rides in."""
    return fetch_group_batch(dispatch_group_batch(groups))


class LevelPlanner:
    """Level-stepped multisection state machine for ONE hierarchy.

    Alternates ``plan()`` (PlanGroups for the current level) with
    ``advance(results)`` (feed partition results, split children on the
    device, step to the next level) until ``plan()`` returns ``[]``.
    """

    def __init__(self, g: Graph, h: Hierarchy, eps: float = 0.03,
                 preset: str = "eco", seed: int = 0, adaptive: bool = True,
                 backend: str = "auto",
                 checkpoint: Callable[[], None] | None = None):
        self.h = h
        self.checkpoint = checkpoint
        self.eps = eps
        self.preset = preset
        self.seed = seed
        self.adaptive = adaptive
        self.backend = resolve_backend(backend)
        self.stats = {"partition_calls": 0, "levels": [], "strategy": "bucket",
                      "resident": True, "padded_vertex_work": 0,
                      "real_vertex_work": 0, "backend": self.backend}
        self._t0 = time.time()
        self._level_t0 = 0.0
        self._groups: list[PlanGroup] | None = None
        self._done = False
        self._work: list = []
        self.pe_of: np.ndarray | None = None

        n_root, m_root = int(g.n), int(g.m)
        _acct(d2h_meta_bytes=8, d2h_meta_fetches=1)
        self.n_root = n_root
        N0, M0 = _next_pow2(n_root), _next_pow2(max(m_root, 1))
        batch, orig, tw = _root_op(g, N0, M0)
        self._sent = batch.n[0]           # spare pe slot for pad writes
        self._pe = torch.zeros(n_root + 1, dtype=I32, device=g.device)
        # host shape keys and the f64 imbalance rule need the total weight:
        # one scalar fetch (exact f32 sum for integer weights below 2^24)
        self.total_weight = float(tw)
        _acct(d2h_meta_bytes=4, d2h_meta_fetches=1)
        self._current = [_LaneRef(level=_DeviceLevel(g=batch, orig=orig, depth=h.l),
                                  lane=0, depth=h.l, pe_base=0, uid=0,
                                  n=n_root, m=m_root, wsum=self.total_weight)]

    def plan(self) -> list[PlanGroup]:
        """PlanGroups for the current level; ``[]`` once fully partitioned.
        Idempotent until ``advance`` consumes the results."""
        if self._done:
            return []
        if self._groups is None:
            if self.checkpoint is not None:
                self.checkpoint()   # cooperative cancellation between levels
            self._work = [w for w in self._current if w.depth > 0]
            if not self._work:
                self._finish()
                return []
            self._level_t0 = time.time()
            self._groups = plan_level(self._work, self.h, self.eps, self.preset,
                                      self.seed, self.total_weight, self.adaptive,
                                      self.backend)
            for gr in self._groups:
                gr.batch, gr.batch_orig = self._gather_group(gr)
        return self._groups

    def _gather_group(self, gr: PlanGroup) -> tuple[Graph, torch.Tensor]:
        """Assemble a group's [B,...] batch from the per-container children
        (runs of members sharing a container become one lane-take + repad)."""
        batches, origs = [], []
        i = 0
        members = gr.members
        while i < len(members):
            lv = members[i].level
            j = i
            while j < len(members) and members[j].level is lv:
                j += 1
            sel = torch.tensor([m.lane for m in members[i:j]], dtype=torch.int64,
                               device=lv.orig.device)
            sub, o = _gather_op(lv.g, lv.orig, sel, gr.N, gr.M, self._sent)
            batches.append(sub)
            origs.append(o)
            i = j
        if len(batches) == 1:
            return batches[0], origs[0]
        return (Graph(*(torch.cat(f) for f in zip(*batches))), torch.cat(origs))

    def advance(self, results: list) -> None:
        """Feed one ``[B_i, N]`` partition tensor per group from ``plan()``."""
        groups = self.plan()
        if len(results) != len(groups):
            raise ValueError(f"expected {len(groups)} results, got {len(results)}")
        nxt: list[_LaneRef] = []
        for gr, parts in zip(groups, results):
            B = len(gr.members)
            d = gr.members[0].depth
            arity = gr.arity
            self.stats["partition_calls"] += B
            self.stats["padded_vertex_work"] += B * gr.N
            self.stats["real_vertex_work"] += sum(r.n for r in gr.members)
            if d == 1:
                bases = torch.tensor([r.pe_base for r in gr.members], dtype=I32,
                                     device=parts.device)
                self._pe = _scatter_op(self._pe, gr.batch_orig, parts, bases, gr.N)
                continue
            stride = int(np.prod(self.h.a[: d - 1]))
            ch, co, ws = _split_op(gr.batch, parts, gr.batch_orig, arity, self._sent)
            lvl = _DeviceLevel(g=ch, orig=co, depth=d - 1)
            # bucket shapes are data-dependent: fetch the child metadata
            # (sizes + weights), NOT the arrays.
            ns = ch.n.cpu().numpy()
            ms = ch.m.cpu().numpy()
            wv = ws.cpu().numpy()
            _acct(d2h_meta_bytes=ns.nbytes + ms.nbytes + wv.nbytes, d2h_meta_fetches=3)
            for i, r in enumerate(gr.members):
                for b in range(arity):
                    j = i * arity + b
                    nxt.append(_LaneRef(level=lvl, lane=j, depth=d - 1,
                                        pe_base=r.pe_base + b * stride,
                                        uid=r.uid * arity + b + 1,
                                        n=int(ns[j]), m=int(ms[j]), wsum=float(wv[j])))
        self._current = nxt
        self.stats["levels"].append(
            {"graphs": len(self._work), "seconds": time.time() - self._level_t0})
        self._groups = None

    def _finish(self) -> None:
        if not self._done:
            self._done = True
            self.stats["seconds"] = time.time() - self._t0

    def result(self) -> "MultisectionResult":
        if not self._done:
            raise RuntimeError("planner has pending levels")
        if self.pe_of is None:
            # THE device->host sync point: one fetch per request.
            pe = self._pe[: self.n_root].cpu().numpy()
            _acct(d2h_bytes=pe.nbytes, d2h_array_fetches=1)
            self.pe_of = pe
        return MultisectionResult(pe_of=self.pe_of, stats=self.stats)


@dataclasses.dataclass
class MultisectionResult:
    pe_of: np.ndarray    # [n] i32 PE assignment (the mapping Pi)
    stats: dict          # timing / scheduling telemetry


_NOT_PORTED = ("is not ported yet: this slice of repro_torch runs the bucket "
               "strategy with resident=True (ROADMAP.md, Queue 1, item 6)")


def hierarchical_multisection(g: Graph, h: Hierarchy, eps: float = 0.03,
                              preset: str = "eco", strategy: str = "bucket",
                              seed: int = 0, adaptive: bool = True,
                              backend: str = "auto",
                              checkpoint: Callable[[], None] | None = None,
                              resident: bool | None = None,
                              device=None) -> MultisectionResult:
    """Partition ``g`` along ``h`` and return the (identity) mapping.

    ``g`` is moved to ``device`` (``None`` = the card). ``checkpoint`` is
    an optional hook called between levels; raising inside it aborts.
    """
    if strategy in ("layer", "device", "naive", "queue"):
        raise NotImplementedError(f"strategy {strategy!r} {_NOT_PORTED}")
    if strategy != "bucket":
        raise ValueError(f"unknown strategy {strategy!r}")
    if resident is False:
        raise NotImplementedError(f"resident=False {_NOT_PORTED}")
    g = g.to(resolve_device(device))
    planner = LevelPlanner(g, h, eps=eps, preset=preset, seed=seed,
                           adaptive=adaptive, backend=backend, checkpoint=checkpoint)
    while True:
        groups = planner.plan()
        if not groups:
            break
        planner.advance([execute_group_batch([gr])[0] for gr in groups])
    return planner.result()

