"""Hierarchical multisection (the paper's §4) with its scheduling strategies.

The communication graph is partitioned along the hierarchy
``H = a_1 : ... : a_l`` (top-down: first a_l, then a_{l-1}, ...), with the
adaptive imbalance of Lemma 5.1 applied at every sub-partition, so the
final k-way partition is eps-balanced and the identity mapping solves the
mapping phase.

Scheduling strategies (§4.2-4.5), as in the reference:

* ``naive``:  partition one subgraph at a time.
* ``layer``:  all subgraphs of a level padded to one shape, one batched
              partition call per arity (Algorithm 1).
* ``bucket``: the subgraphs of a level grouped into power-of-two shape
              buckets, one batched call per bucket (the default).
* ``queue``:  worker threads pop the largest pending subgraph from a
              condition-variable-guarded heap (Algorithm 2); kernels run on
              the device's stream, so one worker's host-side extraction
              overlaps another's device work.
* ``device``: every level keeps all lanes at the ROOT's padded shape;
              extraction, the adaptive imbalance and the PE labels stay on
              the device, and a request fetches exactly one array (the
              final ``pe_of``).

``layer``, ``bucket`` and ``device`` run on the :class:`LevelPlanner`.
``resident=True`` (their default) keeps every level's subgraphs on the
device; ``resident=False`` is the host-mirror loop (:class:`_HostGraph`
children extracted on the host and uploaded per dispatch), bit-identical
in its results and kept as the regression reference. ``naive`` and
``queue`` always run on the host mirror.

Planner and executor are split as in the reference: :func:`plan_level`
turns a level into :class:`PlanGroup`s (pure bookkeeping),
:func:`dispatch_group_batch`/:func:`fetch_group_batch` run one batched
partition call for groups sharing an ``exec_key``, so the mapping service
(``serve/mapper.py``) merges the groups of several requests into one
dispatch. The reference's ``stats["compile_cache"]`` has no meaning without
``jit`` and is left out.

Transfer accounting: module-level counters (:func:`transfer_stats`,
:func:`reset_transfer_stats`) record every host<->device movement the
multisection makes: bulk uploads, array fetches (``d2h_array_fetches``)
and per-level metadata fetches (``d2h_meta_fetches``).

Spans (``core/spans.py``, recorded only while on): ``planner.plan`` (with
``planner.gather``), ``planner.advance`` (with ``planner.split``),
``planner.sync`` around each device->host fetch of the planner, and
``planner.result_fetch``; one ``planner.level`` per level, from its plan to
its advance, with the card's time between the two (``device_ns``).

Salts derive from a subgraph's position in the hierarchy, not from the
traversal order, so every strategy reproduces the reference's same
strategy; ``queue`` equals ``naive`` and ``bucket`` equals ``naive`` bit
for bit, and ``device`` equals its own host twin.
"""
from __future__ import annotations

import contextvars
import dataclasses
import heapq
import os
import threading
import time
from typing import Callable

import numpy as np
import torch

from . import spans
from .graph import (F32, I32, Graph, assemble_padded, default_ell_deg, exact_sums,
                    padded_csr_indptr, repad_device, resolve_device, split_blocks,
                    take_lanes)
from .hierarchy import Hierarchy, adaptive_epsilon, adaptive_epsilon_tensor
from .coarsen import coarsen_cascade
from .partition import batched_partition, lanes_per_chunk, num_levels, partition
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
# host-side subgraph extraction (resident=False, naive and queue)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _HostGraph:
    """Numpy mirror of a (sub)graph plus its place in the recursion."""

    vwgt: np.ndarray      # [n] f32
    rows: np.ndarray      # [m] i32 directed
    cols: np.ndarray      # [m] i32
    ewgt: np.ndarray      # [m] f32
    orig_ids: np.ndarray  # [n] i32 vertex ids in the ORIGINAL graph
    depth: int            # hierarchy depth (l at the root, 0 at leaves)
    pe_base: int          # PE id offset accumulated along the recursion
    uid: int              # stable id along the hierarchy path (for salts)

    @property
    def n(self) -> int:
        return self.vwgt.shape[0]

    @property
    def m(self) -> int:
        return self.rows.shape[0]

    @property
    def wsum(self) -> float:
        return float(self.vwgt.sum())

    def to_device(self, N: int, M: int, device) -> Graph:
        """Padded Graph on ``device`` via ``assemble_padded``."""
        return assemble_padded(self.vwgt, self.rows, self.cols, self.ewgt,
                               self.n, N, M, device=device)


def _stack_to_device(members: list[_HostGraph], N: int, M: int, device) -> Graph:
    """Stacked [B, ...] Graph of host members: one upload per field."""
    B = len(members)
    vwgt = np.zeros((B, N), np.float32)
    rows = np.full((B, M), N - 1, np.int32)
    cols = np.full((B, M), N - 1, np.int32)
    ewgt = np.zeros((B, M), np.float32)
    indptr = np.zeros((B, N + 1), np.int32)
    ns = np.zeros((B,), np.int32)
    ms = np.zeros((B,), np.int32)
    for i, hg in enumerate(members):
        m = hg.m
        vwgt[i, : hg.n] = hg.vwgt
        rows[i, :m] = hg.rows
        cols[i, :m] = hg.cols
        ewgt[i, :m] = hg.ewgt
        indptr[i] = padded_csr_indptr(rows[i], m, N)
        ns[i] = hg.n
        ms[i] = m
    arrays = (vwgt, rows, cols, ewgt, indptr, ns, ms)
    _acct(h2d_bytes=sum(a.nbytes for a in arrays), h2d_transfers=len(arrays))
    return Graph(*(torch.from_numpy(a).to(device) for a in arrays))


def host_graph_from(g: Graph) -> _HostGraph:
    n, m = int(g.n), int(g.m)
    _acct(d2h_bytes=4 * (g.N + 3 * g.M), d2h_array_fetches=1,
          d2h_meta_bytes=8, d2h_meta_fetches=1)
    return _HostGraph(vwgt=g.vwgt[:n].cpu().numpy(),
                      rows=g.rows[:m].cpu().numpy().astype(np.int32, copy=False),
                      cols=g.cols[:m].cpu().numpy().astype(np.int32, copy=False),
                      ewgt=g.ewgt[:m].cpu().numpy(),
                      orig_ids=np.arange(n, dtype=np.int32),
                      depth=0, pe_base=0, uid=0)


def _split(hg: _HostGraph, part: np.ndarray, k: int, child_depth: int,
           stride: int, arity: int) -> list[_HostGraph]:
    """The k induced block subgraphs of ``hg`` under ``part`` (host
    counterpart of ``graph.split_blocks``, bitwise interchangeable)."""
    part = part[: hg.n]
    relabel = np.zeros(hg.n, np.int32)
    children = []
    for b in range(k):
        sel = np.nonzero(part == b)[0]
        relabel[sel] = np.arange(sel.shape[0])
        emask = (part[hg.rows] == b) & (part[hg.cols] == b)
        children.append(_HostGraph(
            vwgt=hg.vwgt[sel], rows=relabel[hg.rows[emask]],
            cols=relabel[hg.cols[emask]], ewgt=hg.ewgt[emask],
            orig_ids=hg.orig_ids[sel], depth=child_depth,
            pe_base=hg.pe_base + b * stride, uid=hg.uid * arity + b + 1))
    return children


def _children_of(hg: _HostGraph, part: np.ndarray, h: Hierarchy) -> list[_HostGraph]:
    d = hg.depth
    arity = h.a[d - 1]
    child_stride = int(np.prod(h.a[: d - 1])) if d > 1 else 1
    return _split(hg, part, arity, d - 1, child_stride, arity)


def _ell_deg_for(members, backend: str) -> int | None:
    """ELL degree cap for a dispatch, from the REAL mean directed degree
    pooled over its members, ``ceil(sum m / sum n)`` (padded shapes skew
    it by up to 2x); None under ``"xla"``, which needs none."""
    if backend != "ell":
        return None
    tot_m = sum(m.m for m in members)
    tot_n = max(sum(m.n for m in members), 1)
    mean = (tot_m + tot_n - 1) // tot_n
    return default_ell_deg(1, mean)   # N=1, M=mean -> cap from the real mean


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
    (shape keys, eps inputs, salt derivation) without touching the arrays.
    ``n``/``m``/``wsum`` stay unset on the ``device`` strategy, whose
    planning needs no device data."""

    level: _DeviceLevel
    lane: int
    depth: int
    pe_base: int
    uid: int
    n: int = -1
    m: int = -1
    wsum: float = 0.0


def _device_mark(device) -> torch.cuda.Event | None:
    """A timing event recorded now on the card's current stream (None off
    the card)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _root_op(g: Graph, N0: int, M0: int):
    """g -> ([1,...] repadded batch, [1, N0] orig ids, f32 total weight)."""
    g2 = repad_device(g, N0, M0)
    ar = torch.arange(N0, dtype=I32, device=g.device)
    orig = torch.where(ar < g2.n, ar, g2.n)   # sentinel = n (spare pe slot)
    batch = Graph(*(a[None] for a in g2))
    return batch, orig[None], g2.total_weight()


def split_lane_bytes(N: int, M: int, arity: int) -> int:
    """Device bytes :func:`graph.split_blocks` reckons with for one lane at
    (N, M): its ``arity`` children (six arrays of N or M words) and the
    gathers' [arity, N] / [arity, M] indices and masks."""
    return 36 * arity * (N + M)


def _split_op(gb: Graph, parts: torch.Tensor, ob: torch.Tensor, arity: int,
              sent: torch.Tensor):
    """[B]-lane batch -> [B*arity]-lane children (+ orig ids + weights):
    one batched :func:`graph.split_blocks` for all lanes, in consecutive
    chunks that fit ``partition.LANE_CHUNK_BYTES`` (each lane splits as it
    would alone, so the chunking changes nothing)."""
    B = ob.shape[0]
    per = lanes_per_chunk(split_lane_bytes(gb.N, gb.M, arity))
    if per >= B:
        return split_blocks(gb, parts, ob, arity, sent)
    out = [split_blocks(Graph(*(a[i:i + per] for a in gb)), parts[i:i + per],
                        ob[i:i + per], arity, sent) for i in range(0, B, per)]
    ch = Graph(*(torch.cat(f) for f in zip(*(c for c, _, _ in out))))
    return ch, torch.cat([o for _, o, _ in out]), torch.cat([w for _, _, w in out])


def _gather_op(gb: Graph, ob: torch.Tensor, sel: torch.Tensor, Nd: int, Md: int,
               sent: torch.Tensor):
    """Select lanes of a [B,...] container and repad them to (Nd, Md): how
    resident bucket and layer groups assemble their dispatch batches."""
    sub = repad_device(take_lanes(gb, sel), Nd, Md)
    o = ob.index_select(0, sel)
    Ns = o.shape[1]
    if Nd <= Ns:
        o = o[:, :Nd].contiguous()
    else:
        pad = sent.to(I32).expand(o.shape[0], Nd - Ns)
        o = torch.cat([o, pad], dim=1)
    return sub, o


def _eps_op(wsums: torch.Tensor, total: torch.Tensor, k: int, k_sub: int,
            depth: int, eps: float, adaptive: bool) -> torch.Tensor:
    """[B] f32 subgraph weights -> [B] f32 adaptive eps (Lemma 5.1), on
    their device. ONE function serves the ``device`` path (fed the split's
    weights) and its host twin (fed numpy f32 sums on the same device), so
    their eps bits match."""
    if not adaptive or depth <= 0:
        return torch.full(wsums.shape, eps, dtype=F32, device=wsums.device)
    return adaptive_epsilon_tensor(eps, total, wsums, k, k_sub, depth)


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
    """One dispatch planned from a single hierarchy's current level:
    members, padded shapes, arity, preset/backend/ELL cap, per-member eps
    and salts (position-derived, so independent of the batch a member rides
    in). Resident groups carry their stacked device ``batch`` and its
    [B, N] original-id view; on the ``device`` strategy their eps stays on
    the device (``eps_dev``). Host groups upload their members at dispatch
    time."""

    members: list
    N: int                # padded vertex shape of the dispatch
    M: int                # padded edge shape
    arity: int            # k of each member's sub-partition
    levels: int           # coarsening depth for (N, arity)
    preset: str
    backend: str
    deg: int | None       # ELL degree cap (None under "xla")
    eps: list[float]
    salts: list[int]
    resident: bool = False
    batch: Graph | None = None
    batch_orig: torch.Tensor | None = None
    eps_dev: torch.Tensor | None = None

    @property
    def exec_key(self) -> tuple:
        """Groups with equal keys may be stacked into ONE dispatch: groups
        with different ELL caps never share one."""
        return (self.N, self.M, self.arity, self.levels, self.preset,
                self.backend, self.deg)

    def eps_array(self, device) -> torch.Tensor:
        if self.eps_dev is not None:
            return self.eps_dev
        return torch.tensor(self.eps, dtype=F32, device=device)

    def graph_batch(self, device) -> Graph:
        if self.resident:
            return self.batch
        return _stack_to_device(self.members, self.N, self.M, device)


def _eps_for(hg, h: Hierarchy, eps: float, total_weight: float,
             adaptive: bool) -> float:
    if not adaptive:
        return eps
    d = hg.depth
    k_sub = int(np.prod(h.a[:d])) if d > 0 else 1
    return adaptive_epsilon(eps, total_weight, hg.wsum, h.k, k_sub, d)


def plan_level(work: list, h: Hierarchy, eps: float, preset: str, seed: int,
               total_weight: float, adaptive: bool, backend: str,
               bucketed: bool = True) -> list[PlanGroup]:
    """Group one level's pending subgraphs into dispatch units:
    power-of-two shape buckets (``bucket``), or one group per arity padded
    to the level's largest member (``layer``). Members may be
    :class:`_HostGraph`s or :class:`_LaneRef`s; planning reads only their
    ``n/m/depth/uid/wsum``."""
    groups: dict[tuple[int, int, int], list] = {}
    for hg in work:
        if bucketed:
            key = (_next_pow2(hg.n), _next_pow2(max(hg.m, 1)))
        else:
            key = (0, 0)   # one group per arity, padded to the level max below
        groups.setdefault(key + (h.a[hg.depth - 1],), []).append(hg)
    out = []
    for (kn, km, arity), members in groups.items():
        N = kn or _next_pow2(max(m.n for m in members))
        M = km or _next_pow2(max(max(m.m, 1) for m in members))
        out.append(PlanGroup(
            members=members, N=N, M=M, arity=arity, levels=num_levels(N, arity),
            preset=preset, backend=backend, deg=_ell_deg_for(members, backend),
            eps=[_eps_for(m, h, eps, total_weight, adaptive) for m in members],
            salts=[seed * 100003 + m.uid for m in members]))
    return out


def dispatch_group_batch(groups: list[PlanGroup], device,
                         pad_batch_pow2: bool = False) -> tuple:
    """ONE batched partition call for PlanGroups sharing ``exec_key``;
    returns a handle for :func:`fetch_group_batch`. Host groups upload
    their members, resident groups contribute their device batches. The
    kernels run on the device's stream, so the call returns while the
    device works on.

    The merged lanes of every group go into ONE :func:`batched_partition`
    call, which runs them as one batched v-cycle (in chunks of
    ``partition.LANE_CHUNK_BYTES``), as the reference's ``vmap`` does.

    ``pad_batch_pow2`` is the reference's keyword, and here it changes
    nothing. The reference replicates the last lane up to a power of two so
    that XLA compiles O(log B) batch widths; the port compiles nothing, so
    a replicated lane would cost device work for an output that is dropped.
    Lanes are independent, so the results are the same either way; the
    mapping service still counts the lanes the reference would pad
    (``stats()["coalesce"]["padded_lanes"]``)."""
    key = groups[0].exec_key
    for gr in groups[1:]:
        if gr.exec_key != key:
            raise ValueError(f"mismatched exec keys: {gr.exec_key} != {key}")
    g0 = groups[0]
    batches = [gr.graph_batch(device) for gr in groups]
    eps_parts = [gr.eps_array(device) for gr in groups]
    if len(groups) == 1:
        batch, eps = batches[0], eps_parts[0]
    else:
        batch = Graph(*(torch.cat(f) for f in zip(*batches)))
        eps = torch.cat(eps_parts)
    salts = [s for gr in groups for s in gr.salts]
    parts = batched_partition(batch, g0.arity, eps, salts, g0.levels, g0.preset,
                              g0.backend, g0.deg)
    return parts, groups


def fetch_group_batch(handle: tuple) -> list:
    """One ``[B_i, N]`` result per group: a device slice for resident
    groups (no transfer, the labels feed the next level's on-device
    split), a numpy array for host groups (one fetch for the batch)."""
    parts, groups = handle
    parts_np = None
    out, ofs = [], 0
    for gr in groups:
        B = len(gr.members)
        if gr.resident:
            out.append(parts[ofs: ofs + B])
        else:
            if parts_np is None:
                parts_np = parts.cpu().numpy()
                _acct(d2h_bytes=parts_np.nbytes, d2h_array_fetches=1)
            out.append(parts_np[ofs: ofs + B])
        ofs += B
    return out


def execute_group_batch(groups: list[PlanGroup], device,
                        pad_batch_pow2: bool = False) -> list:
    """Dispatch + fetch in one call. Lanes are independent, so a member's
    partition is the same whatever batch it rides in."""
    return fetch_group_batch(dispatch_group_batch(groups, device, pad_batch_pow2))


_PLANNER_STRATEGIES = ("layer", "bucket", "device")


class LevelPlanner:
    """Level-stepped multisection state machine for ONE hierarchy.

    Alternates ``plan()`` (PlanGroups for the current level) with
    ``advance(results)`` (feed partition results, split children, step to
    the next level) until ``plan()`` returns ``[]``. ``resident=True``
    (the default) splits on the device: bucket and layer fetch only the
    children's sizes and weights per level, ``device`` fetches nothing.
    ``resident=False`` is the host-mirror loop, bit-identical in its
    results.
    """

    def __init__(self, g: Graph, h: Hierarchy, eps: float = 0.03,
                 preset: str = "eco", seed: int = 0, adaptive: bool = True,
                 backend: str = "auto", checkpoint: Callable[[], None] | None = None,
                 strategy: str = "bucket", resident: bool | None = None,
                 req: int | None = None):
        if strategy not in _PLANNER_STRATEGIES:
            raise ValueError(f"unknown planner strategy {strategy!r}")
        self.h = h
        self.checkpoint = checkpoint
        self.eps = eps
        self.preset = preset
        self.seed = seed
        self.adaptive = adaptive
        self.device = g.device
        self.backend = resolve_backend(backend, self.device)
        self.strategy = strategy
        self.bucketed = strategy == "bucket"
        self.resident = True if resident is None else bool(resident)
        self.req = req   # the request id the planner's spans carry
        self.stats = {"partition_calls": 0, "levels": [], "strategy": strategy,
                      "resident": self.resident, "padded_vertex_work": 0,
                      "real_vertex_work": 0, "backend": self.backend}
        self._t0 = time.perf_counter_ns()
        self._level_t0 = 0
        self._level_ev = None
        self._traced_levels: list[tuple] = []   # (level, t0, t1, device events)
        self._groups: list[PlanGroup] | None = None
        self._done = False
        self._work: list = []
        self.pe_of: np.ndarray | None = None
        if self.resident:
            self._init_resident(g)
        else:
            self._init_host(g)

    # -- construction --------------------------------------------------------

    def _init_host(self, g: Graph) -> None:
        root = host_graph_from(g)
        root.depth = self.h.l
        self.n_root = root.n
        self.N0 = _next_pow2(root.n)
        self.M0 = _next_pow2(max(root.m, 1))
        self.total_weight = root.wsum
        self._tw_f32 = torch.tensor(np.float32(root.vwgt.sum()), device=self.device)
        self._root_deg = _ell_deg_for([root], self.backend)
        self.pe_of = np.zeros(root.n, np.int32)
        self._current: list = [root]

    def _init_resident(self, g: Graph) -> None:
        with spans.span("planner.sync", req=self.req):
            n_root, m_root = int(g.n), int(g.m)
        _acct(d2h_meta_bytes=8, d2h_meta_fetches=1)
        self.n_root = n_root
        self.N0 = _next_pow2(n_root)
        self.M0 = _next_pow2(max(m_root, 1))
        batch, orig, tw = _root_op(g, self.N0, self.M0)
        root_level = _DeviceLevel(g=batch, orig=orig, depth=self.h.l)
        self._sent = batch.n[0]           # spare pe slot for pad writes
        self._pe = torch.zeros(n_root + 1, dtype=I32, device=g.device)
        self._tw_dev = tw
        self._root_deg = None
        if self.backend == "ell":
            mean = (m_root + max(n_root, 1) - 1) // max(n_root, 1)
            self._root_deg = default_ell_deg(1, mean)
        if self.strategy == "device":
            self.total_weight = None      # never fetched
            d = self.h.l
            self._eps_dev = _eps_op(tw[None], tw, self.h.k, self.h.k, d,
                                    self.eps, self.adaptive)
        else:
            # host shape keys and the f64 imbalance rule need the total
            # weight: one scalar fetch (exact f32 sum for integer weights
            # below 2^24)
            with spans.span("planner.sync", req=self.req):
                self.total_weight = float(tw)
            _acct(d2h_meta_bytes=4, d2h_meta_fetches=1)
        self._current = [_LaneRef(level=root_level, lane=0, depth=self.h.l,
                                  pe_base=0, uid=0, n=n_root, m=m_root,
                                  wsum=self.total_weight or 0.0)]

    # -- the plan/advance cycle ------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done

    def plan(self) -> list[PlanGroup]:
        """PlanGroups for the current level; ``[]`` once fully partitioned.
        Idempotent until ``advance`` consumes the results."""
        if self._done:
            return []
        if self._groups is None:
            if self.checkpoint is not None:
                self.checkpoint()   # cooperative cancellation between levels
            with spans.span("planner.plan", req=self.req):
                self._plan_level()
        return self._groups or []

    def _plan_level(self) -> None:
        if not self.resident:
            for hg in self._current:
                if hg.depth == 0:
                    self.pe_of[hg.orig_ids] = hg.pe_base
        self._work = [w for w in self._current if w.depth > 0]
        if not self._work:
            self._finish()
            return
        self._level_t0 = time.perf_counter_ns()
        self._level_ev = _device_mark(self.device) if spans.enabled() else None
        if self.strategy == "device":
            self._groups = self._plan_root_shape()
        else:
            self._groups = plan_level(
                self._work, self.h, self.eps, self.preset, self.seed,
                self.total_weight, self.adaptive, self.backend, self.bucketed)
            if self.resident:
                for gr in self._groups:
                    gr.resident = True
                    with spans.span("planner.gather", req=self.req):
                        gr.batch, gr.batch_orig = self._gather_group(gr)

    def _plan_root_shape(self) -> list[PlanGroup]:
        """The ``device`` strategy's fixed-shape schedule: every level is
        ONE group at the root's (N0, M0) padding; lane count, uids and salts
        are known on the host, so planning needs no device data."""
        work = self._work
        d = work[0].depth
        arity = self.h.a[d - 1]
        gr = PlanGroup(
            members=list(work), N=self.N0, M=self.M0, arity=arity,
            levels=num_levels(self.N0, arity), preset=self.preset,
            backend=self.backend, deg=self._root_deg,
            eps=[], salts=[self.seed * 100003 + w.uid for w in work])
        if self.resident:
            lvl = work[0].level
            gr.resident = True
            gr.batch = lvl.g
            gr.batch_orig = lvl.orig
            gr.eps_dev = self._eps_dev
        else:
            # host twin: the device path's eps function, fed f32 sums on the
            # same device, gives the same eps bits
            wsums = torch.tensor(np.asarray([w.wsum for w in work], np.float32),
                                 device=self.device)
            k_sub = int(np.prod(self.h.a[:d]))
            gr.eps = _eps_op(wsums, self._tw_f32, self.h.k, k_sub, d, self.eps,
                             self.adaptive).tolist()
        return [gr]

    def _gather_group(self, gr: PlanGroup) -> tuple[Graph, torch.Tensor]:
        """Assemble a resident group's [B,...] batch from the per-container
        children (runs of members sharing a container become one lane-take
        + repad)."""
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
        """Feed one ``[B_i, N]`` partition result per group from ``plan()``."""
        groups = self.plan()
        if len(results) != len(groups):
            raise ValueError(f"expected {len(groups)} results, got {len(results)}")
        with spans.span("planner.advance", req=self.req):
            if self.resident:
                self._advance_resident(groups, results)
            else:
                nxt: list[_HostGraph] = []
                for gr, parts in zip(groups, results):
                    parts = np.asarray(parts)
                    for i, hg in enumerate(gr.members):
                        self._record(gr.N, hg.n)
                        nxt.extend(_children_of(hg, parts[i][: hg.n], self.h))
                self._current = nxt
        t1 = time.perf_counter_ns()
        self.stats["levels"].append(
            {"graphs": len(self._work), "seconds": (t1 - self._level_t0) / 1e9})
        if spans.enabled():
            self._traced_levels.append((len(self.stats["levels"]) - 1, self._level_t0, t1,
                                        self._level_ev, _device_mark(self.device)))
        self._groups = None

    def _advance_resident(self, groups: list[PlanGroup], results: list) -> None:
        nxt: list[_LaneRef] = []
        for gr, parts in zip(groups, results):
            B = len(gr.members)
            d = gr.members[0].depth
            arity = gr.arity
            self.stats["partition_calls"] += B
            self.stats["padded_vertex_work"] += B * gr.N
            if self.strategy == "device":
                # each level's lanes partition a disjoint cover of the root
                self.stats["real_vertex_work"] += self.n_root
            else:
                self.stats["real_vertex_work"] += sum(r.n for r in gr.members)
            if d == 1:
                bases = torch.tensor([r.pe_base for r in gr.members], dtype=I32,
                                     device=parts.device)
                self._pe = _scatter_op(self._pe, gr.batch_orig, parts, bases, gr.N)
                continue
            stride = int(np.prod(self.h.a[: d - 1]))
            with spans.span("planner.split", req=self.req):
                ch, co, ws = _split_op(gr.batch, parts, gr.batch_orig, arity, self._sent)
            lvl = _DeviceLevel(g=ch, orig=co, depth=d - 1)
            if self.strategy == "device":
                nxt.extend(
                    _LaneRef(level=lvl, lane=i * arity + b, depth=d - 1,
                             pe_base=r.pe_base + b * stride,
                             uid=r.uid * arity + b + 1)
                    for i, r in enumerate(gr.members) for b in range(arity))
                k_sub = int(np.prod(self.h.a[: d - 1]))
                self._eps_dev = _eps_op(ws, self._tw_dev, self.h.k, k_sub, d - 1,
                                        self.eps, self.adaptive)
                continue
            # bucket/layer shapes are data-dependent: fetch the child
            # metadata (sizes + weights), NOT the arrays.
            with spans.span("planner.sync", req=self.req):
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

    def _record(self, batchN: int, realn: int) -> None:
        self.stats["partition_calls"] += 1
        self.stats["padded_vertex_work"] += int(batchN)
        self.stats["real_vertex_work"] += int(realn)

    def _finish(self) -> None:
        if not self._done:
            self._done = True
            self.stats["seconds"] = (time.perf_counter_ns() - self._t0) / 1e9

    def result(self) -> "MultisectionResult":
        if not self._done:
            raise RuntimeError("planner has pending levels")
        with spans.span("planner.result_fetch", req=self.req):
            if self.resident and self.pe_of is None:
                # THE device->host sync point: one fetch per request.
                with spans.span("planner.sync", req=self.req):
                    pe = self._pe[: self.n_root].cpu().numpy()
                _acct(d2h_bytes=pe.nbytes, d2h_array_fetches=1)
                self.pe_of = pe
        self._record_levels()
        return MultisectionResult(pe_of=self.pe_of, stats=self.stats)

    def _record_levels(self) -> None:
        """One ``planner.level`` span per level traced, with the device time
        between its two events where it ran on the card (read after the
        request's fetch, so no further sync waits on them)."""
        for i, t0, t1, e0, e1 in self._traced_levels:
            attrs = {}
            if e0 is not None and e1 is not None:
                e1.synchronize()
                attrs["device_ns"] = int(e0.elapsed_time(e1) * 1e6)
            spans.record("planner.level", t0, t1, req=self.req, level=i, **attrs)
        self._traced_levels = []


# ---------------------------------------------------------------------------
# the multisection entry point
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MultisectionResult:
    pe_of: np.ndarray    # [n] i32 PE assignment (the mapping Pi)
    stats: dict          # timing / scheduling telemetry


def _partition_one(hg: _HostGraph, k: int, eps_val: float, preset: str, salt: int,
                   backend: str, device) -> np.ndarray:
    """One subgraph's partition call at its own power-of-two padding (the
    ``naive`` and ``queue`` dispatch unit)."""
    N = _next_pow2(hg.n)
    M = _next_pow2(max(hg.m, 1))
    g = hg.to_device(N, M, device)
    _acct(h2d_bytes=4 * (N + 3 * M + N + 1 + 2), h2d_transfers=7)
    part = partition(g, k, eps_val, num_levels(N, k), preset, salt, backend,
                     _ell_deg_for([hg], backend), device=device).cpu().numpy()
    _acct(d2h_bytes=part.nbytes, d2h_array_fetches=1)
    return part[: hg.n]


def _coarsen_telemetry_stats(g: Graph, h: Hierarchy) -> dict:
    """``stats["coarsen"]``: per-level shrink of the ROOT graph's coarsening
    cascade (the depth and cap of the first sub-partition), measured with
    :func:`coarsen.coarsen_cascade`: memory that does not grow with the
    level count, and one fetch of the ``2 * levels`` sizes."""
    n, m = int(g.n), int(g.m)
    arity = h.a[h.l - 1] if h.l > 0 else h.k
    lv = num_levels(n, arity)
    deg = default_ell_deg(n, max(m, 1))
    ns, ms = coarsen_cascade(g, lv, ell_deg=deg, device=g.device)
    _acct(d2h_meta_bytes=ns.nbytes + ms.nbytes, d2h_meta_fetches=1)
    per = []
    prev = n
    for i in range(lv):
        ni = int(ns[i])
        per.append({"n": ni, "m": int(ms[i]), "shrink": round(prev / max(ni, 1), 4)})
        prev = ni
    return {"levels": lv, "ell_deg": deg, "rounds": 3, "per_level": per}


def hierarchical_multisection(g: Graph, h: Hierarchy, eps: float = 0.03,
                              preset: str = "eco", strategy: str = "bucket",
                              seed: int = 0, adaptive: bool = True,
                              backend: str = "auto",
                              checkpoint: Callable[[], None] | None = None,
                              resident: bool | None = None,
                              coarsen_telemetry: bool = False,
                              device=None) -> MultisectionResult:
    """Partition ``g`` along ``h`` and return the (identity) mapping.

    ``g`` is moved to ``device`` (``None`` = the card). ``checkpoint`` is
    an optional hook called between levels (and before each naive/queue
    task); raising inside it aborts. ``resident`` applies to the planner
    strategies (layer/bucket/device): ``None``/``True`` keeps the level
    loop on the device, ``False`` runs the host-mirror loop (the same
    results bit for bit). ``coarsen_telemetry`` also runs the root graph's
    coarsening cascade for its per-level sizes (``stats["coarsen"]``; one
    more pass on the device, never a change to the mapping).
    """
    dev = resolve_device(device)
    g = g.to(dev)
    backend = resolve_backend(backend, dev)
    with exact_sums(g):   # the root's weights cover every partition call below
        coarsen_stats = _coarsen_telemetry_stats(g, h) if coarsen_telemetry else None
        if strategy in _PLANNER_STRATEGIES:
            planner = LevelPlanner(g, h, eps=eps, preset=preset, seed=seed,
                                   adaptive=adaptive, backend=backend,
                                   strategy=strategy, resident=resident,
                                   checkpoint=checkpoint)
            while True:
                groups = planner.plan()
                if not groups:
                    break
                planner.advance([execute_group_batch([gr], dev)[0] for gr in groups])
            res = planner.result()
            if coarsen_stats is not None:
                res.stats["coarsen"] = coarsen_stats
            return res
        if strategy not in ("naive", "queue"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if resident is not None:
            raise ValueError(f"resident= applies only to the planner strategies "
                             f"{_PLANNER_STRATEGIES}; strategy {strategy!r} has "
                             f"no device-resident variant")

        root = host_graph_from(g)
        root.depth = h.l
        pe_of = np.zeros(root.n, np.int32)
        stats = {"partition_calls": 0, "levels": [], "strategy": strategy,
                 "padded_vertex_work": 0, "real_vertex_work": 0, "backend": backend}
        if coarsen_stats is not None:
            stats["coarsen"] = coarsen_stats
        rec_lock = threading.Lock()

        def record(batchN, realn):
            with rec_lock:
                stats["partition_calls"] += 1
                stats["padded_vertex_work"] += int(batchN)
                stats["real_vertex_work"] += int(realn)

        ctx = (h, eps, preset, seed, root.wsum, adaptive, backend, record, checkpoint, dev)
        current = [root]
        t0 = time.perf_counter_ns()
        while current:
            if checkpoint is not None:
                checkpoint()
            for hg in current:
                if hg.depth == 0:
                    pe_of[hg.orig_ids] = hg.pe_base
            work = [hg for hg in current if hg.depth > 0]
            if not work:
                break
            lvl_t0 = time.perf_counter_ns()
            current = _run_naive(work, ctx) if strategy == "naive" else _run_queue(work, ctx)
            stats["levels"].append({"graphs": len(work),
                                    "seconds": (time.perf_counter_ns() - lvl_t0) / 1e9})
        stats["seconds"] = (time.perf_counter_ns() - t0) / 1e9
        return MultisectionResult(pe_of=pe_of, stats=stats)


def _partition_task(hg: _HostGraph, ctx) -> list[_HostGraph]:
    """Partition one pending subgraph and return its children."""
    h, eps, preset, seed, total_weight, adaptive, backend, record, _, dev = ctx
    e = _eps_for(hg, h, eps, total_weight, adaptive)
    part = _partition_one(hg, h.a[hg.depth - 1], e, preset, seed * 100003 + hg.uid,
                          backend, dev)
    record(_next_pow2(hg.n), hg.n)
    return _children_of(hg, part, h)


def _run_naive(work, ctx):
    checkpoint = ctx[8]
    out = []
    for hg in work:
        if checkpoint is not None:
            checkpoint()
        out.extend(_partition_task(hg, ctx))
    return out


def _run_queue(work, ctx, workers: int | None = None):
    """PRIORITY QUEUE (Algorithm 2): workers pop the largest pending
    subgraph from a condition-variable-guarded heap; children re-enter the
    queue until only leaves remain. Each task's salt comes from its place
    in the hierarchy, so the result does not depend on the schedule.

    Workers default to the host's core count clamped to [2, 4]: a second
    worker keeps host-side extraction overlapping device work even on one
    core, and more than four oversubscribe the host.
    """
    if workers is None:
        workers = max(2, min(4, os.cpu_count() or 2))
    checkpoint = ctx[8]
    cv = threading.Condition()
    heap: list[tuple[int, int, _HostGraph]] = []
    out: list[_HostGraph] = []
    pending = [0]   # queued + in-flight tasks, guarded by cv
    errors: list[BaseException] = []
    for hg in work:
        heapq.heappush(heap, (-hg.n, hg.uid, hg))
        pending[0] += 1

    def worker():
        while True:
            with cv:
                while not heap and pending[0] > 0 and not errors:
                    cv.wait()
                if errors or pending[0] == 0:
                    return
                task = heapq.heappop(heap)[2]
            try:
                if checkpoint is not None:
                    checkpoint()   # cooperative cancellation per task
                children = _partition_task(task, ctx)
            except BaseException as exc:   # propagate to the caller
                with cv:
                    errors.append(exc)
                    cv.notify_all()
                return
            with cv:
                pending[0] -= 1
                for c in children:
                    if c.depth > 0:
                        heapq.heappush(heap, (-c.n, c.uid, c))
                        pending[0] += 1
                    else:
                        out.append(c)
                cv.notify_all()

    # each worker runs in a copy of the caller's context (its exact_sums)
    threads = [threading.Thread(target=contextvars.copy_context().run, args=(worker,))
               for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out
