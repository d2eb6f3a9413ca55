"""Workload ingestion: weighted task graphs with provenance.

Every workload that enters the mapper is first expressed as a
:class:`TaskGraph`: an undirected weighted edge list plus vertex weights in
one canonical form. It is the single place where

* validation happens (vertex ids in range, finite non-negative weights, a
  non-empty graph), with clear ``ValueError``s at construction time;
* normalization happens (self-loops dropped, duplicate edges coalesced by
  summing, direction canonicalized to ``u < v``, edges sorted
  lexicographically), so two descriptions of the same workload are the same
  object bit for bit;
* weights are quantized (vertex ids to i32, guarded by
  :func:`core.graph.check_i32_range`; edge and vertex weights to f32, the
  types the whole pipeline runs on);
* the stable content fingerprint is derived (:meth:`TaskGraph.fingerprint`,
  blake2b over the canonical arrays), deterministic across processes, so a
  content-addressed cache or store can key on it.

A TaskGraph is a host object of numpy arrays; its fingerprint is the same
bytes as the JAX package's for the same content, so the two packages' keys
are interchangeable. ``to_graph(device=...)`` produces the canonical
padded-CSR :class:`core.graph.Graph` on a device; because normalization is
canonical, the CSR (and so every mapping computed from it) is a pure
function of the fingerprint.

Builders
--------
* :func:`TaskGraph.from_edges` — undirected edge list (each edge once).
* :func:`TaskGraph.from_coo`   — directed COO triples; the undirected
  weight of ``{u, v}`` is the SUM of both directed entries.
* :func:`TaskGraph.from_graph` — lossless import of a padded-CSR ``Graph``
  on any device (each undirected edge is stored twice with equal weight;
  the ``u < v`` copy is taken).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Mapping

import numpy as np

from . import graph as G

_FP_VERSION = b"TGF1"  # bump when the canonical form changes


def _as_1d(name: str, a, dtype) -> np.ndarray:
    arr = np.asarray(a, dtype)
    if arr.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got shape {arr.shape}")
    return arr


def _canonicalize(n: int, u: np.ndarray, v: np.ndarray,
                  w: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drop self-loops, canonicalize direction to u < v, coalesce duplicate
    edges by summing their weights, drop non-positive weights, sort
    lexicographically by (u, v). Pure numpy, deterministic."""
    keep = (u != v) & (w > 0.0)
    u, v, w = u[keep], v[keep], w[keep]
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    order = np.lexsort((hi, lo))
    lo, hi, w = lo[order], hi[order], w[order]
    if lo.size:
        new_edge = np.ones(lo.size, bool)
        new_edge[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
        idx = np.cumsum(new_edge) - 1
        wsum = np.zeros(int(idx[-1]) + 1, np.float64)
        np.add.at(wsum, idx, w)
        lo, hi = lo[new_edge], hi[new_edge]
        w = wsum
    return lo, hi, w


@dataclasses.dataclass(frozen=True, eq=False)
class TaskGraph:
    """Canonical weighted task graph (the workload-ingestion currency).

    Fields are the NORMALIZED arrays; construct via the ``from_*`` builders,
    which validate and normalize (the raw constructor trusts its inputs).
    ``meta`` carries provenance and never enters the fingerprint.
    """

    n: int                    # number of tasks (vertices)
    u: np.ndarray             # [m] i32, u < v, lexicographically sorted
    v: np.ndarray             # [m] i32
    w: np.ndarray             # [m] f32 edge weights (communication volume)
    vwgt: np.ndarray          # [n] f32 vertex weights (compute load)
    meta: dict = dataclasses.field(default_factory=dict)
    # to_graph's memo of the default-padding lowering, one Graph per device
    _graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    # ------------------------------------------------------------- builders

    @staticmethod
    def from_edges(n: int, u, v, w=None, vwgt=None,
                   meta: Mapping | None = None) -> "TaskGraph":
        """Build from an undirected edge list (each edge listed once;
        duplicates and self-loops are normalized away)."""
        n = int(n)
        if n <= 0:
            raise ValueError(f"task graph needs n >= 1 vertices, got n={n}")
        u = _as_1d("u", u, np.int64)
        v = _as_1d("v", v, np.int64)
        if u.shape != v.shape:
            raise ValueError(f"u and v differ in length: {u.size} vs {v.size}")
        if w is None:
            w = np.ones(u.size, np.float64)
        else:
            w = _as_1d("w", w, np.float64)
            if w.shape != u.shape:
                raise ValueError(
                    f"w length {w.size} does not match edge count {u.size}")
        if u.size and (int(min(u.min(), v.min())) < 0
                       or int(max(u.max(), v.max())) >= n):
            raise ValueError(
                f"edge endpoints out of range [0, {n}): "
                f"min={min(u.min(), v.min())}, max={max(u.max(), v.max())}")
        if not np.all(np.isfinite(w)):
            raise ValueError("edge weights must be finite (found NaN/inf)")
        if np.any(w < 0):
            raise ValueError("edge weights must be non-negative")
        if vwgt is None:
            vw = np.ones(n, np.float64)
        else:
            vw = _as_1d("vwgt", vwgt, np.float64)
            if vw.size != n:
                raise ValueError(
                    f"vwgt length {vw.size} does not match n={n}")
            if not np.all(np.isfinite(vw)):
                raise ValueError("vertex weights must be finite")
            if np.any(vw < 0):
                raise ValueError("vertex weights must be non-negative")
        lo, hi, ww = _canonicalize(n, u, v, w)
        G.check_i32_range(n, 2 * lo.size)  # to_graph stores each edge twice
        return TaskGraph(n=n, u=lo.astype(np.int32), v=hi.astype(np.int32),
                         w=ww.astype(np.float32), vwgt=vw.astype(np.float32),
                         meta=dict(meta or {}))

    @staticmethod
    def from_coo(n: int, rows, cols, vals=None, vwgt=None,
                 meta: Mapping | None = None) -> "TaskGraph":
        """Build from DIRECTED COO triples. The undirected weight of
        ``{u, v}`` is the sum of the ``u->v`` and ``v->u`` entries (the
        volume crossing the pair either way): the coalescing step
        symmetrizes."""
        return TaskGraph.from_edges(n, rows, cols, vals, vwgt=vwgt, meta=meta)

    @staticmethod
    def from_graph(g: G.Graph, meta: Mapping | None = None) -> "TaskGraph":
        """Import a padded-CSR :class:`core.graph.Graph` on any device (its
        real slots are fetched to the host once). The CSR stores each
        undirected edge twice with equal weight; the ``u < v`` copies are
        taken verbatim, so the import is exact (no /2 rounding)."""
        n = int(g.n)
        m = int(g.m)
        rows = g.rows[:m].cpu().numpy().astype(np.int64)
        cols = g.cols[:m].cpu().numpy().astype(np.int64)
        ew = g.ewgt[:m].cpu().numpy().astype(np.float64)
        keep = rows < cols
        return TaskGraph.from_edges(
            n, rows[keep], cols[keep], ew[keep],
            vwgt=g.vwgt[:n].cpu().numpy(), meta=meta)

    # ------------------------------------------------------------ derived

    @property
    def m(self) -> int:
        """Number of undirected edges (after normalization)."""
        return int(self.u.size)

    def total_edge_weight(self) -> float:
        return float(self.w.sum())

    def total_vertex_weight(self) -> float:
        return float(self.vwgt.sum())

    def fingerprint(self) -> bytes:
        """16-byte stable content address of the canonical arrays.

        blake2b over the little-endian bytes of (n, u, v, w, vwgt), each
        preceded by its numpy dtype name, plus a format-version tag.
        Independent of ``meta`` and of the edge order and direction the
        builder was fed.
        """
        hs = hashlib.blake2b(digest_size=16)
        hs.update(_FP_VERSION)
        hs.update(int(self.n).to_bytes(8, "little"))
        for arr in (self.u, self.v, self.w, self.vwgt):
            a = np.ascontiguousarray(arr)
            if a.dtype.byteorder == ">":  # canonical little-endian bytes
                a = a.astype(a.dtype.newbyteorder("<"))
            hs.update(str(a.dtype).encode())
            hs.update(a.tobytes())
        return hs.digest()

    def to_graph(self, N: int | None = None, M: int | None = None,
                 device=None) -> G.Graph:
        """The canonical padded-CSR :class:`core.graph.Graph` on ``device``
        (``None`` = the card). The default padding is memoized per device,
        so a graph on one device never answers a request for another."""
        dev = G.resolve_device(device)
        memo = N is None and M is None
        if memo and str(dev) in self._graphs:
            return self._graphs[str(dev)]
        g = G.from_edges(self.n, self.u.astype(np.int64), self.v.astype(np.int64),
                         self.w.astype(np.float64), vwgt=self.vwgt, N=N, M=M,
                         device=dev)
        if memo:
            self._graphs[str(dev)] = g
        return g

    def __repr__(self) -> str:  # arrays elided: keep service logs readable
        src = self.meta.get("source", "?")
        return (f"TaskGraph(n={self.n}, m={self.m}, "
                f"source={src!r}, fp={self.fingerprint().hex()[:8]})")
