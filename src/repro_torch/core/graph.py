"""Graph substrate: static-shape padded CSR graphs as tuples of tensors.

Conventions (the same as the JAX package's, so arrays compare one to one)
-------------------------------------------------------------------------
* Vertices ``0 .. n-1`` are real, ``n .. N-1`` are padding (weight 0).
* Every undirected edge {u, v} is stored twice (u->v and v->u).
* Edge slots ``m .. M-1`` are padding: ``rows == cols == N-1`` and
  ``ewgt == 0``, harmless under segment sums.
* ``rows`` is sorted ascending over the real slots and ``indptr`` is the
  exact CSR prefix over them (rows >= the real vertex count point at
  ``m``). Every constructor funnels through :func:`assemble_padded`, and
  the device-side split and contraction keep the invariant.

Stored types are the reference's: i32 ids and counts, f32 weights. Torch
indexes with i64 where it needs to. JAX clamps out-of-range gathers and
drops out-of-range scatters (``mode="drop"``); torch raises or asserts on
both, so this module clamps explicitly and sends dropped writes to a
spare trash slot that is cut off afterwards.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops as kops

I32 = torch.int32
F32 = torch.float32


class Graph(NamedTuple):
    """Padded CSR graph. Stacked containers carry a leading ``[B]`` axis on
    every field (``n``/``m`` are then ``[B]``)."""

    vwgt: torch.Tensor    # [N]   f32 vertex weights (0 on padding)
    rows: torch.Tensor    # [M]   i32 source vertex of each directed edge
    cols: torch.Tensor    # [M]   i32 target vertex of each directed edge
    ewgt: torch.Tensor    # [M]   f32 edge weights (0 on padding)
    indptr: torch.Tensor  # [N+1] i32 CSR row pointers over the padded arrays
    n: torch.Tensor       # []    i32 number of real vertices
    m: torch.Tensor       # []    i32 number of real directed edges

    @property
    def N(self) -> int:
        return self.vwgt.shape[-1]

    @property
    def M(self) -> int:
        return self.rows.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.vwgt.device

    def total_weight(self) -> torch.Tensor:
        return torch.sum(self.vwgt)

    def to(self, device) -> "Graph":
        return Graph(*(a.to(device) for a in self))


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one this raises: the port never
    falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "repro_torch on the CPU")
    return dev


def graph_from_numpy(fields: dict, device=None) -> Graph:
    """A Graph from numpy arrays of the reference's fields (``vwgt, rows,
    cols, ewgt, indptr, n, m``), e.g. ``np.asarray`` of a JAX ``Graph``."""
    dev = resolve_device(device)
    dt = {"vwgt": F32, "ewgt": F32}
    return Graph(**{f: torch.as_tensor(np.array(fields[f]), dtype=dt.get(f, I32),
                                       device=dev)
                    for f in Graph._fields})


def check_i32_range(n: int, m: int) -> None:
    """Overflow guard for the int32 index convention (>= 2^31 would wrap)."""
    limit = 2**31
    if n >= limit or m >= limit:
        raise ValueError(
            f"graph exceeds int32 index range: n={n}, m={m} (>= 2^31); "
            "the int32 CSR convention cannot represent it")


def padded_csr_indptr(rows: np.ndarray, m: int, N: int) -> np.ndarray:
    """[N+1] exact CSR prefix over the sorted real directed rows ``rows[:m]``."""
    counts = np.bincount(np.asarray(rows[:m], np.int64), minlength=N)
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr


def assemble_padded(vwgt, rows, cols, ewgt, n: int, N: int, M: int,
                    device=None) -> Graph:
    """A padded Graph on ``device`` from REAL (unpadded) host arrays;
    ``rows`` must be sorted ascending. One host->device copy per field."""
    dev = resolve_device(device)
    m = int(np.asarray(rows).shape[0])
    check_i32_range(max(n, N), max(m, M))
    if N < n or M < m:
        raise ValueError(f"padding too small: N={N}<{n} or M={M}<{m}")
    r = np.full(M, N - 1, np.int32)
    c = np.full(M, N - 1, np.int32)
    w = np.zeros(M, np.float32)
    r[:m] = rows
    c[:m] = cols
    w[:m] = ewgt
    vw = np.zeros(N, np.float32)
    vw[:n] = vwgt
    return Graph(
        vwgt=torch.from_numpy(vw).to(dev),
        rows=torch.from_numpy(r).to(dev),
        cols=torch.from_numpy(c).to(dev),
        ewgt=torch.from_numpy(w).to(dev),
        indptr=torch.from_numpy(padded_csr_indptr(r, m, N).astype(np.int32)).to(dev),
        n=torch.tensor(n, dtype=I32, device=dev),
        m=torch.tensor(m, dtype=I32, device=dev),
    )


def from_edges(n: int, u, v, w=None, vwgt=None, N: int | None = None,
               M: int | None = None, device=None) -> Graph:
    """Padded CSR Graph from an undirected edge list (each edge once;
    weights default to 1; ``N``/``M`` default to an exact fit)."""
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    keep = u != v  # drop self loops
    u, v = u[keep], v[keep]
    w = np.ones(u.shape[0], np.float64) if w is None else np.asarray(w, np.float64)[keep]
    vwgt_np = np.ones(n, np.float64) if vwgt is None else np.asarray(vwgt, np.float64)
    du = np.concatenate([u, v])
    dv = np.concatenate([v, u])
    dw = np.concatenate([w, w])
    m = du.shape[0]
    N = int(N if N is not None else n)
    M = int(M if M is not None else max(m, 1))
    order = np.argsort(du, kind="stable")
    return assemble_padded(vwgt_np, du[order], dv[order], dw[order], n, N, M,
                           device=device)


def pad_graph(g: Graph, N: int, M: int) -> Graph:
    """Host-side re-pad to (N, M) >= the current real sizes, on g's device."""
    n, m = int(g.n), int(g.m)
    return assemble_padded(g.vwgt[:n].cpu().numpy(), g.rows[:m].cpu().numpy(),
                           g.cols[:m].cpu().numpy(), g.ewgt[:m].cpu().numpy(),
                           n, N, M, device=g.device)


def edge_mask(g: Graph) -> torch.Tensor:
    """[M] bool: True on real (non-padding) edge slots."""
    return torch.arange(g.M, dtype=I32, device=g.device) < g.m


def vertex_mask(g: Graph) -> torch.Tensor:
    """[N] bool: True on real vertices."""
    return torch.arange(g.N, dtype=I32, device=g.device) < g.n


def label_sums(labels: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """[R, k]: for each row r of ``labels`` [R, L], the sum of the weights
    ``w`` ([L] or [R, L]) of the entries labelled b, for b in [0, k);
    entries labelled outside [0, k) add nothing.

    On the CPU each sum runs in entry order (``index_add_``), the
    reference's order: XLA's CPU scatter applies its updates in order. On
    the card ``index_add_`` would add floats with atomics, in whatever order
    the threads arrive; there each sum is a reduction of the masked
    [R, k, L] weights, whose order the shape fixes. Exact, and equal to the
    CPU's, while the weights are integers below 2^24.
    """
    if labels.device.type == "cuda":
        b = torch.arange(k, dtype=labels.dtype, device=labels.device)[None, :, None]
        return torch.where(labels[:, None, :] == b, w.expand(labels.shape)[:, None, :],
                           0.0).sum(-1)
    return _label_sums_in_order(labels, w, k)


def _label_sums_in_order(labels: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`label_sums` by ``index_add_`` (entry order on the CPU)."""
    R = labels.shape[0]
    lane = torch.arange(R, device=labels.device)[:, None] * k
    flat = torch.where((labels >= 0) & (labels < k), lane + labels, R * k)
    out = torch.zeros(R * k + 1, dtype=w.dtype, device=labels.device)
    out.index_add_(0, flat.reshape(-1), w.expand(labels.shape).reshape(-1))
    return out[: R * k].view(R, k)


def row_label_sums(g: Graph, labels: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """[R, N, k]: for each vertex u of ``g`` and row r of the edge labels
    ``labels`` [R, M], the weights ``w`` [M] of u's edges labelled b, for b
    in [0, k), added in CSR order; edges labelled outside [0, k) and the
    padding edges (past ``indptr[N]``) add nothing.

    One segmented sum over the CSR rows, each sum a loop in edge order on
    either device: the reference's order, so float weights give the
    reference's bits on the card too (``index_add_`` would add them with
    atomics there).
    """
    R, M = labels.shape
    b = torch.arange(k, dtype=labels.dtype, device=labels.device)
    vals = torch.where(labels.T[:, :, None] == b, w[:, None, None], 0.0).reshape(M, R * k)
    out = torch.segment_reduce(vals, "sum", offsets=g.indptr, axis=0, unsafe=True)
    return out.view(g.N, R, k).permute(1, 0, 2).contiguous()


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``cumsum`` along the last axis of a 2-D ``x``, in an order fixed by
    its shape. On the card torch scans the rows of a tensor of several rows
    with a fixed tree each, but the single row of a ``[1, L]`` tensor with
    a one-pass look-back scan whose float order changes from run to run; a
    single row is therefore scanned beside a row of zeros."""
    if x.device.type == "cuda" and x.shape[0] == 1:
        return torch.cumsum(torch.cat([x, torch.zeros_like(x)]), dim=-1)[:1]
    return torch.cumsum(x, dim=-1)


def edge_cut(g: Graph, part: torch.Tensor) -> torch.Tensor:
    """Total weight of cut edges (each undirected edge counted once)."""
    cut = (part[g.rows] != part[g.cols]) & edge_mask(g)
    return torch.sum(torch.where(cut, g.ewgt, 0.0)) / 2.0


def block_weights(g: Graph, part: torch.Tensor, k: int) -> torch.Tensor:
    """[k] f32 total vertex weight per block (padding contributes 0)."""
    safe = torch.where(vertex_mask(g), part, 0)
    return label_sums(safe[None], g.vwgt, k)[0]


# ---------------------------------------------------------------------------
# Synthetic instance generators (the paper's benchmark families, downscaled).
# Host-side numpy, seeded, deterministic: the same edges as the JAX package.
# ---------------------------------------------------------------------------

def gen_rgg(n: int, seed: int = 0, radius_scale: float = 0.55, device=None) -> Graph:
    """Random geometric graph in the unit square (paper: rgg23/rgg24)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    r = radius_scale * np.sqrt(np.log(max(n, 2)) / n)
    nb = max(1, int(1.0 / r))
    cell = (pts / (1.0 / nb)).astype(np.int64)
    cell_id = cell[:, 0] * nb + cell[:, 1]
    order = np.argsort(cell_id, kind="stable")
    us, vs = [], []
    starts = {}
    sorted_ids = cell_id[order]
    uniq, first = np.unique(sorted_ids, return_index=True)
    for cid, fi in zip(uniq, first):
        starts[int(cid)] = int(fi)
    bounds = dict(zip(uniq.tolist(), np.append(first[1:], n).tolist()))
    for cx in range(nb):
        for cy in range(nb):
            cid = cx * nb + cy
            if cid not in starts:
                continue
            a = order[starts[cid]:bounds[cid]]
            cand = [a]
            for dx, dy in ((0, 1), (1, -1), (1, 0), (1, 1)):
                nc = (cx + dx) * nb + (cy + dy)
                if 0 <= cx + dx < nb and 0 <= cy + dy < nb and nc in starts:
                    cand.append(order[starts[nc]:bounds[nc]])
            b = np.concatenate(cand)
            d2 = ((pts[a, None, :] - pts[None, b, :]) ** 2).sum(-1)
            ii, jj = np.nonzero(d2 <= r * r)
            uu, vv = a[ii], b[jj]
            keep = uu < vv
            us.append(uu[keep])
            vs.append(vv[keep])
    u = np.concatenate(us) if us else np.zeros(0, np.int64)
    v = np.concatenate(vs) if vs else np.zeros(0, np.int64)
    return from_edges(n, u, v, device=device)


def gen_grid(side: int, diag: bool = True, device=None) -> Graph:
    """Triangulated grid, a Delaunay-triangulation stand-in (del23/del24)."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    us = [idx[:, :-1].ravel(), idx[:-1, :].ravel()]
    vs = [idx[:, 1:].ravel(), idx[1:, :].ravel()]
    if diag:
        us.append(idx[:-1, :-1].ravel())
        vs.append(idx[1:, 1:].ravel())
    return from_edges(n, np.concatenate(us), np.concatenate(vs), device=device)


def gen_road(n: int, seed: int = 0, device=None) -> Graph:
    """Road-network-like graph (paper: eur/deu): a perturbed grid with 10%
    of its edges dropped and sparse random shortcuts added."""
    side = int(np.sqrt(n))
    n = side * side
    rng = np.random.default_rng(seed)
    idx = np.arange(n).reshape(side, side)
    u = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    v = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    keep = rng.random(u.shape[0]) > 0.1
    u, v = u[keep], v[keep]
    ns = n // 50
    su = rng.integers(0, n, ns)
    sv = np.minimum(su + rng.integers(1, side, ns), n - 1)
    return from_edges(n, np.concatenate([u, su]), np.concatenate([v, sv]),
                      device=device)


def gen_kron(scale: int, edge_factor: int = 8, seed: int = 0, device=None) -> Graph:
    """Kronecker-style power-law graph (complex-network instance family)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    A, B, C = 0.57, 0.19, 0.19
    u = np.zeros(m, np.int64)
    v = np.zeros(m, np.int64)
    for bit in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        ubit = (r1 > A + B).astype(np.int64)
        vbit = np.where(ubit == 0, (r1 > A).astype(np.int64),
                        (r2 > C / (C + (1 - A - B - C))).astype(np.int64))
        u |= ubit << bit
        v |= vbit << bit
    keep = u != v
    return from_edges(n, u[keep], v[keep], device=device)


def float_weights(g: Graph, seed: int = 0) -> Graph:
    """``g`` with every real vertex weight and every undirected edge weight
    (both directions alike) multiplied by a seeded uniform float32 in
    [0.5, 1.5): a float-weighted variant of an instance, on ``g``'s device."""
    n, m = int(g.n), int(g.m)
    rng = np.random.default_rng(seed)
    r, c = g.rows[:m].cpu().numpy(), g.cols[:m].cpu().numpy()
    _, pair = np.unique(np.minimum(r, c).astype(np.int64) * max(n, 1) + np.maximum(r, c),
                        return_inverse=True)
    fv = rng.uniform(0.5, 1.5, n).astype(np.float32)
    fe = rng.uniform(0.5, 1.5, int(pair.max()) + 1 if m else 0).astype(np.float32)[pair]
    vwgt, ewgt = g.vwgt.clone(), g.ewgt.clone()
    vwgt[:n] *= torch.from_numpy(fv).to(g.device)
    ewgt[:m] *= torch.from_numpy(fe).to(g.device)
    return g._replace(vwgt=vwgt, ewgt=ewgt)


# ---------------------------------------------------------------------------
# Device-resident subgraph extraction (the multisection level loop)
# ---------------------------------------------------------------------------

def _fit(a: torch.Tensor, L: int, fill) -> torch.Tensor:
    """Cut or extend the last axis to length ``L``."""
    if a.shape[-1] >= L:
        return a[..., :L]
    pad = torch.full(a.shape[:-1] + (L - a.shape[-1],), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], dim=-1)


def repad_device(g: Graph, N2: int, M2: int) -> Graph:
    """Re-pad a Graph (or a stacked ``[B, ...]`` container) to ``(N2, M2)``
    on its device: shrinking drops only padding slots (callers guarantee
    the real counts fit); growing extends with the pad convention."""
    N = g.N
    dev = g.device
    m = g.m[..., None]
    ar_m = torch.arange(M2, dtype=I32, device=dev)
    rows = torch.where(ar_m < m, _fit(g.rows, M2, 0), N2 - 1)
    cols = torch.where(ar_m < m, _fit(g.cols, M2, 0), N2 - 1)
    ar_n = torch.arange(N2 + 1, dtype=I32, device=dev)
    indptr = torch.where(ar_n < N + 1, _fit(g.indptr, N2 + 1, 0), m)
    return Graph(vwgt=_fit(g.vwgt, N2, 0.0).contiguous(), rows=rows, cols=cols,
                 ewgt=_fit(g.ewgt, M2, 0.0).contiguous(), indptr=indptr,
                 n=g.n, m=g.m)


def take_lanes(g: Graph, sel: torch.Tensor) -> Graph:
    """Select lanes of a stacked ``[B, ...]`` Graph along axis 0."""
    return Graph(*(a.index_select(0, sel) for a in g))


def _sorted_offsets(keys_sorted: torch.Tensor, k: int) -> torch.Tensor:
    """[k+2] start of each key 0..k+1 in a sorted i32 key vector: the
    exclusive prefix of the per-key counts, without a scatter."""
    probe = torch.arange(k + 2, dtype=I32, device=keys_sorted.device)
    return torch.searchsorted(keys_sorted, probe, out_int32=True)


def split_blocks(g: Graph, part: torch.Tensor, orig: torch.Tensor, k: int,
                 sentinel: torch.Tensor) -> tuple[Graph, torch.Tensor, torch.Tensor]:
    """On-device induced-subgraph extraction: the ``k`` block subgraphs of
    ``g`` under ``part`` as ONE stacked ``[k, N]``/``[k, M]`` Graph, in the
    same order as the reference (stable sort by block, then a relabel
    gather through ``kernels/ops.gather_rows``, five gathers per call).

    ``orig`` is the [N] original-vertex-id view of ``g`` (padding holds
    ``sentinel``, which is carried to the child padding). Returns
    ``(children, child_orig [k, N], wsum [k] f32)``; the children's
    ``n``/``m`` fields are ``[k]``.

    Counts come from the sorted block keys (offsets by binary search) and
    child row pointers from the sorted child rows, both exact under the
    sorted-``rows`` invariant, instead of scatter-adds: no atomics piled on
    one padding slot.
    """
    N, M = g.N, g.M
    dev = g.device
    ar_n = torch.arange(N, dtype=I32, device=dev)
    ar_m = torch.arange(M, dtype=I32, device=dev)

    # --- vertices: stable compaction by block ------------------------------
    blk = torch.where(ar_n < g.n, part[:N].to(I32), k)
    order = torch.argsort(blk, stable=True).to(I32)
    voff = _sorted_offsets(blk[order], k)[: k + 1]          # exclusive prefix
    counts = voff[1:] - voff[:-1]                             # [k]
    rank = ar_n - voff[blk[order]]
    relabel = torch.empty(N, dtype=I32, device=dev)
    relabel[order] = rank                                     # parent -> child id
    vsrc = voff[:k, None] + ar_n[None, :]
    v_ok = ar_n[None, :] < counts[:, None]
    vids = order[vsrc.clamp(0, N - 1)]
    cvwgt = torch.where(v_ok, kops.gather_rows(g.vwgt, vids), 0.0)
    corig = torch.where(v_ok, kops.gather_rows(orig, vids), sentinel)

    # --- edges: keep intra-block, relabel endpoints ------------------------
    emask = ar_m < g.m       # padding anchors (N-1) may alias a real vertex
    bu = blk[g.rows.clamp(0, N - 1)]
    bv = blk[g.cols.clamp(0, N - 1)]
    eb = torch.where(emask & (bu == bv) & (bu < k), bu, k)
    eorder = torch.argsort(eb, stable=True).to(I32)
    eoff = _sorted_offsets(eb[eorder], k)[: k + 1]
    ecounts = eoff[1:] - eoff[:-1]
    esrc = eoff[:k, None] + ar_m[None, :]
    e_ok = ar_m[None, :] < ecounts[:, None]
    eids = eorder[esrc.clamp(0, M - 1)]
    crows = torch.where(e_ok, kops.gather_rows(relabel[g.rows], eids), N - 1)
    ccols = torch.where(e_ok, kops.gather_rows(relabel[g.cols], eids), N - 1)
    cewgt = torch.where(e_ok, kops.gather_rows(g.ewgt, eids), 0.0)

    # --- exact per-child CSR prefix (matches padded_csr_indptr) ------------
    # child rows are sorted and their padding (N-1) sorts last, so the
    # prefix at row r < N is the count of entries < r; the last is m.
    probe = ar_n[None, :].expand(k, N).contiguous()
    cindptr = torch.cat([torch.searchsorted(crows, probe, out_int32=True),
                         ecounts[:, None]], dim=1)

    wsum = label_sums(blk[None], g.vwgt, k)[0]
    children = Graph(vwgt=cvwgt, rows=crows, cols=ccols, ewgt=cewgt,
                     indptr=cindptr, n=counts, m=ecounts)
    return children, corig, wsum


# ---------------------------------------------------------------------------
# ELL adjacency (the coarsening kernels' layout)
# ---------------------------------------------------------------------------

ELL_DEG_CAP = 64  # hard cap on the static neighbour-matrix width


def default_ell_deg(N: int, M: int, cap: int = ELL_DEG_CAP) -> int:
    """Static degree cap for the [N, DEG] ELL layout: twice the mean
    directed degree, rounded up to a multiple of 8, clamped to [8, cap]."""
    avg = (M + max(N, 1) - 1) // max(N, 1)
    return int(min(cap, max(8, ((2 * avg + 7) // 8) * 8)))


def ell_adjacency(g: Graph, deg: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CSR -> padded ELL: ``(adj [N, deg] i32 (pad = N), adw [N, deg] f32
    (0 on padding), overflow [N] bool)``; rows longer than ``deg`` keep
    their first ``deg`` CSR neighbours and are flagged in ``overflow``.

    Each edge's slot is ``index - indptr[row]`` (sorted-``rows``
    invariant); truncated and padding edges write to a trash slot.
    """
    N, M = g.N, g.M
    dev = g.device
    idx = torch.arange(M, dtype=I32, device=dev)
    emask = idx < g.m
    r = g.rows.clamp(0, N - 1)
    pos = idx - g.indptr[r]
    valid = emask & (pos >= 0) & (pos < deg)
    slot = torch.where(valid, r.long() * deg + pos, N * deg)
    adj = torch.full((N * deg + 1,), N, dtype=I32, device=dev)
    adj[slot] = torch.where(valid, g.cols, N)
    adw = torch.zeros(N * deg + 1, dtype=g.ewgt.dtype, device=dev)
    adw[slot] = torch.where(valid, g.ewgt, 0.0)
    overflow = (g.indptr[1:] - g.indptr[:-1]) > deg
    return adj[:-1].view(N, deg), adw[:-1].view(N, deg), overflow
