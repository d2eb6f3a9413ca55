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

import contextlib
import contextvars
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops as kops

I32 = torch.int32
F32 = torch.float32


class Graph(NamedTuple):
    """Padded CSR graph. Stacked containers (the lanes of a batch) carry a
    leading ``[B]`` axis on every field (``n``/``m`` are then ``[B]``); ids
    stay local to each lane."""

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
        return xla_sum(self.vwgt)

    def to(self, device) -> "Graph":
        return Graph(*(a.to(device) for a in self))


def as_lanes(g: Graph) -> tuple[Graph, bool]:
    """``g`` as a stacked ``[B, ...]`` batch, and whether it was one graph
    (then B = 1). The batched routines take either and run one code path."""
    if g.n.dim() == 0:
        return Graph(*(a[None] for a in g)), True
    return g, False


def lane_offsets(B: int, size: int, device) -> torch.Tensor:
    """[B, 1] i64 offsets ``b * size``: lane-local ids to ids into the
    flattened [B * size] arrays of a batch."""
    return torch.arange(B, dtype=torch.int64, device=device)[:, None] * size


def lane_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive i32 prefix sums of the integers ``x`` [B, L] along each
    row: one scan over the flattened rows, less each row's start (exact for
    integer totals below 2^31). On the card torch's scan along the last
    axis of a [B, L] tensor is slow for a few long rows and for many short
    ones (an H100 took about 9 ms for 1.5 M rows of 48); one flat scan
    takes a fraction of that."""
    B, L = x.shape
    flat = torch.cumsum(x.reshape(-1), 0, dtype=I32).view(B, L)
    return flat - torch.nn.functional.pad(flat[:-1, -1], (1, 0))[:, None]


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
    """[M] bool ([B, M] for a batch): True on real (non-padding) edge slots."""
    return torch.arange(g.M, dtype=I32, device=g.device) < g.m[..., None]


def vertex_mask(g: Graph) -> torch.Tensor:
    """[N] bool ([B, N] for a batch): True on real vertices."""
    return torch.arange(g.N, dtype=I32, device=g.device) < g.n[..., None]


_XLA_SUM_WINDOW = 32


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order XLA's CPU compiler adds, on
    either device.

    XLA rewrites a sum of L > 32 terms into windows of 32 (the L terms
    centred in ceil(L / 32) * 32 slots, the padding zeros), each window added
    in order, and repeats on the window sums until 32 or fewer remain, which
    are added in order. The reference takes every ``jnp.sum`` so; ``torch.sum``
    adds in another order, and for float weights whose sums are inexact
    (above 2^24, or fractions) the two round apart. Here each window is a
    segment of ``segment_reduce`` over a 2-D tensor, a loop in entry order
    on either device. Where :func:`exact_sums` declared the weights exact
    the card takes ``torch.sum``: every order gives the same bits there.
    """
    if x.is_cuda and _EXACT_SUMS.get():
        return x.sum(-1)
    lead = x.shape[:-1]
    y = x.reshape(-1, x.shape[-1]).T          # [L, B]: the sum runs down axis 0
    while True:
        L = y.shape[0]
        if L > _XLA_SUM_WINDOW:
            m = -(-L // _XLA_SUM_WINDOW)
            pad = m * _XLA_SUM_WINDOW - L
            y = torch.nn.functional.pad(y, (0, 0, pad // 2, pad - pad // 2))
            offsets = torch.arange(0, m * _XLA_SUM_WINDOW + 1, _XLA_SUM_WINDOW,
                                   device=x.device)
        else:
            offsets = torch.tensor([0, L], device=x.device)
        y = torch.segment_reduce(y.contiguous(), "sum", offsets=offsets, axis=0, unsafe=True)
        if L <= _XLA_SUM_WINDOW:
            return y[0].reshape(lead)


def degrees(g: Graph) -> torch.Tensor:
    """[N] i32 CSR row lengths (padding rows hold 0)."""
    return g.indptr[1:] - g.indptr[:-1]


def sorted_segment_sum(w: torch.Tensor, keys: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[num_segments]: the sums of ``w`` [L] over the runs of equal ``keys``
    [L] (i32, ascending, in [0, num_segments]; the entries keyed
    ``num_segments`` add to no sum); empty segments give 0.

    Each sum is a loop in entry order on either device (``segment_reduce``
    of a 2-D tensor; on the card a 1-D one may go to a tree reduction), the
    order of XLA's CPU scatter-add, so float weights give the reference's
    bits on both devices (``index_add_`` would add them with atomics on the
    card).
    """
    offsets = _sorted_offsets(keys, num_segments)[: num_segments + 1]
    return torch.segment_reduce(w[:, None], "sum", offsets=offsets, axis=0,
                                unsafe=True)[:, 0]


def segment_sum(w: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """:func:`sorted_segment_sum` of unsorted i32 ``ids``: a stable sort by
    id first keeps each segment's entries in entry order."""
    keys, perm = torch.sort(ids, stable=True)
    return sorted_segment_sum(w[perm], keys, num_segments)


# Whether the weight sums of the current mapping or partition call are exact
# in any order (see sums_are_exact): the card then takes torch's fast
# reductions and scans, which add in other orders than the reference. None:
# not declared (the ordered routes).
_EXACT_SUMS = contextvars.ContextVar("exact_sums", default=None)


def sums_are_exact(g: Graph) -> bool:
    """True when every sum of vertex weights and every sum of edge weights
    of ``g`` is exact in float32 whatever the order of the adds: integer
    weights whose absolute totals are below 2^24 (unit-weight graphs and
    their contractions). For a batch, true when it holds for every lane
    (each lane's totals below 2^24). One fetch."""
    ok = torch.ones((), dtype=torch.bool, device=g.device)
    for w in (g.vwgt, g.ewgt):
        ok &= ((w == torch.round(w)).all()
               & (w.abs().sum(-1, dtype=torch.float64) < 2**24).all())
    return bool(ok)


@contextlib.contextmanager
def exact_sums(g: Graph):
    """Declare, for the sums inside (:func:`label_sums`, :func:`xla_sum`,
    :func:`row_cumsum`, in this thread), whether the weights of ``g`` and of
    every graph made from it (subgraphs, contractions) are exact in any
    order (:func:`sums_are_exact`, on the card only). A declaration already
    in force is kept: a mapping's root covers its partition calls, which
    then fetch nothing for it."""
    if _EXACT_SUMS.get() is not None:
        yield
        return
    token = _EXACT_SUMS.set(g.device.type == "cuda" and sums_are_exact(g))
    try:
        yield
    finally:
        _EXACT_SUMS.reset(token)


def label_sums(labels: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """[R, k]: for each row r of ``labels`` [R, L], the sum of the weights
    ``w`` ([L] or [R, L]) of the entries labelled b, for b in [0, k);
    entries labelled outside [0, k) add nothing.

    Each sum runs in entry order, the reference's order (XLA's CPU scatter
    applies its updates in order): on the CPU by ``index_add_``, on the card
    by :func:`segment_sum` (``index_add_`` would add floats with atomics
    there, in whatever order the threads arrive). Where :func:`exact_sums`
    declared the weights exact, the card takes a reduction of the masked
    [R, k, L] weights instead, far faster and with the same bits.
    """
    if labels.device.type != "cuda":
        return _label_sums_in_order(labels, w, k)
    if _EXACT_SUMS.get():
        b = torch.arange(k, dtype=labels.dtype, device=labels.device)[None, :, None]
        return torch.where(labels[:, None, :] == b, w.expand(labels.shape)[:, None, :],
                           0.0).sum(-1)
    R = labels.shape[0]
    lane = torch.arange(R, dtype=I32, device=labels.device)[:, None] * k
    flat = torch.where((labels >= 0) & (labels < k), lane + labels, R * k).to(I32)
    # the unlabelled entries sort last, past the last segment: no sum runs
    # over them
    return segment_sum(w.expand(labels.shape).reshape(-1), flat.reshape(-1),
                       R * k).view(R, k)


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
    padding edges (past ``indptr[N]``) add nothing. For the lanes of a batch
    ``g`` [B, ...], ``labels`` [B, R, M] and ``w`` [B, M] give [B, R, N, k].

    One segmented sum over the CSR rows of every lane, each sum a loop in
    edge order on either device: the reference's order, so float weights
    give the reference's bits on the card too (``index_add_`` would add
    them with atomics there). The lanes' real edges are first packed end to
    end (each lane's padding moved behind all of them, past the last
    segment), so no segment spans a lane's padding: a segment is one
    thread's serial loop on the card.
    """
    gb, single = as_lanes(g)
    if single:
        labels, w = labels[None], w[None]
    B, R, M = labels.shape
    N = gb.N
    dev = labels.device
    start = torch.cumsum(gb.m, 0) - gb.m                      # [B] first packed slot
    offsets = (gb.indptr + start[:, None]).reshape(-1)
    lab = labels.transpose(1, 2)                              # [B, M, R]
    if B > 1:   # pack the real edges end to end, the padding behind them
        e = torch.arange(M, dtype=torch.int64, device=dev)
        m = gb.m.long()[:, None]
        pad_before = lane_offsets(B, M, dev) - start.long()[:, None]
        dest = torch.where(e < m, start.long()[:, None] + e,
                           m.sum() + pad_before + e - m).reshape(-1)
        lab = torch.empty(B * M, R, dtype=labels.dtype, device=dev).index_copy_(
            0, dest, lab.reshape(B * M, R))
        w = torch.empty(B * M, dtype=w.dtype, device=dev).index_copy_(0, dest, w.reshape(-1))
    b = torch.arange(k, dtype=labels.dtype, device=dev)
    vals = torch.where(lab.reshape(B * M, R, 1) == b, w.reshape(B * M, 1, 1),
                       0.0).reshape(B * M, R * k)
    out = torch.segment_reduce(vals, "sum", offsets=offsets, axis=0, unsafe=True)
    out = torch.nn.functional.pad(out, (0, 0, 0, 1))   # the last lane's dropped segment
    out = out.view(B, N + 1, R, k)[:, :N].permute(0, 2, 1, 3).contiguous()
    return out[0] if single else out


_XLA_SCAN_BLOCK = 16


def _scan_in_order(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along a short last axis, one add at a time."""
    out = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., j])
    return torch.stack(out, -1)


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``cumsum`` along the last axis, in the order XLA's CPU compiler adds,
    on either device.

    XLA scans L > 16 terms in blocks of 16 (the last block padded with
    zeros): the prefix sums within each block, one add at a time, plus the
    block's offset, the scan (the same way, recursively) of the preceding
    blocks' totals. Float sums that are inexact (above 2^24, or fractions)
    depend on that order: ``torch.cumsum`` adds one after another on the
    CPU and in a tree, or a look-back scan whose order varies from run to
    run, on the card. Here every add is an explicit elementwise op, so both
    devices give the reference's bits. Where :func:`exact_sums` declared the
    weights exact the card takes ``torch.cumsum``: every order gives the
    same bits there.
    """
    if x.is_cuda and _EXACT_SUMS.get():
        return torch.cumsum(x, dim=-1)
    L = x.shape[-1]
    if L <= _XLA_SCAN_BLOCK:
        return _scan_in_order(x) if L else x
    m = -(-L // _XLA_SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, m * _XLA_SCAN_BLOCK - L))
    inblock = _scan_in_order(xp.reshape(*x.shape[:-1], m, _XLA_SCAN_BLOCK))
    before = torch.nn.functional.pad(row_cumsum(inblock[..., -1])[..., :-1], (1, 0))
    return (inblock + before[..., None]).reshape(*x.shape[:-1], -1)[..., :L]


def edge_cut(g: Graph, part: torch.Tensor) -> torch.Tensor:
    """Total weight of cut edges (each undirected edge counted once)."""
    cut = (part[g.rows] != part[g.cols]) & edge_mask(g)
    return xla_sum(torch.where(cut, g.ewgt, 0.0)) / 2.0


def block_weights(g: Graph, part: torch.Tensor, k: int) -> torch.Tensor:
    """[k] f32 total vertex weight per block (padding contributes 0)."""
    safe = torch.where(vertex_mask(g), part, 0)
    return label_sums(safe[None], g.vwgt, k)[0]


def quotient_graph_arrays(g: Graph, part: torch.Tensor, num_blocks: int):
    """Dense quotient adjacency [k, k] + block weights [k] (for small k);
    each sum in entry order (:func:`segment_sum`)."""
    k = num_blocks
    mask = edge_mask(g)
    pu = torch.where(mask, part[g.rows], 0)
    pv = torch.where(mask, part[g.cols], 0)
    w = torch.where(mask & (pu != pv), g.ewgt, 0.0)
    adj = segment_sum(w, (pu * k + pv).to(I32), k * k).view(k, k)
    bw = segment_sum(g.vwgt, torch.where(vertex_mask(g), part, 0).to(I32), k)
    return adj, bw


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
    exclusive prefix of the per-key counts, without a scatter; [B, k+2]
    for the [B, L] rows of a batch, each sorted."""
    probe = torch.arange(k + 2, dtype=I32, device=keys_sorted.device)
    probe = probe.expand(*keys_sorted.shape[:-1], k + 2).contiguous()
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
    ``n``/``m`` fields are ``[k]``. For the lanes of a batch (``g`` [B,
    ...], ``part`` and ``orig`` [B, N]) every step runs once for all lanes
    and the children are lane-major, ``[B * k, ...]`` (lane i's block b at
    ``i * k + b``), as splitting each lane alone and concatenating; the
    gathers read the flattened lanes, each lane's indices offset after its
    own clip.

    Counts come from the sorted block keys (offsets by binary search) and
    child row pointers from the sorted child rows, both exact under the
    sorted-``rows`` invariant, instead of scatter-adds: no atomics piled on
    one padding slot.
    """
    g, single = as_lanes(g)
    if single:
        part, orig = part[None], orig[None]
    B, N, M = g.n.shape[0], g.N, g.M
    dev = g.device
    ar_n = torch.arange(N, dtype=I32, device=dev)
    ar_m = torch.arange(M, dtype=I32, device=dev)
    lane = torch.arange(B, dtype=I32, device=dev)[:, None]
    off_n, off_m = lane * N, lane * M   # [B, 1]: lane-local ids -> flat ids

    # --- vertices: stable compaction by block ------------------------------
    blk = torch.where(ar_n < g.n[:, None], part[:, :N].to(I32), k)       # [B, N]
    keys, order = torch.sort(blk, dim=1, stable=True)
    order32 = order.to(I32)
    voff = _sorted_offsets(keys, k)[:, : k + 1]                          # exclusive prefix
    counts = voff[:, 1:] - voff[:, :-1]                                  # [B, k]
    rank = ar_n - voff.gather(1, keys.long())
    relabel = torch.empty(B, N, dtype=I32, device=dev)
    relabel.scatter_(1, order, rank)                                     # parent -> child id
    vsrc = voff[:, :k, None] + ar_n                                      # [B, k, N]
    v_ok = (ar_n < counts[:, :, None]).view(B * k, N)
    vids = order32.view(-1)[vsrc.clamp(0, N - 1) + off_n[:, :, None]]   # lane-local
    vids = (vids + off_n[:, :, None]).view(B * k, N)                     # into the flat lanes
    cvwgt = torch.where(v_ok, kops.gather_rows(g.vwgt.reshape(-1), vids), 0.0)
    corig = torch.where(v_ok, kops.gather_rows(orig.reshape(-1).to(I32), vids), sentinel)

    # --- edges: keep intra-block, relabel endpoints ------------------------
    emask = ar_m < g.m[:, None]     # padding anchors (N-1) may alias a real vertex
    bu = blk.view(-1)[g.rows.clamp(0, N - 1) + off_n]
    bv = blk.view(-1)[g.cols.clamp(0, N - 1) + off_n]
    eb = torch.where(emask & (bu == bv) & (bu < k), bu, k)               # [B, M]
    ekeys, eorder = torch.sort(eb, dim=1, stable=True)
    eoff = _sorted_offsets(ekeys, k)[:, : k + 1]
    ecounts = eoff[:, 1:] - eoff[:, :-1]
    esrc = eoff[:, :k, None] + ar_m
    e_ok = (ar_m < ecounts[:, :, None]).view(B * k, M)
    eids = eorder.to(I32).view(-1)[esrc.clamp(0, M - 1) + off_m[:, :, None]]
    eids = (eids + off_m[:, :, None]).view(B * k, M)
    crows = torch.where(e_ok, kops.gather_rows(relabel.view(-1)[g.rows + off_n].view(-1),
                                               eids), N - 1)
    ccols = torch.where(e_ok, kops.gather_rows(relabel.view(-1)[g.cols + off_n].view(-1),
                                               eids), N - 1)
    cewgt = torch.where(e_ok, kops.gather_rows(g.ewgt.reshape(-1), eids), 0.0)

    # --- exact per-child CSR prefix (matches padded_csr_indptr) ------------
    # child rows are sorted and their padding (N-1) sorts last, so the
    # prefix at row r < N is the count of entries < r; the last is m.
    ecounts = ecounts.reshape(-1)
    probe = ar_n[None, :].expand(B * k, N).contiguous()
    cindptr = torch.cat([torch.searchsorted(crows, probe, out_int32=True),
                         ecounts[:, None]], dim=1)

    wsum = label_sums(blk, g.vwgt, k).reshape(-1)
    children = Graph(vwgt=cvwgt, rows=crows, cols=ccols, ewgt=cewgt,
                     indptr=cindptr, n=counts.reshape(-1), m=ecounts)
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
    their first ``deg`` CSR neighbours and are flagged in ``overflow``. The
    lanes of a batch give ``[B, N, deg]`` and ``[B, N]`` (ids lane-local).

    Each edge's slot is ``index - indptr[row]`` (sorted-``rows``
    invariant); truncated and padding edges write to a trash slot.
    """
    gb, single = as_lanes(g)
    B, N, M = gb.n.shape[0], gb.N, gb.M
    dev = gb.device
    idx = torch.arange(M, dtype=I32, device=dev)
    emask = idx < gb.m[:, None]
    r = gb.rows.clamp(0, N - 1)
    pos = idx - gb.indptr.gather(1, r.long())
    valid = emask & (pos >= 0) & (pos < deg)
    slot = torch.where(valid, lane_offsets(B, N * deg, dev) + r.long() * deg + pos,
                       B * N * deg)
    adj = torch.full((B * N * deg + 1,), N, dtype=I32, device=dev)
    adj[slot] = torch.where(valid, gb.cols, N)
    adw = torch.zeros(B * N * deg + 1, dtype=gb.ewgt.dtype, device=dev)
    adw[slot] = torch.where(valid, gb.ewgt, 0.0)
    overflow = (gb.indptr[:, 1:] - gb.indptr[:, :-1]) > deg
    adj, adw = adj[:-1].view(B, N, deg), adw[:-1].view(B, N, deg)
    if single:
        return adj[0], adw[0], overflow[0]
    return adj, adw, overflow
