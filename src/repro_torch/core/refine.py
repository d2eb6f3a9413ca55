"""Refinement: balance-constrained label propagation (parallel FM analogue).

Per round, every vertex computes its connectivity to all k blocks in one
sparse pass, proposes the best positive-gain move that respects capacity,
and an admission filter caps inflow per target block at its remaining
capacity. A hash-colouring alternation damps oscillation. ``rebalance``
repairs over-capacity blocks at minimal edge-cut loss.

Backends, as in the reference, selected per call with ``backend=``:

* ``"xla"``: connectivity by a scatter-sum over the edges, admission by a
  global stable argsort and a per-block capacity prefix.
* ``"ell"``: the CSR arrays are laid out once per call as the padded
  ``[N, DEG]`` ELL adjacency (``graph.ell_adjacency``) and each round's
  connectivity comes from ``kernels.ops.lp_gain`` (the CUDA kernel on the
  card, its plain version on the CPU). Admission is per-block gain-threshold
  bisection (:func:`_admit_by_threshold`), with ties split by a per-vertex
  hash jitter. Rows of degree above DEG have truncated connectivity:
  ``lp_refine`` freezes them, ``rebalance`` keeps them movable.
* ``"auto"``: ``"ell"`` on a CUDA device and ``"xla"`` on the CPU: the
  reference picks ``"ell"`` wherever its kernels are live, and the port's
  kernels are live exactly on the card.

Sums of float weights by label go through ``graph.label_sums`` and
``graph.row_label_sums``, whose order is fixed on the card too (no
atomics). They are exact, and equal to the reference's, while all weights
are integers below 2^24; with other float weights the card's block sums
may round apart from the CPU's (ROADMAP.md, Queue 3), but two runs on one
device agree.
"""
from __future__ import annotations

import torch

from .graph import (F32, I32, Graph, block_weights, default_ell_deg,
                    ell_adjacency, label_sums, row_label_sums, vertex_mask)
from ..kernels import ops as kops

_NEG = -1e30
_THRESHOLD_ITERS = 24   # bisection resolution: max_gain * 2^-24
_TIE_JITTER = 1e-3      # relative per-vertex jitter splitting gain ties
_MASK32 = 0xFFFFFFFF


def _u32(x: int) -> int:
    return x & _MASK32


def _vhash(n: int, salt: int, device) -> torch.Tensor:
    """The reference's uint32 vertex hash, computed in i64 masked to 32 bits
    (torch on the CPU has no uint32 shift). Values in [0, 2^32) as i64."""
    s = _u32(_u32(salt) * 0x9E3779B9)
    x = torch.arange(n, dtype=torch.int64, device=device)
    x = ((x * 2654435761) & _MASK32) ^ s
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _MASK32
    return x ^ (x >> 12)


def _vhashes(n: int, salts: list[int], device) -> torch.Tensor:
    """[R, n]: one :func:`_vhash` row per restart salt."""
    return torch.stack([_vhash(n, s, device) for s in salts])


def _batched(part: torch.Tensor, salt) -> tuple[torch.Tensor, list[int]]:
    """``part`` as [R, N] and ``salt`` as R salts: the restarts of one
    partition call run as a leading batch dimension (the reference's
    ``vmap``); a single [N] labelling is the case R = 1."""
    if part.dim() == 1:
        return part[None], [int(salt)]
    return part, [int(x) for x in salt]


def resolve_backend(backend: str, device) -> str:
    """``"auto"`` is ``"ell"`` on a CUDA device, where the kernels are
    live, and ``"xla"`` on the CPU; ``"ell"`` and ``"xla"`` stand."""
    if backend == "auto":
        return "ell" if torch.device(device).type == "cuda" else "xla"
    if backend not in ("ell", "xla"):
        raise ValueError(f"unknown refine backend {backend!r}")
    return backend


def connectivity(g: Graph, part: torch.Tensor, k: int) -> torch.Tensor:
    """conn[r, u, b] = summed weight of edges from u into block b under the
    labelling ``part[r]``, added in edge order.  [R, N, k] for ``part``
    [R, N]. Padding edges lie past the last CSR row and add nothing."""
    return row_label_sums(g, part[:, g.cols], g.ewgt, k)


def _make_conn_of(g: Graph, k: int, backend: str, ell_deg: int | None):
    """Per-round connectivity for the resolved backend: ``(conn_of,
    overflow)``, with ``conn_of(parts [R, N]) -> [R, N, k]``.

    ``"ell"`` builds the padded [N, DEG] adjacency once per call and reads
    only ``conn`` from ``kernels.ops.lp_gain`` (best and gain are recomputed
    under the caller's capacity mask). Rows flagged in ``overflow`` carry
    truncated connectivity; the caller chooses the policy. ``ell_deg`` is
    the degree cap (``default_ell_deg(N, M)`` of the padded shapes when
    None).
    """
    if backend != "ell":
        return (lambda parts: connectivity(g, parts, k)), torch.zeros(
            g.N, dtype=torch.bool, device=g.device)
    deg = ell_deg if ell_deg is not None else default_ell_deg(g.N, g.M)
    adj, adw, overflow = ell_adjacency(g, deg)
    return (lambda parts: kops.lp_gain(adj, adw, parts, k)[0]), overflow


def batched_block_weights(g: Graph, part: torch.Tensor, k: int) -> torch.Tensor:
    """[R, k] :func:`block_weights` of each labelling ``part`` [R, N]."""
    return label_sums(torch.where(vertex_mask(g), part, 0), g.vwgt, k)


def _pick(mat: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """mat[r, i, col[r, i]] for ``mat`` [R, N, k] (take_along_axis)."""
    return mat.gather(-1, col.long()[..., None])[..., 0]


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[r, idx[r, i]] for a per-row table [R, k] and ids [R, N]."""
    return table.gather(1, idx.long())


def _block_prefix(idx: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """[R, N] running weight of each entry's own block along each row,
    ``cumsum(one_hot(idx, k) * w[..., None], axis=-2)[..., i, idx[i]]``.
    The scan runs along the last axis of an [R, k, N] tensor: along the
    N axis of [N, k] the card scans each of the k columns with one thread."""
    blocks = torch.arange(k, dtype=idx.dtype, device=idx.device)[:, None]
    cum = torch.cumsum(torch.where(idx[:, None, :] == blocks, w[:, None, :], 0.0), dim=-1)
    return cum.gather(1, idx.long()[:, None, :])[:, 0, :]


def _admit_by_argsort(cand, best, gbest, vw, cap, k: int) -> torch.Tensor:
    """The global gain-ranked capacity prefix (xla backend), per row of the
    [R, N] inputs; ``cap`` is [R, k]."""
    inf = torch.full_like(gbest, float("inf"))
    order = torch.argsort(torch.where(cand, -gbest, inf), dim=-1, stable=True)
    tgt_s = best.gather(1, order)
    cand_s = cand.gather(1, order)
    w_s = torch.where(cand_s, vw[order], 0.0)
    ok_s = cand_s & (_block_prefix(tgt_s, w_s, k) <= _lookup(cap.clamp(min=0.0), tgt_s))
    return torch.zeros_like(cand).scatter_(1, order, ok_s)


def _admit_by_threshold(cand, best, gbest, vw, cap, k: int, tiebreak,
                        iters: int = _THRESHOLD_ITERS) -> torch.Tensor:
    """Per-block gain-threshold admission (the ell backend), per row of the
    [R, N] inputs; ``cap`` is [R, k], ``tiebreak`` [R, N] in [0, 1).

    For each target block b, bisect the smallest threshold t_b such that
    the weight of candidates with ``gbest >= t_b`` targeting b fits in
    ``cap[b]``, and admit exactly those. The invariant ``inflow(hi) <= cap``
    holds throughout, so the admitted set respects capacity. Each gain is
    raised by a relative ``_TIE_JITTER * tiebreak`` so that an equal-gain
    group is admitted in part (in hash order), not all or nothing.

    The inflow sums are label sums into [R, k] in which the entries not
    admitted at a threshold carry no label: each block's sum has the same
    addends in the same order as a masked sum. Non-candidates carry a gain
    of -inf, so no threshold (all are >= 0) admits them.
    """
    R, N = cand.shape
    dev = cand.device
    gbest = gbest * (1.0 + _TIE_JITTER * tiebreak)
    safe_best = torch.where(cand, best, 0).long()
    gcand = torch.where(cand, gbest, float("-inf"))
    w_cand = torch.where(cand, vw, 0.0)
    cap = cap.clamp(min=0.0)

    def inflow(t):
        return label_sums(torch.where(gcand >= t.gather(1, safe_best), safe_best, -1),
                          w_cand, k)

    hi0 = torch.where(cand, gbest, 0.0).max(dim=1).values + 1.0
    lo = torch.zeros(R, k, dtype=F32, device=dev)
    hi = hi0[:, None].expand(R, k).contiguous()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = inflow(mid) <= cap
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    t = torch.where(inflow(torch.zeros_like(lo)) <= cap, 0.0, hi)
    return gcand >= t.gather(1, safe_best)


def lp_refine(g: Graph, part: torch.Tensor, k: int, Lmax: torch.Tensor,
              rounds: int = 4, salt=0, backend: str = "auto",
              ell_deg: int | None = None) -> torch.Tensor:
    """Gain-positive, capacity-respecting label propagation refinement.
    ``part`` is one [N] labelling, or [R, N] with one salt per row.

    Under ``"ell"``, rows of degree above the cap are frozen: a truncated
    gain estimate could otherwise admit a move that worsens the cut (their
    neighbours still see them through their own rows)."""
    backend = resolve_backend(backend, g.device)
    parts, salts = _batched(part, salt)
    vmask = vertex_mask(g)
    h = _vhashes(g.N, salts, g.device)
    conn_of, overflow = _make_conn_of(g, k, backend, ell_deg)
    movable = vmask & ~overflow
    if backend == "ell":
        tiebreak = (h & 0xFFFF).to(F32) / float(1 << 16)
    for r in range(rounds):
        conn = conn_of(parts)
        W = batched_block_weights(g, parts, k)
        gain = conn - _pick(conn, parts)[..., None]
        own = torch.nn.functional.one_hot(parts.long(), k).bool()
        fits = (W[:, None, :] + g.vwgt[None, :, None]) <= Lmax
        cand_gain = torch.where(fits & ~own, gain, _NEG)
        best = torch.argmax(cand_gain, dim=-1).to(I32)
        gbest = cand_gain.max(dim=-1).values
        color = ((h + r) & 1) == 0
        cand = movable & (gbest > 0.0) & color
        if backend == "ell":
            accept = _admit_by_threshold(cand, best, gbest, g.vwgt, Lmax - W, k, tiebreak)
        else:
            accept = _admit_by_argsort(cand, best, gbest, g.vwgt, Lmax - W, k)
        parts = torch.where(accept, best, parts)
    return parts if part.dim() == 2 else parts[0]


def rebalance(g: Graph, part: torch.Tensor, k: int, Lmax: torch.Tensor,
              rounds: int = 8, salt=1, backend: str = "auto",
              ell_deg: int | None = None) -> torch.Tensor:
    """Force epsilon-balance: drain over-capacity blocks via min-loss moves
    (``salt`` is unused, as in the reference). ``part`` is one [N]
    labelling or [R, N]. Under ``"ell"`` rows over the degree cap stay
    movable on truncated connectivity: feasibility rests on the exact
    weight bookkeeping, and only their min-loss order is approximate."""
    backend = resolve_backend(backend, g.device)
    parts = part if part.dim() == 2 else part[None]
    vmask = vertex_mask(g)
    conn_of, _ = _make_conn_of(g, k, backend, ell_deg)
    for _ in range(rounds):
        conn = conn_of(parts)
        W = batched_block_weights(g, parts, k)
        overflow_w = (W - Lmax).clamp(min=0.0)
        loss = _pick(conn, parts)[..., None] - conn
        own = torch.nn.functional.one_hot(parts.long(), k).bool()
        fits = (W[:, None, :] + g.vwgt[None, :, None]) <= Lmax
        cand_loss = torch.where(fits & ~own, loss, float("inf"))
        tgt = torch.argmin(cand_loss, dim=-1).to(I32)
        lbest = cand_loss.min(dim=-1).values
        src_over = _lookup(overflow_w, parts) > 0.0
        cand = vmask & src_over & torch.isfinite(lbest) & (g.vwgt > 0.0)
        order = torch.argsort(torch.where(cand, lbest, float("inf")), dim=-1, stable=True)
        src_s = parts.gather(1, order)
        tgt_s = tgt.gather(1, order)
        cand_s = cand.gather(1, order)
        w_s = torch.where(cand_s, g.vwgt[order], 0.0)
        # drain only what is needed (allow the boundary-crossing move), fill
        # targets only up to capacity.
        out_ok = (_block_prefix(src_s, w_s, k) - w_s) < _lookup(overflow_w, src_s)
        in_ok = _block_prefix(tgt_s, w_s, k) <= _lookup((Lmax - W).clamp(min=0.0), tgt_s)
        accept = torch.zeros_like(cand).scatter_(1, order, cand_s & out_ok & in_ok)
        parts = torch.where(accept, tgt, parts)
    return parts if part.dim() == 2 else parts[0]


def is_balanced(g: Graph, part: torch.Tensor, k: int, Lmax) -> bool:
    return bool(torch.all(block_weights(g, part, k) <= Lmax + 1e-6))
