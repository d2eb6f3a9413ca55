"""Plain PyTorch versions of the kernels (the correctness references).

Each function computes exactly what its CUDA kernel computes. The kernel
wrappers in ``kernels/ops.py`` run these for tensors on the CPU; the tests
hold them against the JAX package, and ``chip_smoke.py`` holds each kernel
against them on the card.
"""
from __future__ import annotations

import torch

_F32_MIDPOINT_MASK = (1 << 29) - 1   # f64 mantissa bits below an f32 ulp
_F32_MIDPOINT = 1 << 28              # ... set to exactly half an f32 ulp


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 with ONE rounding, as a fused multiply-add.

    XLA's CPU compiler fuses ``a * b + c`` into an FMA under ``jit``, so the
    reference rounds once where a separate multiply and add round twice.
    In float64 the product of two float32 values is exact; the sum is then
    rounded to float64 and again to float32. That double rounding differs
    from a single one only when the float64 sum lands exactly halfway
    between two float32 values while the sum itself was inexact: there the
    value is moved one float64 ulp toward the true sum (the sign of the
    TwoSum residual) before the final rounding.
    """
    c64 = c.double()
    p = a.double() * b.double()          # exact: 24 + 24 bits < 53
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)    # TwoSum: s + err == p + c exactly
    bits = s.view(torch.int64)
    half = (bits & _F32_MIDPOINT_MASK) == _F32_MIDPOINT
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(half & (err != 0), torch.nextafter(s, toward), s)
    return s.float()


def mapcost_ref(rows, cols, ewgt, pe_of, g_below, dvec) -> torch.Tensor:
    """J(C,D,Pi): sum over directed edges of w * dist(pe_u, pe_v), halved."""
    N = pe_of.shape[0]
    pu = pe_of[rows.clamp(0, N - 1)]
    pv = pe_of[cols.clamp(0, N - 1)]
    diff = (pu[:, None] // g_below[None, :]) != (pv[:, None] // g_below[None, :])
    lvl = diff.sum(dim=-1, dtype=torch.int32)
    safe = (lvl - 1).clamp(0, dvec.shape[0] - 1)
    d = torch.where(lvl > 0, dvec[safe], torch.zeros((), dtype=dvec.dtype,
                                                      device=dvec.device))
    return torch.sum(ewgt * d) / 2.0


def gather_rows_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[k, L] gather of a 1-D source: out[b, j] = src[clip(idx[b, j])]."""
    return src[idx.clamp(0, src.shape[0] - 1)]


def hem_row_scan(adj, adw, jit, matched, u, n_ids: int) -> torch.Tensor:
    """Per-row heaviest-free-neighbour scan (the HEM proposal step).

    ``adj``/``adw``/``jit`` are ``[..., T, DEG]`` rows of the padded ELL
    adjacency (neighbour id ``n_ids`` = padding), ``matched`` a ``[..., Nm]``
    0/1 i32 vector with the same leading axes (a row gathers only from its
    own lane's), ``u`` the ``[T]`` row ids. Returns the ``[..., T]`` i32
    proposal per row (``n_ids`` = none). The score ``adw * (1 + jj) + jj``
    is rounded once, as the reference's fused form (see :func:`fma_f32`).
    """
    Nm = matched.shape[-1]
    lead = adj.shape[:-2]
    nbr_matched = matched.gather(-1, adj.clamp(0, Nm - 1).long().reshape(*lead, -1))
    nbr_matched = nbr_matched.view(adj.shape)
    own_matched = matched[..., u.clamp(0, Nm - 1).long()]
    valid = ((adj < n_ids) & (adj != u[:, None])
             & (own_matched[..., None] == 0) & (nbr_matched == 0))
    jj = jit * torch.tensor(1e-3, dtype=torch.float32, device=jit.device)
    score = torch.where(valid, fma_f32(adw, 1.0 + jj, jj),
                        torch.full_like(adw, float("-inf")))
    best = score.max(dim=-1).values
    has = best > float("-inf")
    cand = torch.where(valid & (score == best[..., None]), adj,
                       torch.full_like(adj, n_ids))
    prop = cand.min(dim=-1).values
    return torch.where(has, prop, torch.full_like(prop, n_ids)).to(torch.int32)


def hem_propose_ref(adj, adw, jit, matched) -> torch.Tensor:
    """Plain version of the hem_propose kernel: the row scan over all rows,
    of one graph (``adj`` [N, DEG], ``matched`` [N]) or of every lane of a
    batch (``adj`` [B, N, DEG], ``matched`` [B, N]; ids lane-local)."""
    u = torch.arange(adj.shape[-2], dtype=torch.int32, device=adj.device)
    return hem_row_scan(adj, adw, jit, matched, u, adj.shape[-2])


def merge_dedup_rows(cand, candw, sent: int):
    """Per-row merge/dedup/accumulate (the contraction step).

    ``cand [T, D2]`` holds coarse neighbour ids (``sent`` = empty slot,
    weight 0); returns ``(nbr [T, D2], w [T, D2], cnt [T])`` where ``nbr``
    keeps each distinct id at its FIRST slot (others ``sent``), ``w`` the
    id's weight total and ``cnt`` the distinct count per row. Totals are a
    FIXED chain of ``D2`` adds in slot order, the reference's order.
    """
    D2 = cand.shape[-1]
    zero = torch.zeros((), dtype=candw.dtype, device=candw.device)
    acc = torch.zeros_like(candw)
    for i in range(D2):
        acc = acc + torch.where(cand == cand[:, i:i + 1], candw[:, i:i + 1], zero)
    firstpos = torch.full_like(cand, D2)
    for i in range(D2 - 1, -1, -1):
        firstpos = torch.where(cand == cand[:, i:i + 1],
                               torch.full_like(cand, i), firstpos)
    colid = torch.arange(D2, dtype=cand.dtype, device=cand.device)[None, :]
    is_first = (firstpos == colid) & (cand != sent)
    nbr = torch.where(is_first, cand, torch.full_like(cand, sent)).to(torch.int32)
    w = torch.where(is_first, acc, zero)
    cnt = is_first.sum(dim=1, dtype=torch.int32)
    return nbr, w, cnt


def contract_edges_ref(cand, candw, sent: int):
    """Plain version of the contract_edges kernel; ``cand`` [T, D2], or
    [B, N, D2] for the lanes of a batch (their rows merged as T = B * N)."""
    if cand.dim() == 3:
        nbr, w, cnt = merge_dedup_rows(cand.reshape(-1, cand.shape[-1]),
                                       candw.reshape(-1, cand.shape[-1]), sent)
        return nbr.view(cand.shape), w.view(cand.shape), cnt.view(cand.shape[:2])
    return merge_dedup_rows(cand, candw, sent)


def lp_gain_ref(adj, adw, part, k: int):
    """Per-vertex block connectivity, best other block and its gain.

    ``adj``/``adw`` are the padded ELL adjacency ``[N, DEG]`` (neighbour id
    ``>= N`` = padding), ``part`` the block of each vertex, ``[N]`` or
    ``[R, N]`` (one row per restart). Returns ``(conn [R, N, k], best
    [R, N] i32, gain [R, N])``, without the ``R`` axis for an ``[N]``
    ``part``. The lanes of a batch take ``adj``/``adw`` ``[B, N, DEG]`` and
    ``part`` ``[B, R, N]`` and give ``[B, R, ...]``; ids stay lane-local, so
    a row of lane b gathers only lane b's labels. ``conn[r, u, b]`` sums
    ``adw[u, j]`` over the slots whose neighbour is in block ``b``, in slot
    order ``j = 0 .. DEG-1`` (the kernel's order); padding slots are
    skipped, as the TPU kernel's body skips them. ``best`` is the first
    block of largest connectivity other than the vertex's own, ``gain``
    that connectivity minus the own block's.
    """
    lanes = adj.dim() == 3
    adjb, adwb = (adj, adw) if lanes else (adj[None], adw[None])
    parts = part if lanes else (part[None] if part.dim() == 1 else part)[None]
    B, R = parts.shape[:2]
    N, DEG = adjb.shape[1:]
    ids = adjb.clamp(0, N - 1).long().reshape(B, 1, N * DEG).expand(B, R, N * DEG)
    nbr = torch.where(adjb[:, None] < N, parts.gather(2, ids).view(B, R, N, DEG),
                      torch.full_like(adjb[:, None], k)).long()   # [B, R, N, DEG], pad -> k
    w = adwb[:, None].expand(B, R, N, DEG)
    conn = torch.zeros(B, R, N, k + 1, dtype=adw.dtype, device=adw.device)
    for j in range(DEG):
        conn.scatter_add_(3, nbr[..., j:j + 1], w[..., j:j + 1])
    conn = conn[..., :k].contiguous()
    own = torch.nn.functional.one_hot(parts.long(), k).bool()
    cur = conn.gather(3, parts.long()[..., None])[..., 0]
    masked = torch.where(own, torch.full_like(conn, float("-inf")), conn)
    best = torch.argmax(masked, dim=-1).to(torch.int32)
    gain = masked.max(dim=-1).values - cur
    if lanes:
        return conn, best, gain
    if part.dim() == 1:
        return conn[0, 0], best[0, 0], gain[0, 0]
    return conn[0], best[0], gain[0]


def csr_to_ell(rows, cols, ewgt, N: int, DEG: int):
    """Directed CSR edge arrays -> padded ELL ``(adj [N, DEG], adw [N, DEG])``.

    Edges beyond DEG per row are dropped (callers choose DEG >= the
    largest degree); padding slots hold neighbour id N and weight 0.
    Edges keep their order within a row (stable sort by row).
    """
    dev = rows.device
    order = torch.argsort(rows, stable=True)
    r, c, w = rows[order], cols[order], ewgt[order]
    M = r.shape[0]
    rc = r.clamp(0, N - 1).long()
    counts = torch.zeros(N, dtype=torch.int64, device=dev).index_add_(
        0, rc, torch.ones(M, dtype=torch.int64, device=dev))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(M, device=dev) - starts[rc]
    valid = (pos < DEG) & (r < N)
    slot = torch.where(valid, rc * DEG + pos, N * DEG)   # dropped -> trash slot
    adj = torch.full((N * DEG + 1,), N, dtype=torch.int32, device=dev)
    adj[slot] = c.to(torch.int32)
    adw = torch.zeros(N * DEG + 1, dtype=w.dtype, device=dev)
    adw[slot] = torch.where(valid, w, torch.zeros((), dtype=w.dtype, device=dev))
    return adj[:-1].view(N, DEG), adw[:-1].view(N, DEG)


def flash_ref(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain SDPA for the flash kernel. q/k/v [BH, S, D] -> [BH, S, D].

    Computes in f32 and returns the input dtype, like the reference's
    ``flash_ref``; masked logits are -1e30, so a kept entry always wins.
    """
    S = q.shape[1]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= rows - cols < window
    s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_bshd_ref(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version of the flash kernel's interface: q [B, S, H, D] and
    k/v [B, S, Hkv, D] -> o [B, S, H, D]. GQA is expanded as the
    reference's ``jnp.repeat`` (query head h reads KV head h // rep), the
    heads flattened to [B*H, S, D] for ``flash_ref``."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    def flat(x):
        return x.transpose(1, 2).reshape(B * H, S, D)
    o = flash_ref(flat(q), flat(k), flat(v), causal, window)
    return o.reshape(B, H, S, D).transpose(1, 2)
