"""GQA attention: prefill (full, sliding-window, cross) and decode paths.

The port of ``repro/models/attention.py``. Activations keep the
reference's ``[B, S, H, Dh]`` layout. With ``ctx.use_flash`` the prefill
runs the flash kernel (``kernels/ops.py:flash_attention``); otherwise
``_sdpa`` materialises the masked logits, as the reference's dense path
does. Every product with a weight is ``sharding.dense``: under a mesh its
operands' placements are pinned, so torch's release does not change the
plan. Under a mesh (DTensor activations) attention, and the flash kernel,
run on each rank's share (``_on_rank_share``): the model ranks of a data
shard split its heads where they divide the model axis, else its (batch
row, kv group) units. ``ctx.attn_seq_shard`` on ``_sdpa`` instead shards q
over the query sequence and replicates k/v, as the reference constrains
them. A decode KV cache sharded over its sequence (where the kv heads do
not divide the model axis) is attended on its local shards, the softmax's
statistics reduced over the shards (``_decode_seq_sharded``).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch import nn

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import apply_rope, dense_init, full_param, rope_angles
from .sharding import dense, split_ready

NEG = -1e30


def attn_params(cfg: ModelConfig, generator=None, device=None) -> nn.ParameterDict:
    D, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": dense_init(generator, (D, qd), device=device),
        "wk": dense_init(generator, (D, kvd), device=device),
        "wv": dense_init(generator, (D, kvd), device=device),
        "wo": dense_init(generator, (qd, D), device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = full_param((qd,), 0.0, generator, device)
        p["bk"] = full_param((kvd,), 0.0, generator, device)
        p["bv"] = full_param((kvd,), 0.0, generator, device)
    return nn.ParameterDict(p)


def _project_qkv(cfg: ModelConfig, p, x):
    """q [B,S,q_dim], k/v [B,S,kv_dim] (``sharding.dense``: under a mesh
    column-parallel, each rank's columns)."""
    q = dense(x, p["wq"], p["bq"] if cfg.qkv_bias else None)
    k = dense(x, p["wk"], p["bk"] if cfg.qkv_bias else None)
    v = dense(x, p["wv"], p["bv"] if cfg.qkv_bias else None)
    return q, k, v


def _heads(cfg: ModelConfig, q, k, v):
    """q/k/v as projected, split into heads ``[B,S,H|Hkv,Dh]`` (a DTensor
    whose column shards do not hold whole heads is gathered first)."""
    B, S = q.shape[:2]
    return (split_ready(q, -1, cfg.num_heads).reshape(B, S, cfg.num_heads, cfg.head_dim),
            *(split_ready(t, -1, cfg.num_kv_heads).reshape(B, t.shape[1], cfg.num_kv_heads,
                                                           cfg.head_dim) for t in (k, v)))


def _expand_kv(cfg: ModelConfig, k):
    """[B,S,Hkv,Dh] -> [B,S,H,Dh] by repeating each kv head (``jnp.repeat``:
    query head h reads kv head h // rep)."""
    rep = cfg.num_heads // cfg.num_kv_heads
    if rep == 1:
        return k
    return k.repeat_interleave(rep, dim=2)


def _sdpa(q, k, v, mask, bf16: bool = False):
    """q [B,Sq,H,Dh], k/v [B,Sk,H,Dh], mask [1|B, Sq, Sk] bool (True=keep).

    ``bf16``: QK^T and its scale in the compute dtype, upcast only for the
    softmax (the scale is rounded to that dtype first, as in the reference)."""
    scale = q.shape[-1] ** -0.5
    if bf16:
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k)
                  * torch.tensor(scale, dtype=q.dtype, device=q.device)).float()
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = torch.where(mask[:, None, :, :], logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def self_attention(cfg: ModelConfig, p, x, *, causal: bool, positions=None,
                   bf16: bool = False, ctx=None):
    """Prefill self-attention: [B,S,D] -> [B,S,D]. (The reference also
    returns its k/v; nothing of the port reads them, and under a mesh the
    share path never forms them in that layout.)"""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    rope = None
    if cfg.rope_theta > 0:
        rope = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        if bf16:  # angles stay f32; rotation runs in compute dtype
            rope = tuple(t.to(x.dtype) for t in rope)
    if ctx is not None and ctx.use_flash:
        mask = ()
        attend = functools.partial(_flash, cfg, causal)
    else:
        iq = torch.arange(S, device=x.device)[:, None]
        ik = torch.arange(S, device=x.device)[None, :]
        m = torch.ones(1, S, S, dtype=torch.bool, device=x.device)
        if causal:
            m = m & (ik <= iq)[None]
        if cfg.sliding_window > 0:
            m = m & (iq - ik < cfg.sliding_window)[None]
        mask = (m,)
        attend = functools.partial(_gqa_sdpa, cfg, bf16)
    if _shares(ctx, q):
        return dense(_on_rank_share(cfg, ctx, attend, q, k, v, *mask, rope=rope), p["wo"])
    q, k, v = _heads(cfg, q, k, v)
    if ctx is not None and ctx.attn_seq_shard:
        # context parallelism: logits [B,H,Sq/|model|,Sk]; softmax is local
        # to each shard, k/v are gathered once per layer
        from .sharding import batch_spec
        bs = batch_spec(ctx)
        q = ctx.constrain(q, bs, "model", None, None)
        k = ctx.constrain(k, bs, None, None, None)
        v = ctx.constrain(v, bs, None, None, None)
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    out = attend(q, k, v, *mask)
    return dense(out.reshape(B, S, cfg.q_dim), p["wo"])


def _flash(cfg: ModelConfig, causal: bool, q, k, v):
    """The flash kernel on q ``[B,S,H,Dh]``, k/v ``[B,S,Hkv,Dh]``."""
    return kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, window=cfg.sliding_window)


def _gqa_sdpa(cfg: ModelConfig, bf16: bool, q, k, v, mask):
    """``_sdpa`` on q ``[B,Sq,H,Dh]``, k/v ``[B,Sk,Hkv,Dh]``."""
    return _sdpa(q, _expand_kv(cfg, k), _expand_kv(cfg, v), mask, bf16=bf16)


def _shares(ctx, q) -> bool:
    """Whether attention runs on each rank's share (``_on_rank_share``):
    under a mesh on DTensors, unless it is context-parallel
    (``attn_seq_shard``) on ``_sdpa``."""
    from .sharding import is_dtensor
    return (ctx is not None and ctx.mesh is not None and is_dtensor(q)
            and (ctx.use_flash or not ctx.attn_seq_shard))


def _on_rank_share(cfg: ModelConfig, ctx, fn, q, k, v, *rest, rope=None):
    """``fn(q, k, v, *rest)`` (local ``[b, s, h, Dh]`` q/k/v -> out like q)
    on this rank's share of the attention (``_rank_share``, through
    ``sharding.run_local``), so that the model ranks of a data shard split
    its work, as the reference's SPMD program does; ``rest`` are plain
    tensors (masks), ``rope`` the (cos, sin) to rotate q and k by once
    they are in the share's layout.

    q/k/v come as projected, ``[B, S, C]`` with their columns sharded over
    the model axis, or (decode) in heads ``[B, S, H|Hkv, Dh]``, the heads
    sharded over the model axis or replicated. The result is ``[B, S,
    q_dim]``, its columns sharded over the model axis, ready for ``wo``."""
    from torch.distributed.tensor import Partial

    from .sharding import all_to_all, batch_spec, mesh_coord, run_local, spec_placements
    mesh, bs, maxis = ctx.mesh, batch_spec(ctx), ctx.model_axis
    mdim = mesh.mesh_dim_names.index(maxis)
    M, m = mesh.size(mdim), mesh_coord(mesh, maxis)
    whole = _whole_heads(cfg, M)
    kinds, pls, grad_pls = [], [], []
    for t in (q, k, v):
        if t.ndim == 3:
            kind, spec = "cols", (bs, None, maxis)
        else:
            kind = "heads" if whole else "rep"
            spec = (bs, None, maxis if whole else None, None)
        pl = spec_placements(spec, mesh)
        kinds.append(kind)
        pls.append(pl)
        # a replicated input's units are read on one rank each: its gradient is partial
        grad_pls.append([Partial() if (i == mdim and kind == "rep") else p
                         for i, p in enumerate(pl)])

    def exchange(rows, out_splits, in_splits):
        return all_to_all(rows, mesh, mdim, out_splits, in_splits)

    def local(ql, kl, vl):
        return _drive(_rank_share(cfg, fn, ql, kl, vl, *rest, kinds=kinds, rope=rope, M=M, m=m),
                      exchange)

    return run_local(local, mesh, (q, k, v), pls, grad_pls,
                     spec_placements((bs, None, maxis), mesh), (*q.shape[:2], cfg.q_dim))


def _whole_heads(cfg: ModelConfig, M: int) -> bool:
    """Whether ``M`` model ranks split attention by whole heads (both head
    counts divide ``M``) rather than by (batch row, kv group) units."""
    return cfg.num_heads % M == 0 and cfg.num_kv_heads % M == 0


def _rank_share(cfg: ModelConfig, fn, ql, kl, vl, *rest, kinds, rope, M: int, m: int):
    """Model rank ``m`` of ``M``'s share of an attention, on its local q/k/v
    (``kinds``: ``"cols"``, the projections' column shards ``[b, S, C]``;
    ``"heads"``, its heads ``[b, S, h, Dh]``; ``"rep"``, every head
    ``[b, S, H|Hkv, Dh]``, replicated). A generator: it yields each
    all-to-all it needs over the model ranks as ``(rows, out_splits,
    in_splits)`` and is sent the rows received (``_drive`` does that on a
    mesh, ``ranks_in_turn`` for all ranks on one process); it returns the
    result's local columns ``[b, S, q_dim / M]``.

    The share: where both head counts divide ``M``, the rank's kv heads
    (and the query heads that read them) of every batch row. Otherwise the
    unit is (batch row, kv group): one kv head and the query heads that
    read it, so GQA is read in place. The ``b * Hkv`` units, batch row
    major, are split over the ranks in ``torch.chunk``'s order: unevenly
    where they do not divide ``M`` (the last ranks may hold fewer, or
    none). Where there are fewer units than ranks, ``M`` a multiple of
    them, and ``rest`` holds the masks to cut (``_sdpa``; flash takes
    queries and keys of one length), each unit goes to ``r = M / units``
    ranks, and each of them attends one ``S / r`` chunk of its queries
    (``_query_split``), so that no model rank idles. A rank's units are laid
    out as a batch of their own, q ``[u, S, H/Hkv, Dh]`` against k/v ``[u,
    S, 1, Dh]``, moved there from the column shards by one all-to-all each
    (``_unit_plan``) and back the same way. RoPE turns q and k once they
    are in that layout."""
    G, Dh = cfg.num_kv_heads, cfg.head_dim
    rep = cfg.num_heads // G
    whole = _whole_heads(cfg, M)
    Bl = ql.shape[0]
    r = 1 if whole or not rest else _query_split(Bl * G, M, ql.shape[1])

    def to_share(t, kind, heads):    # heads: query heads per kv group, or 1
        S = t.shape[1]
        if whole:
            return t.reshape(Bl, S, -1, Dh) if kind == "cols" else t
        W = heads * Dh
        if kind == "rep":
            units = t.reshape(Bl, S, G, W).permute(0, 2, 1, 3).reshape(Bl * G, S, W)
            lo, hi = _unit_range(Bl * G, M, m, r)
            return units[lo:hi].reshape(hi - lo, S, heads, Dh)
        plan = _unit_plan(Bl, G, W, M, m, r)
        rows = _col_rows(t, plan)
        if plan.send_order is not None:     # each row to the r ranks of its unit
            rows = rows.index_select(0, _index(plan.send_order, rows.device))
        rows = yield rows, plan.recv, plan.send
        return _rows_to_units(rows, plan, W, heads, Dh)

    qs = yield from to_share(ql, kinds[0], rep)
    ks = yield from to_share(kl, kinds[1], 1)
    vs = yield from to_share(vl, kinds[2], 1)
    if rope is not None:
        qs, ks = apply_rope(qs, *rope), apply_rope(ks, *rope)
    if r > 1:                               # this rank's chunk of the queries
        lo, hi = _chunk_range(qs.shape[1], r, m % r)
        qs, rest = qs[:, lo:hi], tuple(t[:, lo:hi] for t in rest)
    out = fn(qs, ks, vs, *rest) if qs.shape[0] else qs
    if whole:
        return out.reshape(Bl, out.shape[1], -1)
    plan = _unit_plan(Bl, G, rep * Dh, M, m, r)
    rows = yield _unit_rows(out, plan), plan.back_recv, plan.back_send
    return _rows_to_cols(rows, plan, Bl)


def _drive(gen, exchange):
    """Run a rank's ``_rank_share``, doing each all-to-all it yields with
    ``exchange(rows, out_splits, in_splits)``; its result."""
    try:
        ask = next(gen)
        while True:
            ask = gen.send(exchange(*ask))
    except StopIteration as stop:
        return stop.value


def ranks_in_turn(gens) -> list:
    """Every model rank's ``_rank_share`` (rank m at ``gens[m]``) run in
    lock-step on one process, each all-to-all done by hand: rank r's rows
    cut by its ``in_splits``, piece m to rank m, received in rank order.
    Their results, rank by rank. (The sharded step's own exchange is
    ``sharding.all_to_all``.)"""
    M = len(gens)

    def step(gen, rows):
        try:
            return False, gen.send(rows)
        except StopIteration as stop:
            return True, stop.value

    state = [step(g, None) for g in gens]
    while not state[0][0]:
        if any(done for done, _ in state):
            raise AssertionError("the ranks asked for different numbers of all-to-alls")
        pieces = [torch.split(rows, list(ins)) for _, (rows, _, ins) in state]
        for m, (_, (_, outs, _)) in enumerate(state):
            if [pieces[r][m].shape[0] for r in range(M)] != list(outs):
                raise AssertionError(f"rank {m} expects {outs}, is sent "
                                     f"{[pieces[r][m].shape[0] for r in range(M)]}")
        state = [step(g, torch.cat([pieces[r][m] for r in range(M)]))
                 for m, g in enumerate(gens)]
    if not all(done for done, _ in state):
        raise AssertionError("the ranks asked for different numbers of all-to-alls")
    return [value for _, value in state]


def _col_rows(t, plan):
    """A column shard ``[B, S, c]`` as the rows ``_unit_plan`` sends, in
    order: ``[B * c / atom, S, atom]``."""
    (B, S, c), a = t.shape, plan.atom
    return t.reshape(B, S, c // a, a).permute(0, 2, 1, 3).reshape(B * c // a, S, a)


def _rows_to_units(rows, plan, W: int, heads: int, Dh: int):
    """The rows received from every column shard -> the rank's units
    ``[u, S, heads, Dh]`` (``W = heads * Dh`` columns a unit)."""
    S, a = rows.shape[1], plan.atom
    rows = rows.index_select(0, _index(plan.gather, rows.device))
    n = len(plan.gather) * a // W
    return rows.reshape(n, W // a, S, a).permute(0, 2, 1, 3).reshape(n, S, heads, Dh)


def _unit_rows(out, plan):
    """The rank's units ``[u, S, h, Dh]`` as the rows sent back to the
    column shards, grouped by the shard they go to."""
    (u, S, h, Dh), a = out.shape, plan.atom
    rows = out.reshape(u, S, h * Dh // a, a).permute(0, 2, 1, 3).reshape(u * h * Dh // a, S, a)
    return rows.index_select(0, _index(plan.back_order, out.device))


def _rows_to_cols(rows, plan, B: int):
    """The rows received back from every rank's units -> the column shard
    ``[B, S, c]`` (``plan.r`` query chunks a row, in order, where units
    are split by queries)."""
    Sc, a, r = rows.shape[1], plan.atom, plan.r
    rows = rows.index_select(0, _index(plan.back_gather, rows.device))
    n = len(plan.back_gather) // (B * r)
    return rows.reshape(B, n, r * Sc, a).permute(0, 2, 1, 3).reshape(B, r * Sc, n * a)


def _index(ix: tuple, device):
    return torch.tensor(ix, dtype=torch.long, device=device)


def _chunk_range(n: int, parts: int, i: int) -> tuple[int, int]:
    """Item ``i``'s range of ``n`` items split in ``torch.chunk``'s order."""
    c = -(-n // parts)
    return min(i * c, n), min((i + 1) * c, n)


def _query_split(U: int, M: int, S: int) -> int:
    """The ranks that share one of ``U`` units, each taking a chunk of its
    ``S`` queries: ``M / U`` where there are fewer units than ``M`` ranks,
    ``M`` a multiple of them and ``S`` of the chunks; else 1."""
    r = M // U if 0 < U < M and M % U == 0 else 1
    return r if S % r == 0 else 1


def _unit_range(U: int, M: int, m: int, r: int) -> tuple[int, int]:
    """Rank ``m``'s units of ``U`` (``r`` ranks a unit, or ``torch.chunk``'s
    order over the ``M`` ranks where ``r`` is 1)."""
    return (m // r, m // r + 1) if r > 1 else _chunk_range(U, M, m)


class _UnitPlan(NamedTuple):
    atom: int           # columns moved as one piece
    r: int              # ranks a unit (each its chunk of the queries)
    send_order: tuple | None    # a source's rows -> sent, grouped by rank (r > 1)
    send: tuple         # rows sent to each model rank
    recv: tuple         # rows received from each
    gather: tuple       # received rows -> the units' rows, in order
    back_order: tuple   # the units' rows -> sent back, grouped by rank
    back_send: tuple
    back_recv: tuple
    back_gather: tuple  # rows received back -> the column shard's rows


@functools.lru_cache(maxsize=256)
def _unit_plan(B: int, G: int, W: int, M: int, m: int, r: int = 1) -> _UnitPlan:
    """Model rank ``m``'s all-to-all between a tensor's column shards
    (``G * W`` columns over ``M`` ranks in ``torch.chunk``'s order) and its
    share of the ``B * G`` units (batch row b, kv group g: columns ``[g*W,
    (g+1)*W)`` of row b, over the ranks in ``torch.chunk``'s order, or
    ``r`` ranks a unit, ``_unit_range``). A row moved is one batch row's
    ``atom`` columns (the largest width that divides every shard and group
    boundary) at every position (back: at every position of the rank's
    query chunk). A source's rows, batch row major, go to nondecreasing
    units, so where ``r`` is 1 each source sends them in its own order;
    else each row goes to the ``r`` ranks of its unit (``send_order``) and
    comes back from them in ``r`` chunks."""
    C, U = G * W, B * G
    cc, cu = -(-C // M), -(-U // M)
    atom = math.gcd(cc, W)

    def rows(s):            # (b, atom) of source s's column shard, in order
        lo, hi = _chunk_range(C, M, s)
        return [(b, j) for b in range(B) for j in range(lo // atom, hi // atom)]

    def units(d):           # rank d's rows, unit by unit
        lo, hi = _unit_range(U, M, d, r)
        return [(u // G, j) for u in range(lo, hi)
                for j in range(u % G * W // atom, (u % G + 1) * W // atom)]

    def owners(bj):         # the ranks that attend bj's unit
        u = bj[0] * G + bj[1] * atom // W
        return range(u * r, (u + 1) * r) if r > 1 else (u // cu,)

    def owner_col(bj):
        return bj[1] * atom // cc

    src, mine = [rows(s) for s in range(M)], units(m)
    order = tuple(i for d in range(M) for i, bj in enumerate(src[m]) if d in owners(bj))
    send = tuple(sum(d in owners(bj) for bj in src[m]) for d in range(M))
    recv = tuple(sum(m in owners(bj) for bj in src[s]) for s in range(M))
    at = {bj: i for i, bj in enumerate(bj for s in range(M) for bj in src[s]
                                       if m in owners(bj))}
    gather = tuple(at[bj] for bj in mine)
    # the units' rows go back grouped by column shard (a stable sort)
    back_order = tuple(sorted(range(len(mine)), key=lambda i: owner_col(mine[i])))
    back_send = tuple(sum(owner_col(bj) == d for bj in mine) for d in range(M))
    back_recv = tuple(sum(owner_col(bj) == m for bj in units(s)) for s in range(M))
    at = {sbj: i for i, sbj in enumerate((s, bj) for s in range(M)
                                         for bj in sorted(units(s), key=owner_col)
                                         if owner_col(bj) == m)}
    back_gather = tuple(at[s, bj] for bj in src[m] for s in owners(bj))
    return _UnitPlan(atom, r, order if r > 1 else None, send, recv, gather, back_order,
                     back_send, back_recv, back_gather)


def _head_spec(cfg: ModelConfig, ctx) -> tuple:
    """q/k/v ``[B, S, H, Dh]`` under a mesh: batch over the batch axes,
    heads over the model axis where both the query and the kv heads divide
    it (a rank's query heads then read its own kv heads), else replicated."""
    from .sharding import batch_spec
    heads = ctx.model_axis if _whole_heads(cfg, ctx.model_size) else None
    return (batch_spec(ctx), None, heads, None)


def decode_attention(cfg: ModelConfig, p, x, cache_k, cache_v, pos: int, ctx=None):
    """One-token decode. x [B,1,D]; cache_k/v [B, Smax, Hkv, Dh]; pos an int.

    The KV cache is a plain buffer for full attention and a ring buffer
    (index mod window) for sliding-window attention. The new k/v row is
    written into ``cache_k``/``cache_v`` IN PLACE (the reference's
    ``dynamic_update_slice`` into a donated cache), and the same tensors
    are returned. A cache sharded over its sequence dim is attended on its
    local shards (``_decode_seq_sharded``); under a mesh, any other on
    each rank's share (``_on_rank_share``).
    """
    B = x.shape[0]
    q, k_new, v_new = _heads(cfg, *_project_qkv(cfg, p, x))  # S == 1
    if ctx is not None and ctx.mesh is not None:   # whole heads, not partial sums
        q, k_new, v_new = (ctx.constrain(t, *_head_spec(cfg, ctx)) for t in (q, k_new, v_new))
    if cfg.rope_theta > 0:
        posv = torch.full((B, 1), pos, device=x.device)
        cos, sin = rope_angles(posv, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    Smax = cache_k.shape[1]
    slot = pos % Smax if cfg.sliding_window > 0 else pos
    ik = torch.arange(Smax, device=x.device)[None, :]
    if cfg.sliding_window > 0:
        # valid ring slots: the last min(pos+1, Smax) written entries
        age = (slot - ik) % Smax
        mask = (age <= min(pos, Smax - 1))[:, None, :]
    else:
        mask = (ik <= pos)[:, None, :]
    if _seq_axes(cache_k):
        out = _decode_seq_sharded(cfg, q, k_new, v_new, cache_k, cache_v, slot, mask)
    else:
        cache_k[:, slot] = k_new[:, 0]
        cache_v[:, slot] = v_new[:, 0]

        attend = functools.partial(_gqa_sdpa, cfg, False)
        if _shares(ctx, q):
            out = _on_rank_share(cfg, ctx, attend, q, cache_k, cache_v, mask)
        else:
            out = attend(q, cache_k, cache_v, mask)
    out = dense(out.reshape(B, 1, cfg.q_dim), p["wo"])
    return out, cache_k, cache_v


def _seq_axes(cache) -> list[int]:
    """The mesh dims that shard a KV cache's sequence dim (none for a plain
    tensor)."""
    from torch.distributed.tensor import Shard

    from .sharding import is_dtensor
    if not is_dtensor(cache):
        return []
    return [i for i, p in enumerate(cache.placements) if p == Shard(1)]


def _decode_seq_sharded(cfg: ModelConfig, q, k_new, v_new, cache_k, cache_v, slot: int, mask):
    """Decode attention on a KV cache whose sequence dim is sharded (the
    flash-decode layout ``cache_specs`` gives where the kv heads do not
    divide the model axis), on each rank's local shards (``local_map``):
    the rank whose slice holds ``slot`` writes the new row there in place;
    each rank takes its slice's logits, and the softmax's max and sum and
    the probabilities' weighted sum of v are reduced over the sharding
    axes. Nothing gathers the cache (the reference's XLA program gathers it
    whole in each layer; the values are the same up to the order of sums)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from .sharding import chunk_offset

    mesh, c_pl = cache_k.device_mesh, list(cache_k.placements)
    seq = _seq_axes(cache_k)
    groups = [mesh.get_group(i).group_name for i in seq]
    rest = [Replicate() if p == Shard(1) else p for p in c_pl]   # q, k/v rows [B, 1, H, Dh]
    q, k_new, v_new = (t.redistribute(mesh, rest) for t in (q, k_new, v_new))
    off = chunk_offset(mesh, seq, cache_k.shape[1])
    scale = q.shape[-1] ** -0.5

    def reduce(x, op):
        c10d = torch.ops._c10d_functional
        for g in groups:
            x = c10d.wait_tensor(c10d.all_reduce(x, op, g))
        return x

    def local(ql, kn, vn, ck, cv):
        n = ck.shape[1]
        if off <= slot < off + n:
            ck[:, slot - off] = kn[:, 0]
            cv[:, slot - off] = vn[:, 0]
        logits = torch.einsum("bqhd,bkhd->bhqk", ql, _expand_kv(cfg, ck)).float() * scale
        logits = torch.where(mask[:, None, :, off:off + n], logits, NEG)
        e = torch.exp(logits - reduce(logits.amax(-1, keepdim=True), "max"))
        probs = (e / reduce(e.sum(-1, keepdim=True), "sum")).to(ql.dtype)
        return reduce(torch.einsum("bhqk,bkhd->bqhd", probs, _expand_kv(cfg, cv)), "sum")

    return local_map(local, out_placements=(rest,), in_placements=(rest,) * 3 + (c_pl, c_pl),
                     device_mesh=mesh)(q, k_new, v_new, cache_k, cache_v)


def cross_attention(cfg: ModelConfig, p, x, memory_kv, ctx=None):
    """Decoder cross-attention against the encoder states' k/v as
    projected, ``[B,T,kv_dim]`` each (``whisper._memory_kv``)."""
    B, S, _ = x.shape
    q = dense(x, p["wq"])
    k, v = memory_kv
    mask = torch.ones(1, S, k.shape[1], dtype=torch.bool, device=x.device)
    attend = functools.partial(_gqa_sdpa, cfg, False)
    if _shares(ctx, q):
        return dense(_on_rank_share(cfg, ctx, attend, q, k, v, mask), p["wo"])
    return dense(attend(*_heads(cfg, q, k, v), mask).reshape(B, S, cfg.q_dim), p["wo"])


def decode_cross_attention(cfg: ModelConfig, p, x, memory_kv):
    """One decoder token against the cached ``[B,T,Hkv,Dh]`` memory k/v."""
    return cross_attention(cfg, p, x, tuple(t.flatten(2) for t in memory_kv))
