"""GQA attention: prefill (full, sliding-window, cross) and decode paths.

The port of ``repro/models/attention.py``. Activations keep the
reference's ``[B, S, H, Dh]`` layout. With ``ctx.use_flash`` the prefill
runs the flash kernel (``kernels/ops.py:flash_attention``); otherwise
``_sdpa`` materialises the masked logits, as the reference's dense path
does. Under a mesh (DTensor activations) ``ctx.attn_seq_shard`` shards q
over the query sequence and replicates k/v, as the reference constrains
them; attention, and the flash kernel, run on each rank's local q/k/v,
heads sharded over the model axis where they divide it
(``_on_local_heads``). A decode KV cache sharded over its sequence (where
the kv heads do not divide the model axis) is attended on its local
shards, the softmax's statistics reduced over the shards
(``_decode_seq_sharded``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import apply_rope, dense_init, full_param, rope_angles
from .sharding import split_ready

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
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = split_ready(q, -1, cfg.num_heads).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = split_ready(k, -1, cfg.num_kv_heads).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = split_ready(v, -1, cfg.num_kv_heads).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


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
    """Prefill self-attention. Returns (out [B,S,D], (k, v))."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    if ctx is not None and ctx.attn_seq_shard:
        # context parallelism: logits [B,H,Sq/|model|,Sk]; softmax is local
        # to each shard, k/v are gathered once per layer
        from .sharding import batch_spec
        bs = batch_spec(ctx)
        q = ctx.constrain(q, bs, "model", None, None)
        k = ctx.constrain(k, bs, None, None, None)
        v = ctx.constrain(v, bs, None, None, None)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if cfg.rope_theta > 0:
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        if bf16:  # angles stay f32; rotation runs in compute dtype
            cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if ctx is not None and ctx.use_flash:
        def flash(ql, kl, vl):
            return kops.flash_attention(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                                        causal=causal, window=cfg.sliding_window)
        out = flash(q, k, v) if ctx.mesh is None else _on_local_heads(cfg, ctx, flash, q, k, v)
    else:
        iq = torch.arange(S, device=x.device)[:, None]
        ik = torch.arange(S, device=x.device)[None, :]
        mask = torch.ones(1, S, S, dtype=torch.bool, device=x.device)
        if causal:
            mask = mask & (ik <= iq)[None]
        if cfg.sliding_window > 0:
            mask = mask & (iq - ik < cfg.sliding_window)[None]
        out = _attend(cfg, q, k, v, mask, bf16, ctx)
    out = out.reshape(B, S, cfg.q_dim) @ p["wo"].to(x.dtype)
    return out, (k, v)


def _attend(cfg: ModelConfig, q, k, v, mask, bf16: bool, ctx):
    """``_sdpa`` of q against the kv heads expanded; under a mesh (and not
    ``attn_seq_shard``) on each rank's local heads (``_on_local_heads``):
    DTensor would flatten the sharded (batch, head) dims of the einsum's
    batched product into one and replicate it."""
    from .sharding import is_dtensor

    def sdpa(ql, kl, vl, m):
        return _sdpa(ql, _expand_kv(cfg, kl), _expand_kv(cfg, vl), m, bf16=bf16)
    if ctx is None or ctx.mesh is None or ctx.attn_seq_shard or not is_dtensor(q):
        return sdpa(q, k, v, mask)
    return _on_local_heads(cfg, ctx, sdpa, q, k, v, mask)


def _on_local_heads(cfg: ModelConfig, ctx, fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)`` on each rank's local q/k/v (``local_map``),
    placed by ``_head_spec``; ``rest`` are plain tensors (masks)."""
    from torch.distributed.tensor.experimental import local_map

    from .sharding import spec_placements
    spec = _head_spec(cfg, ctx)
    q, k, v = (ctx.constrain(t, *spec) for t in (q, k, v))
    pl = spec_placements(spec, ctx.mesh)
    return local_map(fn, out_placements=(pl,), in_placements=(pl, pl, pl) + (None,) * len(rest),
                     device_mesh=ctx.mesh)(q, k, v, *rest)


def _head_spec(cfg: ModelConfig, ctx) -> tuple:
    """q/k/v ``[B, S, H, Dh]`` under a mesh: batch over the batch axes,
    heads over the model axis where both the query and the kv heads divide
    it (a rank's query heads then read its own kv heads), else replicated."""
    from .sharding import batch_spec
    m = ctx.model_size
    heads = ctx.model_axis if cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0 else None
    return (batch_spec(ctx), None, heads, None)


def decode_attention(cfg: ModelConfig, p, x, cache_k, cache_v, pos: int, ctx=None):
    """One-token decode. x [B,1,D]; cache_k/v [B, Smax, Hkv, Dh]; pos an int.

    The KV cache is a plain buffer for full attention and a ring buffer
    (index mod window) for sliding-window attention. The new k/v row is
    written into ``cache_k``/``cache_v`` IN PLACE (the reference's
    ``dynamic_update_slice`` into a donated cache), and the same tensors
    are returned. A cache sharded over its sequence dim is attended on its
    local shards (``_decode_seq_sharded``).
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(cfg, p, x)  # S == 1
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
        out = _attend(cfg, q, cache_k, cache_v, mask, False, ctx)
    out = out.reshape(B, 1, cfg.q_dim) @ p["wo"].to(x.dtype)
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


def cross_attention(cfg: ModelConfig, p, x, memory_kv):
    """Decoder cross-attention against precomputed encoder (k, v)."""
    B, S, _ = x.shape
    q = split_ready(x @ p["wq"].to(x.dtype), -1, cfg.num_heads).reshape(
        B, S, cfg.num_heads, cfg.head_dim)
    k, v = memory_kv
    mask = torch.ones(1, S, k.shape[1], dtype=torch.bool, device=x.device)
    out = _sdpa(q, _expand_kv(cfg, k), _expand_kv(cfg, v), mask)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"].to(x.dtype)


def decode_cross_attention(cfg: ModelConfig, p, x, memory_kv):
    return cross_attention(cfg, p, x, memory_kv)
