"""GQA attention: prefill (full, sliding-window, cross) and decode paths.

The port of ``repro/models/attention.py`` for one device. Activations keep
the reference's ``[B, S, H, Dh]`` layout. With ``ctx.use_flash`` the
prefill runs the flash kernel (``kernels/ops.py:flash_attention``);
otherwise ``_sdpa`` materialises the masked logits, as the reference's
dense path does.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import apply_rope, dense_init, full_param, rope_angles

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
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
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
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if cfg.rope_theta > 0:
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        if bf16:  # angles stay f32; rotation runs in compute dtype
            cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if ctx is not None and ctx.use_flash:
        out = kops.flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    else:
        iq = torch.arange(S, device=x.device)[:, None]
        ik = torch.arange(S, device=x.device)[None, :]
        mask = torch.ones(1, S, S, dtype=torch.bool, device=x.device)
        if causal:
            mask = mask & (ik <= iq)[None]
        if cfg.sliding_window > 0:
            mask = mask & (iq - ik < cfg.sliding_window)[None]
        out = _sdpa(q, _expand_kv(cfg, k), _expand_kv(cfg, v), mask, bf16=bf16)
    out = out.reshape(B, S, cfg.q_dim) @ p["wo"].to(x.dtype)
    return out, (k, v)


def decode_attention(cfg: ModelConfig, p, x, cache_k, cache_v, pos: int):
    """One-token decode. x [B,1,D]; cache_k/v [B, Smax, Hkv, Dh]; pos an int.

    The KV cache is a plain buffer for full attention and a ring buffer
    (index mod window) for sliding-window attention. The new k/v row is
    written into ``cache_k``/``cache_v`` IN PLACE (the reference's
    ``dynamic_update_slice`` into a donated cache), and the same tensors
    are returned.
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(cfg, p, x)  # S == 1
    if cfg.rope_theta > 0:
        posv = torch.full((B, 1), pos, device=x.device)
        cos, sin = rope_angles(posv, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    Smax = cache_k.shape[1]
    slot = pos % Smax if cfg.sliding_window > 0 else pos
    cache_k[:, slot] = k_new[:, 0]
    cache_v[:, slot] = v_new[:, 0]
    ik = torch.arange(Smax, device=x.device)[None, :]
    if cfg.sliding_window > 0:
        # valid ring slots: the last min(pos+1, Smax) written entries
        age = (slot - ik) % Smax
        mask = (age <= min(pos, Smax - 1))[:, None, :]
    else:
        mask = (ik <= pos)[:, None, :]
    out = _sdpa(q, _expand_kv(cfg, cache_k), _expand_kv(cfg, cache_v), mask)
    out = out.reshape(B, 1, cfg.q_dim) @ p["wo"].to(x.dtype)
    return out, cache_k, cache_v


def cross_attention(cfg: ModelConfig, p, x, memory_kv):
    """Decoder cross-attention against precomputed encoder (k, v)."""
    B, S, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k, v = memory_kv
    mask = torch.ones(1, S, k.shape[1], dtype=torch.bool, device=x.device)
    out = _sdpa(q, _expand_kv(cfg, k), _expand_kv(cfg, v), mask)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"].to(x.dtype)


def decode_cross_attention(cfg: ModelConfig, p, x, memory_kv):
    return cross_attention(cfg, p, x, memory_kv)
