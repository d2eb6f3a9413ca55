"""Mixture-of-Experts on one device.

The port of ``repro/models/moe.py`` at V = 1 (one virtual expert shard:
the whole model axis is one device). Params keep the reference's layout,
``w_*`` ``[V, E_loc, D|F_v, F_v|D]``; ``moe_layout`` gives its shapes for
any V, so a checkpoint made for V > 1 is recognised, but only V = 1 runs
here. Expert parallelism over a mesh (the reference's ``shard_map`` path)
is ROADMAP.md, Queue 1, item 10, "``launch/``".

Capacity dispatch as in the reference: per expert, the ``C`` tokens of the
batch with the highest renormalised gate are kept; dropped tokens pass
through the residual stream. ``C = max(ceil(T * top_k * capacity_factor /
E), 4)``, at most T.

Two sites order ties as ``jax.lax.top_k`` does (the lower index first):
the router's top-k over experts (bf16 logits tie) and each expert's top-C
over tokens (equal hidden states tie). ``torch.topk`` promises no order, so
both take a stable descending sort. The combine adds the experts' outputs
expert by expert, in expert order: XLA's CPU scatter applies the
flattened ``[E, C]`` updates in that order, and within one expert the C
token indices are distinct, so each ``index_add_`` is deterministic on the
card too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import dense_init
from .sharding import ShardCtx


def moe_layout(cfg: ModelConfig, V: int) -> tuple[int, int]:
    """(E_loc, F_v) for a given virtual-expert count V."""
    E, Fd = cfg.num_experts, cfg.d_ff
    if E >= V:
        if E % V:
            raise ValueError(f"num_experts {E} not divisible by mesh model axis {V}")
        return E // V, Fd
    if V % E or Fd % (V // E):
        raise ValueError(f"cannot split {E} experts / d_ff {Fd} over {V} devices")
    return 1, Fd * E // V


def moe_params(cfg: ModelConfig, generator=None, device=None, V: int = 1) -> nn.ParameterDict:
    D, E = cfg.d_model, cfg.num_experts
    E_loc, F_v = moe_layout(cfg, V)
    return nn.ParameterDict({
        "router": dense_init(generator, (D, E), device=device),
        "w_gate": dense_init(generator, (V, E_loc, D, F_v), device=device),
        "w_up": dense_init(generator, (V, E_loc, D, F_v), device=device),
        "w_down": dense_init(generator, (V, E_loc, F_v, D), device=device),
    })


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties in index
    order, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, T: int) -> int:
    """Tokens kept per expert (the reference's float ceiling, then <= T)."""
    C = max(int(-(-T * cfg.top_k * cfg.capacity_factor // cfg.num_experts)), 4)
    return min(C, T)


def moe_ffn_shard(cfg: ModelConfig, x, router, w_gate, w_up, w_down, virt: int = 0,
                  V: int = 1):
    """x [T, D]; w_* [E_loc, D|F_v, F_v|D] -> [T, D] (at V = 1 the whole
    output; the reference's caller psums shards over the model axis)."""
    if V != 1 or virt != 0:
        raise NotImplementedError(
            "repro_torch runs MoE on one device (V = 1); expert parallelism is "
            "ROADMAP.md, Queue 1, item 10, 'launch/'")
    T, D = x.shape
    E = cfg.num_experts
    C = capacity(cfg, T)

    logits = (x @ router.to(x.dtype)).float()                          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k(probs, cfg.top_k)                        # [T, K]
    gates = top_vals / top_vals.sum(-1, keepdim=True)                  # renormalised
    # score[e, t] = gate if token t routed expert e else -inf (a token's k
    # experts are distinct, so the reference's max over k is this scatter)
    score = torch.full((T, E), -torch.inf, dtype=gates.dtype, device=x.device)
    score = score.scatter_(1, top_idx, gates).T.contiguous()          # [E, T]
    cap_vals, cap_idx = top_k(score, C)                                 # [E, C]
    keep = torch.isfinite(cap_vals)
    w_tok = torch.where(keep, cap_vals, 0.0).to(x.dtype)
    xe = x[torch.where(keep, cap_idx, 0)]                              # [E, C, D]

    h = F.silu(torch.bmm(xe, w_gate.to(x.dtype)))
    h = h * torch.bmm(xe, w_up.to(x.dtype))
    ye = torch.bmm(h, w_down.to(x.dtype))                              # [E, C, D]
    ye = ye * w_tok[..., None]

    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for e in range(E):
        out.index_add_(0, cap_idx[e], ye[e])
    return out


def apply_moe(cfg: ModelConfig, p, x, ctx: ShardCtx | None = None):
    """x [B, S, D] -> [B, S, D]."""
    B, S, D = x.shape
    out = moe_ffn_shard(cfg, x.reshape(-1, D), p["router"], p["w_gate"][0],
                        p["w_up"][0], p["w_down"][0])
    return out.reshape(B, S, D)
