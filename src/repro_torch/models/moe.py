"""Mixture-of-Experts with expert parallelism over the `model` mesh axis.

The port of ``repro/models/moe.py``. Activations are replicated over
`model` (the Megatron invariant), so expert dispatch needs no all-to-all:
each model-axis rank gathers the tokens routed to the experts it owns,
computes, and one all-reduce over `model` sums the experts' outputs and
the d_ff shards (DESIGN.md §5).

Virtual-expert layout: the E physical experts are laid out over the
``V = |model axis|`` ranks as ``[V, E_loc, D, F_v]``:

* E >= V: each rank owns ``E_loc = E/V`` full experts   (F_v = F)
* E <  V: each expert is split into ``V/E`` d_ff shards  (E_loc = 1,
  F_v = F*E/V); the shards of one expert gather the same tokens and the
  all-reduce sums their partial w_down outputs.

``moe_ffn_shard`` is one virtual shard's function at any ``(virt, V)``.
``apply_moe`` runs it whole at V = 1 without a mesh, and under a mesh ctx
once per model-axis rank on its local tokens (``local_map``, the
reference's ``shard_map``): each rank's expert weights are gathered whole
first (a redistribution, whatever their ZeRO shards over `data`), and the
partial outputs are summed over `model` in the activations' dtype
(``sharding.sum_over``); both are differentiable.

Capacity dispatch as in the reference: per (rank, physical expert), the
``C`` tokens of the LOCAL batch shard with the highest renormalised gate
are kept; dropped tokens pass through the residual stream. ``C =
max(ceil(T_loc * top_k * capacity_factor / E), 4)``, at most T_loc.

Two sites order ties as ``jax.lax.top_k`` does (the lower index first):
the router's top-k over experts (bf16 logits tie) and each expert's top-C
over tokens (equal hidden states tie). ``torch.topk`` promises no order, so
both take a stable descending sort. The combine adds the experts' outputs
expert by expert, in expert order: XLA's CPU scatter applies the
flattened ``[E_loc, C]`` updates in that order, and within one expert the C
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


def _phys_expert_ids(cfg: ModelConfig, V: int, virt: int, device=None) -> torch.Tensor:
    """[E_loc] physical expert ids owned by virtual shard ``virt``."""
    E = cfg.num_experts
    E_loc, _ = moe_layout(cfg, V)
    if E >= V:
        return virt * E_loc + torch.arange(E_loc, device=device)
    return torch.tensor([virt // (V // E)], device=device)


def moe_ffn_shard(cfg: ModelConfig, x, router, w_gate, w_up, w_down, virt: int = 0,
                  V: int = 1):
    """Virtual shard ``virt`` of ``V``: x [T, D] local tokens; w_* [E_loc,
    D|F_v, F_v|D] its experts -> the PARTIAL output [T, D] (the whole output
    at V = 1; the caller sums the V shards over the model axis)."""
    T, D = x.shape
    E = cfg.num_experts
    C = capacity(cfg, T)

    logits = (x @ router.to(x.dtype)).float()                          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k(probs, cfg.top_k)                        # [T, K]
    gates = top_vals / top_vals.sum(-1, keepdim=True)                  # renormalised
    # score[e, t] = gate if token t routed expert e else -inf (a token's k
    # experts are distinct, so the reference's max over k is this scatter);
    # this shard's rows are its experts'
    score = torch.full((T, E), -torch.inf, dtype=gates.dtype, device=x.device)
    score = score.scatter_(1, top_idx, gates).T                        # [E, T]
    score = score[_phys_expert_ids(cfg, V, virt, x.device)].contiguous()  # [E_loc, T]
    cap_vals, cap_idx = top_k(score, C)                                 # [E_loc, C]
    keep = torch.isfinite(cap_vals)
    w_tok = torch.where(keep, cap_vals, 0.0).to(x.dtype)
    xe = x[torch.where(keep, cap_idx, 0)]                              # [E_loc, C, D]

    h = F.silu(torch.bmm(xe, w_gate.to(x.dtype)))
    h = h * torch.bmm(xe, w_up.to(x.dtype))
    ye = torch.bmm(h, w_down.to(x.dtype))                              # [E_loc, C, D]
    ye = ye * w_tok[..., None]

    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for e in range(ye.shape[0]):
        out.index_add_(0, cap_idx[e], ye[e])
    return out


def apply_moe(cfg: ModelConfig, p, x, ctx: ShardCtx | None = None):
    """x [B, S, D] -> [B, S, D]."""
    B, S, D = x.shape
    if ctx is None or ctx.mesh is None:
        out = moe_ffn_shard(cfg, x.reshape(-1, D), p["router"], p["w_gate"][0],
                            p["w_up"][0], p["w_down"][0])
        return out.reshape(B, S, D)

    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    from .sharding import batch_spec, mesh_coord, spec_placements, sum_over
    mesh, maxis, V = ctx.mesh, ctx.model_axis, ctx.model_size
    m = mesh.mesh_dim_names.index(maxis)
    bs = batch_spec(ctx)
    xspec = (bs, None, None)
    x = ctx.constrain(x, *xspec)                        # replicated over model
    router = ctx.constrain(p["router"], None, None)
    # the reference's in_specs: each model rank its [1, E_loc, ..] slice,
    # gathered over `data` (its zero3 all_gather on axes 2 / 3)
    wg, wu, wd = (ctx.constrain(p[k], maxis, None, None, None)
                  for k in ("w_gate", "w_up", "w_down"))
    virt = mesh_coord(mesh, maxis)
    x_pl = spec_placements(xspec, mesh)
    r_pl = spec_placements((None, None), mesh)
    w_pl = spec_placements((maxis, None, None, None), mesh)
    # a rank's gradients cover its own tokens and experts: partial over the
    # axes sharding the tokens (and, for x and the router, over model)
    tok = [isinstance(pl, Shard) for pl in x_pl]
    x_g = [Partial() if i == m else pl for i, pl in enumerate(x_pl)]
    r_g = [Partial() if tok[i] or i == m else pl for i, pl in enumerate(r_pl)]
    w_g = [Partial() if tok[i] else pl for i, pl in enumerate(w_pl)]

    def shard_fn(xs, r, g, u, d):
        out = moe_ffn_shard(cfg, xs.reshape(-1, D), r, g[0], u[0], d[0], virt, V=V)
        return sum_over(out.reshape(xs.shape), mesh, [m])   # psum over model, in x.dtype

    return local_map(shard_fn, out_placements=(x_pl,),
                     in_placements=(x_pl, r_pl, w_pl, w_pl, w_pl),
                     in_grad_placements=(x_g, r_g, w_g, w_g, w_g),
                     device_mesh=mesh)(x, router, wg, wu, wd)
