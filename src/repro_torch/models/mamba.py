"""Mamba block in the SSD (state-space dual) chunked form.

The port of ``repro/models/mamba.py``. It keeps the reference's form
(DESIGN.md §2.3): scalar decay per head, intra-chunk quadratic products,
and the inter-chunk state carried by an associative scan over chunks
(``layers.associative_scan``, the reference's algorithm). A fused
selective-scan kernel would compute another sum order than the reference
and could not be held against it.

The reference's three-operand einsums are two-operand products here, in an
order whose intermediates stay at ``[B, nc, c, c, H]`` or below (a
three-operand ``torch.einsum`` may contract in an order that materialises
``[B, nc, c, c, H, P]``).

Shapes: d_in = expand * d_model, heads H = d_in / P (P = 64), state N.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import associative_scan, dense_init, full_param, softplus
from .sharding import dense, is_dtensor, split_ready

P_HEAD = 64


def mamba_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_in = cfg.mamba_expand * cfg.d_model
    H = d_in // P_HEAD
    return d_in, H, cfg.mamba_d_state


def mamba_params(cfg: ModelConfig, generator=None, device=None) -> nn.ParameterDict:
    D = cfg.d_model
    d_in, H, N = mamba_dims(cfg)
    return nn.ParameterDict({
        "in_proj": dense_init(generator, (D, 2 * d_in), device=device),
        "conv_w": dense_init(generator, (cfg.mamba_d_conv, d_in), scale=0.5, device=device),
        "w_B": dense_init(generator, (d_in, N), device=device),
        "w_C": dense_init(generator, (d_in, N), device=device),
        "w_dt": dense_init(generator, (d_in, H), device=device),
        "b_dt": full_param((H,), -2.0, generator, device),   # softplus(-2) ~ 0.13
        "A_log": full_param((H,), 0.0, generator, device),   # a = -exp(A_log) = -1
        "D_skip": full_param((H,), 1.0, generator, device),
        "out_proj": dense_init(generator, (d_in, D), device=device),
    })


def _causal_conv(u, w, state=None):
    """Depthwise causal conv over seq. u [B,S,C]; w [K,C].
    With ``state`` [B,K-1,C] (decode), returns (out, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], K - 1, u.shape[2]), dtype=u.dtype, device=u.device)
        ext = torch.cat([pad, u], dim=1)
    else:
        ext = torch.cat([state.to(u.dtype), u], dim=1)
    S = u.shape[1]
    out = 0   # Python's sum: 0 + term 0 + term 1 + ...
    for i in range(K):
        out = out + ext[:, i:i + S, :] * w[i].to(u.dtype)
    new_state = ext[:, -(K - 1):, :] if K > 1 else None
    return out, new_state


def _ssd_chunked(X, B_, C_, lamb, chunk: int):
    """SSD core. X [B,S,H,P] (already dt-scaled), B_/C_ [B,S,N],
    lamb [B,S,H] log-decay (<=0). Returns y [B,S,H,P] in f32."""
    Bsz, S, H, P = X.shape
    N = B_.shape[-1]
    nc = S // chunk
    Xc = X.reshape(Bsz, nc, chunk, H, P).float()
    Bc = B_.reshape(Bsz, nc, chunk, N).float()
    Cc = C_.reshape(Bsz, nc, chunk, N).float()
    lc = lamb.reshape(Bsz, nc, chunk, H)
    cum = torch.cumsum(lc.float(), dim=2)                                # [B,nc,c,H]

    # --- intra-chunk (quadratic) -------------------------------------------
    att0 = torch.einsum("bgin,bgjn->bgij", Cc, Bc)
    Ldec = cum[:, :, :, None, :] - cum[:, :, None, :, :]                 # [B,nc,i,j,H]
    ar = torch.arange(chunk, device=X.device)
    tri = ar[:, None] >= ar[None, :]
    L = torch.where(tri[None, None, :, :, None], torch.exp(Ldec), 0.0)
    W = att0[..., None] * L                                              # [B,nc,i,j,H]
    y_intra = torch.einsum("bgijh,bgjhp->bgihp", W, Xc)

    # --- inter-chunk state via associative scan -----------------------------
    # per chunk: h_out = A_g h_in + S_g with
    #   A_g = exp(cum_last)                       [B,nc,H]
    #   S_g = sum_j exp(cum_last - cum_j) B_j X_j [B,nc,H,N,P]
    dec_out = torch.exp(cum[:, :, -1:, :] - cum)                         # [B,nc,c,H]
    Sg = torch.einsum("bgjnh,bgjhp->bghnp", Bc[..., None] * dec_out[:, :, :, None, :], Xc)
    Ag = torch.exp(cum[:, :, -1, :])                                     # [B,nc,H]

    def combine(a, b):
        A1, S1 = a
        A2, S2 = b
        return A1 * A2, A2[..., None, None] * S1 + S2

    _, Scum = associative_scan(combine, (Ag, Sg), dim=1)
    # state BEFORE chunk g = Scum[g-1] (shift right; zero for the first chunk)
    h_prev = torch.cat([torch.zeros_like(Scum[:, :1]), Scum[:, :-1]], dim=1)
    y_inter = torch.einsum("bgin,bghnp->bgihp", Cc, h_prev) * torch.exp(cum)[..., None]

    return (y_intra + y_inter).reshape(Bsz, S, H, P)


def _ssd(X, B_, C_, lamb, chunk: int):
    """``_ssd_chunked``; on DTensors whose heads are sharded over mesh axes,
    on each rank's heads (``sharding.run_local``): X and lamb by their
    heads, B_ and C_ whole (their gradients are partial over those axes).
    Left to DTensor, the einsums' merged batch x heads dims would gather
    the heads and repeat the whole SSD on every rank."""
    if not is_dtensor(X):
        return _ssd_chunked(X, B_, C_, lamb, chunk)
    from torch.distributed.tensor import Partial, Replicate, Shard

    from .sharding import run_local
    pl = list(X.placements)
    if any(p not in (Shard(0), Shard(2), Replicate()) for p in pl):
        return _ssd_chunked(X, B_, C_, lamb, chunk)
    whole = [Replicate() if p == Shard(2) else p for p in pl]
    partial = [Partial() if p == Shard(2) else p for p in pl]
    return run_local(lambda *a: _ssd_chunked(*a, chunk), X.device_mesh, (X, B_, C_, lamb),
                     (pl, whole, whole, pl), (pl, partial, partial, pl), pl, X.shape)


def _dt(p, u):
    return softplus(dense(u, p["w_dt"]).float() + p["b_dt"])


def _in_proj(p, x):
    """(u, z), the halves of ``x @ in_proj``. On DTensors each half is a
    product of its own (``sharding.dense``), so both come out sharded over
    the model axis by their own columns (heads); a split of the whole
    product's sharded columns would gather them."""
    if is_dtensor(p["in_proj"]):
        return tuple(dense(x, w) for w in p["in_proj"].chunk(2, dim=1))
    return dense(x, p["in_proj"]).chunk(2, dim=-1)


def apply_mamba(cfg: ModelConfig, p, x, chunk: int = 128):
    """x [B,S,D] -> [B,S,D] (prefill path)."""
    Bsz, S, D = x.shape
    d_in, H, N = mamba_dims(cfg)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} must be divisible by the ssd chunk {chunk}")

    u, z = _in_proj(p, x)
    u, _ = _causal_conv(u, p["conv_w"])
    u = F.silu(u)

    B_ = dense(u, p["w_B"])
    C_ = dense(u, p["w_C"])
    dt = _dt(p, u)
    a = -torch.exp(p["A_log"])                                           # [H] < 0
    lamb = dt * a                                                        # [B,S,H]
    X = split_ready(u, -1, H).reshape(Bsz, S, H, P_HEAD) * dt[..., None].to(u.dtype)

    y = _ssd(X, B_, C_, lamb, chunk)
    y = y + split_ready(u, -1, H).reshape(Bsz, S, H, P_HEAD).to(y.dtype) * p["D_skip"][None, None, :, None]
    y = y.reshape(Bsz, S, d_in).to(x.dtype) * F.silu(z)
    return dense(y, p["out_proj"])


def mamba_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None):
    """``h`` [B, H, N, P] f32 and ``conv`` [B, K-1, d_in]. The reference's
    conv state becomes the compute dtype after its first step; one kept in
    f32 holds the same (exactly representable) values."""
    d_in, H, N = mamba_dims(cfg)
    return {
        "h": torch.zeros((batch, H, N, P_HEAD), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, d_in), dtype=dtype, device=device),
    }


def decode_mamba(cfg: ModelConfig, p, x, state):
    """One-token decode. x [B,1,D]; returns (y [B,1,D], new state)."""
    Bsz = x.shape[0]
    d_in, H, N = mamba_dims(cfg)
    u, z = _in_proj(p, x)
    u, conv_state = _causal_conv(u, p["conv_w"], state=state["conv"])
    u = F.silu(u)
    B_ = dense(u, p["w_B"]).float()[:, 0]                                # [B,N]
    C_ = dense(u, p["w_C"]).float()[:, 0]
    dt = _dt(p, u)[:, 0]                                                 # [B,H]
    a = -torch.exp(p["A_log"])
    alpha = torch.exp(dt * a)                                            # [B,H]
    Xt = split_ready(u, -1, H).reshape(Bsz, H, P_HEAD).float() * dt[..., None]
    h = alpha[..., None, None] * state["h"] + torch.einsum("bn,bhp->bhnp", B_, Xt)
    y = torch.einsum("bn,bhnp->bhp", C_, h)
    y = y + split_ready(u, -1, H).reshape(Bsz, H, P_HEAD).float() * p["D_skip"][None, :, None]
    y = y.reshape(Bsz, 1, d_in).to(x.dtype) * F.silu(z)
    out = dense(y, p["out_proj"])
    return out, {"h": h, "conv": conv_state}
