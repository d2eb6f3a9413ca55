"""xLSTM blocks: mLSTM (parallel chunkwise, matrix memory) and sLSTM
(sequential scan with memory mixing).

The port of ``repro/models/xlstm.py``. mLSTM keeps the chunkwise form, with
the (C, n) matrix memory carried across chunks by the reference's
associative scan (``layers.associative_scan``); its three-operand einsums
are two-operand products here, in an order whose intermediates stay at
``[B, nc, c, c, H]`` or ``[B, nc, H, P, P]``. sLSTM's memory mixing is
sequential: one step per position, a Python loop (the reference's
``lax.scan``), so on the card it is bound by the host's launches; the
dry-run's recorder counts the loop from three recorded iterations
(``launch.fx_analysis.LocalRecorder.scan``).
Stabilisation uses the xLSTM m-state in log space, clipped for the
chunkwise weights.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .config import ModelConfig
from .layers import associative_scan, dense_init, full_param, log_sigmoid, rmsnorm
from .sharding import dense, is_dtensor, run_local

CLIP = 30.0


def _proj(x, w, b=None):
    """``x @ w (+ b)`` (``sharding.dense``). The reference keeps xLSTM's
    weights replicated (``launch/shardings.py``), and under a mesh every
    rank computes the whole product, as its SPMD program does."""
    return dense(x, w, b, split_cols=False)


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    H = cfg.num_heads
    return H, cfg.d_model // H


def _clip(x):
    return torch.clamp(x, -CLIP, CLIP)


def _cumsum(x, dim: int):
    """``torch.cumsum`` along a dim that no mesh axis shards; on a DTensor,
    on each rank's shard (torch 2.11's DTensor has no rule for ``flip``,
    which the cumsum's backward runs)."""
    if not is_dtensor(x):
        return torch.cumsum(x, dim)
    from torch.distributed.tensor import Shard
    pl = tuple(x.placements)
    if any(isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim for p in pl):
        raise ValueError(f"cumsum along dim {dim}, which {pl} shards")
    return run_local(lambda t: torch.cumsum(t, dim), x.device_mesh, (x,), (pl,), (pl,), pl,
                     tuple(x.shape))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_params(cfg: ModelConfig, generator=None, device=None) -> nn.ParameterDict:
    D = cfg.d_model
    H, P = _heads(cfg)
    return nn.ParameterDict({
        "wq": dense_init(generator, (D, D), device=device),
        "wk": dense_init(generator, (D, D), device=device),
        "wv": dense_init(generator, (D, D), device=device),
        "wi": dense_init(generator, (D, H), scale=0.01, device=device),
        "wf": dense_init(generator, (D, H), scale=0.01, device=device),
        "bf": full_param((H,), 3.0, generator, device),   # forget-gate bias -> ~1
        "wo": dense_init(generator, (D, D), device=device),
        "norm": full_param((D,), 0.0, generator, device),
    })


def apply_mlstm(cfg: ModelConfig, p, x, chunk: int = 256):
    """x [B,S,D] -> [B,S,D], chunkwise parallel form."""
    B, S, D = x.shape
    H, P = _heads(cfg)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} must be divisible by the mLSTM chunk {chunk}")
    nc = S // chunk

    # the reference divides by sqrt(P) rounded to the compute dtype
    # (bf16: sqrt(192) = 13.875)
    sqrt_p = torch.tensor(math.sqrt(P), dtype=torch.float32).to(x.dtype)
    q = _proj(x, p["wq"]).reshape(B, S, H, P)
    k = _proj(x, p["wk"]).reshape(B, S, H, P) / sqrt_p.to(x.device)
    v = _proj(x, p["wv"]).reshape(B, S, H, P)
    logi = _proj(x, p["wi"]).float()                                           # [B,S,H]
    logf = log_sigmoid(_proj(x, p["wf"]).float() + p["bf"])

    qc = q.reshape(B, nc, chunk, H, P).float()
    kc = k.reshape(B, nc, chunk, H, P).float()
    vc = v.reshape(B, nc, chunk, H, P).float()
    lic = logi.reshape(B, nc, chunk, H)
    cumf = _cumsum(logf.reshape(B, nc, chunk, H), dim=2)                       # [B,nc,c,H]

    # intra-chunk: w_ij = exp(cumf_i - cumf_j + logi_j), i >= j
    Dij = cumf[:, :, :, None, :] - cumf[:, :, None, :, :] + lic[:, :, None, :, :]
    ar = torch.arange(chunk, device=x.device)
    tri = ar[:, None] >= ar[None, :]
    W = torch.where(tri[None, None, :, :, None], torch.exp(_clip(Dij)), 0.0)
    att = torch.einsum("bgihp,bgjhp->bgijh", qc, kc) * W                       # [B,nc,i,j,H]
    y_intra = torch.einsum("bgijh,bgjhp->bgihp", att, vc)
    n_intra = att.sum(dim=3)                                                   # [B,nc,i,H]

    # inter-chunk: matrix memory C [B,H,P,P], mass n [B,H,P]
    dec_out = torch.exp(_clip(cumf[:, :, -1:, :] - cumf + lic))                # [B,nc,c,H]
    kd = kc * dec_out[..., None]
    Cg = torch.einsum("bgjhp,bgjhq->bghpq", kd, vc)                            # kv^T sums
    ng = kd.sum(dim=2)                                                         # [B,nc,H,P]
    Ag = torch.exp(_clip(cumf[:, :, -1, :]))                                   # [B,nc,H]

    def combine(a, b):
        A1, C1, n1 = a
        A2, C2, n2 = b
        return A1 * A2, A2[..., None, None] * C1 + C2, A2[..., None] * n1 + n2

    _, Ccum, ncum = associative_scan(combine, (Ag, Cg, ng), dim=1)
    C_prev = torch.cat([torch.zeros_like(Ccum[:, :1]), Ccum[:, :-1]], dim=1)
    n_prev = torch.cat([torch.zeros_like(ncum[:, :1]), ncum[:, :-1]], dim=1)
    gi = torch.exp(_clip(cumf))                                                # [B,nc,c,H]
    y_inter = torch.einsum("bgihp,bghpq->bgihq", qc, C_prev) * gi[..., None]
    n_inter = torch.einsum("bgihp,bghp->bgih", qc, n_prev) * gi

    # normaliser: |sum_j w_ij (q_i . k_j)| accumulated mass, floored at 1
    denom = torch.clamp_min((n_intra + n_inter).abs(), 1.0)[..., None]
    y = (y_intra + y_inter) / denom
    # per-head RMS norm, then output proj
    y = rmsnorm(y.reshape(B, S, D).to(x.dtype), p["norm"])
    return _proj(y, p["wo"])


def mlstm_state_init(cfg: ModelConfig, batch: int, device=None):
    H, P = _heads(cfg)
    return {
        "C": torch.zeros((batch, H, P, P), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, H, P), dtype=torch.float32, device=device),
        "f_acc": torch.zeros((batch, H), dtype=torch.float32, device=device),
    }


def decode_mlstm(cfg: ModelConfig, p, x, state):
    B = x.shape[0]
    D = cfg.d_model
    H, P = _heads(cfg)
    q = _proj(x, p["wq"]).reshape(B, H, P).float()
    # here the reference divides by the f32 sqrt(P)
    k = _proj(x, p["wk"]).reshape(B, H, P).float() / math.sqrt(P)
    v = _proj(x, p["wv"]).reshape(B, H, P).float()
    logi = _proj(x, p["wi"]).float()[:, 0]
    logf = log_sigmoid(_proj(x, p["wf"]).float() + p["bf"])[:, 0]
    fa = torch.exp(_clip(logf))
    ia = torch.exp(_clip(logi))
    C = fa[..., None, None] * state["C"] + ia[..., None, None] * torch.einsum(
        "bhp,bhq->bhpq", k, v)
    n = fa[..., None] * state["n"] + ia[..., None] * k
    num = torch.einsum("bhp,bhpq->bhq", q, C)
    den = torch.clamp_min(torch.einsum("bhp,bhp->bh", q, n).abs(), 1.0)[..., None]
    y = (num / den).reshape(B, 1, D).to(x.dtype)
    y = rmsnorm(y, p["norm"])
    return _proj(y, p["wo"]), {"C": C, "n": n, "f_acc": state["f_acc"]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_params(cfg: ModelConfig, generator=None, device=None) -> nn.ParameterDict:
    D = cfg.d_model
    H, P = _heads(cfg)
    return nn.ParameterDict({
        "W": dense_init(generator, (D, 4 * D), device=device),   # z, i, f, o pre-activations
        "R": dense_init(generator, (H, P, 4 * P), scale=0.5 / math.sqrt(P),
                        device=device),                  # block-diagonal recurrent
        "b": full_param((4 * D,), 0.0, generator, device),
        "norm": full_param((D,), 0.0, generator, device),
        "wo": dense_init(generator, (D, D), device=device),
    })


def slstm_state_init(cfg: ModelConfig, batch: int, device=None):
    H, P = _heads(cfg)
    z = lambda: torch.zeros((batch, H, P), dtype=torch.float32, device=device)
    return {"c": z(), "n": torch.ones((batch, H, P), dtype=torch.float32, device=device),
            "h": z(), "m": z()}


def _slstm_step(cfg: ModelConfig, R, wx_t, state):
    """wx_t [B, 4D] precomputed W x_t + b; R the recurrent weights in the
    dtype of ``wx_t``; state dict of [B,H,P]."""
    H, P = _heads(cfg)
    B = wx_t.shape[0]
    rh = torch.einsum("bhp,hpq->bhq", state["h"].to(wx_t.dtype), R)
    pre = (wx_t.reshape(B, H, 4 * P) + rh).float()
    z, i, f, o = pre.chunk(4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    logf = log_sigmoid(f)
    m_new = torch.maximum(logf + state["m"], i)
    ig = torch.exp(i - m_new)
    fg = torch.exp(logf + state["m"] - m_new)
    c = fg * state["c"] + ig * z
    n = torch.clamp_min(fg * state["n"] + ig, 1e-6)
    h = o * (c / n)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _scan_recorder(x):
    """The dispatch mode recording this step with loop regions
    (``launch.fx_analysis.LocalRecorder``), when one records ``x``'s meta
    tensors; else None."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    local = x._local_tensor if is_dtensor(x) else x
    if local.device.type != "meta":
        return None
    return next((m for m in _get_current_dispatch_mode_stack()
                 if getattr(m, "scan_regions", False)), None)


def apply_slstm(cfg: ModelConfig, p, x, time_chunk: int = 1):
    """x [B,S,D] -> [B,S,D]; sequential over time, one step per position
    (the reference's ``lax.scan`` of S / ``time_chunk`` iterations of
    ``time_chunk`` steps; S must be a multiple of it).

    Run, every step runs, whatever ``time_chunk`` is, so each value gives
    the same result, bit for bit. Recorded for the dry-run (a
    ``LocalRecorder`` over meta tensors), ``time_chunk`` is the steps of
    one recorded iteration: the recorder's loop region holds three
    iterations, the middle one counted for the S / ``time_chunk`` - 2
    between the first and the last."""
    B, S, D = x.shape
    H, P = _heads(cfg)
    wx = _proj(x, p["W"], p["b"])                             # [B,S,4D]
    state = slstm_state_init(cfg, B, device=x.device)
    tc = max(int(time_chunk), 1)
    if S % tc:
        raise ValueError(f"seq {S} must divide the sLSTM time chunk {tc}")
    R = p["R"].to(wx.dtype)

    def steps(state, rows):
        hs = []
        for wx_t in rows:
            state = _slstm_step(cfg, R, wx_t, state)
            hs.append(state["h"])
        return state, hs

    rec = _scan_recorder(x)
    if rec is not None and S // tc >= 3:
        _, y = rec.scan(steps, state, wx, dim=1, chunk=tc)
    else:
        _, hs = steps(state, wx.unbind(1))
        y = torch.stack(hs, dim=1)
    y = y.reshape(B, S, D).to(x.dtype)
    y = rmsnorm(y, p["norm"])
    return _proj(y, p["wo"])


def decode_slstm(cfg: ModelConfig, p, x, state):
    B = x.shape[0]
    D = cfg.d_model
    wx = _proj(x, p["W"], p["b"])[:, 0]
    new = _slstm_step(cfg, p["R"].to(wx.dtype), wx, state)
    y = new["h"].reshape(B, 1, D).to(x.dtype)
    y = rmsnorm(y, p["norm"])
    return _proj(y, p["wo"]), new
