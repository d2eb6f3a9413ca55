"""Shared building blocks: norms, RoPE, MLPs, embeddings, init helpers.

The port of ``repro/models/layers.py``. Parameters keep the reference's
names and layouts: weight matrices are ``[in, out]`` and are applied as
``x @ w``; a group of parameters is an ``nn.ParameterDict`` so the
functions below index it as the reference indexes its dicts. Parameters
are f32 masters (``PDTYPE``) that require no gradient for serving; the
train state turns it on (``train/train_step.py``). Every function casts
them to the dtype of ``x``, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig

PDTYPE = torch.float32    # parameter dtype (master)
CDTYPE = torch.bfloat16   # compute dtype


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def dense_init(generator: torch.Generator | None, shape, scale: float | None = None,
               device=None) -> nn.Parameter:
    """Normal(0, scale) with scale 1/sqrt(fan_in) by default, drawn from
    ``generator`` on its device; ``generator=None`` leaves the tensor
    uninitialised on ``device`` (for loading converted weights)."""
    if generator is None:
        return param(torch.empty(shape, dtype=PDTYPE, device=device))
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return param(torch.randn(shape, generator=generator, dtype=PDTYPE,
                             device=generator.device) * s)


def full_param(shape, value: float, generator, device) -> nn.Parameter:
    dev = generator.device if generator is not None else device
    return param(torch.full(shape, value, dtype=PDTYPE, device=dev))


def rmsnorm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + w)).to(dt)


def layernorm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


def norm_params(cfg: ModelConfig, generator=None, device=None) -> nn.ParameterDict:
    if cfg.norm == "rmsnorm":
        return nn.ParameterDict({"w": full_param((cfg.d_model,), 0.0, generator, device)})
    return nn.ParameterDict({"w": full_param((cfg.d_model,), 1.0, generator, device),
                             "b": full_param((cfg.d_model,), 0.0, generator, device)})


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


def rope_angles(positions, head_dim: int, theta: float):
    """positions [*] -> (cos, sin) of shape [*, head_dim/2], in f32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, Dh]; cos/sin [..., S, Dh/2] (broadcast over heads).

    A bf16 ``x`` times f32 angles promotes to f32 here, as in JAX; the
    result is cast back to the dtype of ``x``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def mlp_params(cfg: ModelConfig, generator=None, device=None,
               d_ff: int | None = None) -> nn.ParameterDict:
    D = cfg.d_model
    Fd = d_ff if d_ff is not None else cfg.d_ff
    if cfg.act == "silu":
        return nn.ParameterDict({
            "w_gate": dense_init(generator, (D, Fd), device=device),
            "w_up": dense_init(generator, (D, Fd), device=device),
            "w_down": dense_init(generator, (Fd, D), device=device),
        })
    return nn.ParameterDict({
        "w_up": dense_init(generator, (D, Fd), device=device),
        "b_up": full_param((Fd,), 0.0, generator, device),
        "w_down": dense_init(generator, (Fd, D), device=device),
        "b_down": full_param((D,), 0.0, generator, device),
    })


def apply_mlp(cfg: ModelConfig, p, x):
    """The MLP; its products are ``sharding.dense`` (pinned under a mesh)."""
    from .sharding import dense
    if cfg.act == "silu":
        h = F.silu(dense(x, p["w_gate"])) * dense(x, p["w_up"])
        return dense(h, p["w_down"])
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(dense(x, p["w_up"], p["b_up"]), approximate="tanh")
    return dense(h, p["w_down"], p["b_down"])


def embed_params(cfg: ModelConfig, generator=None, device=None) -> nn.ParameterDict:
    # 0.02 keeps tied-unembedding logits at O(1): std = sqrt(D) * 0.02
    p = {"tok": dense_init(generator, (cfg.vocab_size, cfg.d_model), scale=0.02,
                           device=device)}
    if not cfg.tie_embeddings:
        p["out"] = dense_init(generator, (cfg.d_model, cfg.vocab_size), device=device)
    return nn.ParameterDict(p)


def embed_tokens(p, tokens):
    from .sharding import is_dtensor
    if is_dtensor(p["tok"]):
        return _embed_sharded(p["tok"], tokens).to(CDTYPE)
    return p["tok"][tokens].to(CDTYPE)


def _embed_sharded(tok, tokens):
    """The rows of a DTensor table, vocab-parallel (as Megatron's): the
    table is gathered over every mesh axis but those sharding its vocab,
    the tokens over those; each rank looks up the ids in its vocab slice
    (zero elsewhere), and the rows are summed over the vocab axes
    (``sharding.sum_over``). A rank's table gradient covers its own tokens
    only, so it is partial over the axes that shard the tokens. DTensor's
    own embedding rule leaves a masked partial whose backward some torch
    releases cannot place."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from .sharding import chunk_offset, sum_over

    mesh = tok.device_mesh
    vocab = [i for i, pl in enumerate(tok.placements) if pl == Shard(0)]
    tok = tok.redistribute(mesh, [Shard(0) if i in vocab else Replicate()
                                  for i in range(mesh.ndim)])
    ids_pl = [Replicate() if i in vocab else pl for i, pl in enumerate(tokens.placements)]
    tokens = tokens.redistribute(mesh, ids_pl)
    off = chunk_offset(mesh, vocab, tok.shape[0])

    def local(t, ids):
        idx = ids.long() - off
        ok = (idx >= 0) & (idx < t.shape[0])
        rows = F.embedding(idx.clamp(0, max(t.shape[0] - 1, 0)), t)
        return sum_over(torch.where(ok[..., None], rows, 0.0), mesh, vocab)

    grad_pl = [Shard(0) if i in vocab else Partial() if isinstance(pl, Shard) else Replicate()
               for i, pl in enumerate(ids_pl)]
    return local_map(local, out_placements=(ids_pl,),
                     in_placements=(list(tok.placements), ids_pl),
                     in_grad_placements=(grad_pl, ids_pl), device_mesh=mesh)(tok, tokens)


def unembed(cfg: ModelConfig, p, x):
    from .sharding import dense
    return dense(x, p["tok"].T if cfg.tie_embeddings else p["out"])


def softmax_xent(logits, labels, mask=None):
    """Mean cross-entropy in f32. logits [..., V], labels [...] int.

    On a DTensor (a sharded loss) the vocab may be sharded over one mesh
    axis: see ``_xent_sharded``."""
    from .sharding import is_dtensor
    if is_dtensor(logits):
        return _xent_sharded(logits, labels, mask)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def _xent_sharded(logits, labels, mask):
    """``softmax_xent`` of a DTensor ``logits`` whose vocab dim is sharded
    over at most one mesh axis (vocab-parallel, as Megatron's): each rank
    takes the logsumexp of its vocab slice and its label's logit where the
    label falls in the slice (else 0); the [.., n_shards, 2] pairs are
    all-gathered over the vocab axis, then logz is the logsumexp of the
    slices' and the gold logit their sum. Returns a replicated scalar."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from .sharding import chunk_offset

    mesh, vd = logits.device_mesh, logits.ndim - 1
    pl = list(logits.placements)
    tp = [i for i, p in enumerate(pl) if p == Shard(vd)]
    if len(tp) > 1:
        raise ValueError(f"vocab sharded over {len(tp)} mesh axes: {pl}")
    rest = [Replicate() if p == Shard(vd) else p for p in pl]
    labels = labels.redistribute(mesh, rest)
    off = chunk_offset(mesh, tp, logits.shape[vd])

    def local(lg, lab):
        lg = lg.float()
        idx = lab.long() - off
        ok = (idx >= 0) & (idx < lg.shape[-1])
        gold = torch.gather(lg, -1, idx.clamp(0, max(lg.shape[-1] - 1, 0))[..., None])[..., 0]
        pair = torch.stack([torch.logsumexp(lg, -1), torch.where(ok, gold, 0.0)], -1)
        return pair[..., None, :]

    # the pairs' new dim [.., n, 2] sits where the vocab was, sharded alike
    pairs = local_map(local, out_placements=(pl,), in_placements=(pl, rest),
                      device_mesh=mesh)(logits, labels)
    pairs = pairs.redistribute(mesh, rest)                     # [..., n, 2]
    nll = torch.logsumexp(pairs[..., 0], -1) - pairs[..., 1].sum(-1)
    if mask is not None:
        loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    else:
        loss = nll.mean()
    return loss.redistribute(mesh, [Replicate()] * mesh.ndim)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (``F.softplus``
    turns linear above its threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def associative_scan(fn, elems, dim: int):
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` under
    the associative ``fn``, by ``jax.lax.associative_scan``'s algorithm
    (combine adjacent pairs, scan the half recursively, fill in the even
    positions), so the combines happen in the reference's order."""
    def sl(x, start, stop=None, step=1):
        return x[(slice(None),) * dim + (slice(start, stop, step),)]

    def interleave(a, b):   # a holds the even positions, b the odd ones
        n = a.shape[dim] + b.shape[dim]
        if a.shape[dim] > b.shape[dim]:
            b = torch.cat([b, torch.zeros_like(sl(a, 0, 1))], dim=dim)
        out = torch.stack([a, b], dim=dim + 1).flatten(dim, dim + 1)
        return sl(out, 0, n)

    def scan(xs):
        n = xs[0].shape[dim]
        if n < 2:
            return xs
        reduced = fn([sl(x, 0, -1, 2) for x in xs], [sl(x, 1, None, 2) for x in xs])
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn([sl(x, 0, -1) for x in odd], [sl(x, 2, None, 2) for x in xs])
        else:
            even = fn(odd, [sl(x, 2, None, 2) for x in xs])
        even = [torch.cat([sl(x, 0, 1), e], dim=dim) for x, e in zip(xs, even)]
        return [interleave(e, o) for e, o in zip(even, odd)]

    return tuple(scan(list(elems)))
