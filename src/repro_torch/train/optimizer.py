"""AdamW with global-norm clipping (the port of ``repro/train/optimizer.py``).

The state and the update run over the model's named parameters: ``params``
is an ``nn.Module`` (its ``named_parameters()``) or a dict of tensors, and
``grads``, ``mu`` and ``nu`` are dicts keyed by the same names. Each
element takes the reference's arithmetic, one rounding per operation in
the same order (``repro/train/optimizer.py:37-71``): the clip scale
``min(1, clip / max(gnorm, 1e-12))``, the bias corrections from the f32
step, and ``new_p = p - lr * (mh / (sqrt(vh) + eps) + wd * p)``.
``torch.optim.AdamW`` is not used: it decays the weights in another order
and has no schedule or clip.

A sharded state (DTensor params, each moment placed as its param) takes
the same elementwise update shard by shard; only ``global_norm`` reduces
across ranks.

The update writes the new params, ``mu`` and ``nu`` into the given tensors
(the reference returns new trees; on one card a second copy of 3.6 B f32
params would not fit beside the first) and returns them.

The schedule is computed on the host in float32, as the reference's
scalar ops round: ``cos`` is the C library's ``cosf`` (XLA's CPU ``cos``
is, bit for bit); ``b ** step`` is the double-precision power rounded
once, equal to XLA's float32 ``pow`` for every step below 58 at b = 0.9
and apart in 0.8% of the steps up to 20,000. ``global_norm`` sums each
leaf's squares (flattened) and then the stacked leaf sums in XLA's window
order (``core.graph.xla_sum``); XLA reduces some multi-dimensional leaves
in another order, so the norm may round apart from the reference's.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.graph import xla_sum

_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.cosf.restype = ctypes.c_float
_LIBM.cosf.argtypes = [ctypes.c_float]
F32 = np.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    mu: dict             # name -> f32 tensor
    nu: dict


def named_params(params) -> dict:
    """``params`` (an ``nn.Module`` or a dict of tensors) as a dict."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params) -> OptState:
    p = named_params(params)
    dev = next(iter(p.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu={k: torch.zeros_like(v, dtype=torch.float32) for k, v in p.items()},
                    nu={k: torch.zeros_like(v, dtype=torch.float32) for k, v in p.items()})


def _schedule(cfg: AdamWConfig, step: int) -> np.float32:
    """The learning rate at ``step`` (float32 host arithmetic, the
    reference's order of operations)."""
    s = F32(step)
    warm = np.minimum(s / F32(max(cfg.warmup_steps, 1)), F32(1.0))
    frac = np.clip((s - F32(cfg.warmup_steps))
                   / F32(max(cfg.total_steps - cfg.warmup_steps, 1)), F32(0.0), F32(1.0))
    cos = F32(0.5) * (F32(1.0) + F32(_LIBM.cosf(F32(np.pi) * frac)))
    return F32(cfg.lr) * warm * (F32(0.1) + F32(0.9) * cos)


def _power(b: float, step: int) -> np.float32:
    return F32(float(F32(b)) ** step)


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's summed squares (f32).
    DTensor leaves (a sharded state) sum their shards: each leaf's sum of
    squares is a partial over its sharded axes, the leaves are added in
    order and reduced once, and the norm is replicated."""
    from ..models.sharding import is_dtensor
    if any(is_dtensor(g) for g in grads.values()):
        total = None
        for g in grads.values():
            s = g.float().square().sum()
            total = s if total is None else total + s
        return torch.sqrt(total.redistribute(total.device_mesh,
                                             _replicate(total.device_mesh)))
    sums = [xla_sum(g.float().square().reshape(-1)) for g in grads.values()]
    return torch.sqrt(xla_sum(torch.stack(sums)))


def _replicate(mesh) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, opt_state: OptState, params):
    """Returns ``(params, opt_state, {"grad_norm", "lr"})``, updated in place
    (see the module docstring). A param missing from ``grads`` or with a
    ``None`` gradient takes a zero gradient, as JAX gives one."""
    p = named_params(params)
    grads = {k: (grads.get(k) if grads.get(k) is not None else torch.zeros_like(v))
             for k, v in p.items()}
    step = int(opt_state.step) + 1
    gnorm = global_norm(grads)
    dev = gnorm.device

    def scalar(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    # a tensor over a tensor: ``float / tensor`` is a reciprocal and a product
    scale = torch.clamp_max(scalar(cfg.grad_clip) / torch.clamp_min(gnorm, 1e-12), 1.0)
    lr = scalar(_schedule(cfg, step))
    b1c = scalar(F32(1.0) - _power(cfg.b1, step))
    b2c = scalar(F32(1.0) - _power(cfg.b2, step))
    for k, w in p.items():
        g = grads[k].float() * scale
        m, v = opt_state.mu[k], opt_state.nu[k]
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        del g
        upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        upd.add_(w.float() * cfg.weight_decay)
        w.copy_(w.float() - lr * upd)
        del upd
    opt = OptState(torch.tensor(step, dtype=torch.int32, device=opt_state.step.device),
                   opt_state.mu, opt_state.nu)
    return params, opt, {"grad_norm": gnorm, "lr": lr}
