"""The train step: loss -> grads -> AdamW (the port of
``repro/train/train_step.py``).

``make_train_step`` differentiates the port's ``loss_fn`` as the reference
differentiates its own (``jax.value_and_grad``): one forward with each
layer recomputed in the backward pass as ``ctx.remat`` says, then
``torch.autograd.grad`` over every parameter. A parameter the loss never
reaches (xLSTM layers without a feed-forward keep an unused ``norm2``)
gets a zero gradient, as JAX gives, so AdamW still decays it. Attention
runs through ``_sdpa``: the flash kernel has no backward, in either
package. Under a mesh ctx the params, the moments and the batch are
DTensors (``launch/shardings.py`` places them) and the same step runs as
eager SPMD: gradients are reduced to their params' placements, AdamW is
elementwise per shard, and ``global_norm`` sums over shards.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import model as M
from ..models.config import ModelConfig
from ..models.convert import params_from_jax, reference_leaf
from ..models.sharding import ShardCtx, is_dtensor, on_mesh
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state


class TrainState(NamedTuple):
    params: torch.nn.Module   # DecoderLM | EncDecLM, every param requiring grad
    opt: OptState


def train_state(params: torch.nn.Module) -> TrainState:
    """A fresh train state around ``params`` (their grads turned on)."""
    for w in params.parameters():
        w.requires_grad_(True)
    return TrainState(params=params, opt=init_opt_state(params))


def init_train_state(cfg: ModelConfig, generator: torch.Generator | int = 0,
                     device=None, V: int = 1) -> TrainState:
    """``init_fn``'s params from ``generator`` (or an int seed on
    ``device``; ``None`` = the card) and a zero optimizer state; ``V`` the
    MoE's virtual expert shards."""
    return train_state(M.init_fn(cfg, generator, device, V=V))


def train_state_from_jax(cfg: ModelConfig, params, opt=None, device=None) -> TrainState:
    """The reference's ``TrainState`` carried across: ``params`` as nested
    dicts of arrays (``params_from_jax``), and ``opt`` (its ``OptState``:
    ``step``, ``mu``, ``nu``; a fresh one if ``None``)."""
    state = train_state(params_from_jax(cfg, params, device))
    if opt is None:
        return state
    dev = state.opt.step.device
    with torch.no_grad():
        for tree, dst in ((opt.mu, state.opt.mu), (opt.nu, state.opt.nu)):
            for name, t in dst.items():
                t.copy_(torch.as_tensor(np.array(reference_leaf(tree, name), np.float32)))
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32, device=dev)
    return TrainState(state.params, OptState(step, state.opt.mu, state.opt.nu))


def loss_and_grads(cfg: ModelConfig, params: torch.nn.Module, batch,
                   ctx: ShardCtx | None = None):
    """(loss, {name: grad}) of ``loss_fn`` at ``params``; a param the loss
    never reaches gets zeros. Under a mesh ctx (DTensor params) each
    gradient is placed as its param (the reduce-scatter / all-reduce of the
    partial sums) and the loss is a replicated DTensor scalar."""
    named = dict(params.named_parameters())
    with torch.enable_grad(), on_mesh(ctx):
        loss = M.loss_fn(cfg, params, batch, ctx)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        out = {}
        for (k, w), g in zip(named.items(), grads):
            g = g if g is not None else torch.zeros_like(w)
            if is_dtensor(g) and tuple(g.placements) != tuple(w.placements):
                g = g.redistribute(w.device_mesh, w.placements)
            out[k] = g
    return loss.detach(), out


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, ctx: ShardCtx | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state's
    params and moments are updated in place (``adamw_update``)."""

    def train_step(state: TrainState, batch):
        loss, grads = loss_and_grads(cfg, state.params, batch, ctx)
        with on_mesh(ctx):
            params, opt, metrics = adamw_update(opt_cfg, grads, state.opt, state.params)
        return TrainState(params, opt), {"loss": loss, **metrics}

    return train_step


def make_eval_step(cfg: ModelConfig, ctx: ShardCtx | None = None):
    @torch.no_grad()
    def eval_step(params, batch):
        return M.loss_fn(cfg, params, batch, ctx)
    return eval_step
