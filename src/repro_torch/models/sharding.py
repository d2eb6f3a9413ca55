"""The context threaded through the port's models: one device, no mesh.

The reference's ``ShardCtx`` (``repro/models/sharding.py``) carries a mesh,
its axis names and a set of knobs. On one card the mesh has one device, so
the port keeps the knobs that change what its prefill, decode and training
run there and makes ``constrain`` the identity. Sharding over several
devices (a mesh, ``attn_seq_shard``, expert parallelism) is ROADMAP.md,
Queue 1, item 10, "``launch/``", and raises here.

``remat`` is the reference's training knob: the training loss recomputes
each layer (``transformer.backbone``: an xLSTM layer, a hybrid super-block,
a block; whisper's encoder and decoder layers) in the backward pass instead
of keeping its activations (``"full"``, the reference's default and what a
``None`` ctx gets), or keeps only the matrix products' outputs
(``"dots"``, the reference's ``dots_with_no_batch_dims_saveable``: the
``x @ w`` products, ``aten.mm``; attention's batched products are
recomputed). ``"none"`` (the port's own value) keeps every activation, to
measure what remat saves. It changes no value, only memory and time.
"""
from __future__ import annotations

import dataclasses
import functools

import torch


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    use_flash: bool = False        # attention through the flash kernel
    # (kernels/flashattn.py): no [B, H, S, S] logits in device memory
    bf16_attn: bool = False        # QK^T and RoPE in the compute dtype
    cast_params_once: bool = False  # cast each block's f32 params to bf16
    # before it runs (the reference does it before the layer scan)
    slstm_chunk: int = 1           # sLSTM timesteps per scan iteration of
    # the reference; the port steps one position at a time whatever it is
    remat: str = "full"            # full | dots | none (see the docstring)
    attn_seq_shard: bool = False   # context parallelism: needs a mesh
    mesh: object = None

    def __post_init__(self):
        if self.remat not in ("full", "dots", "none"):
            raise ValueError(f"remat must be 'full', 'dots' or 'none', got {self.remat!r}")
        if self.mesh is not None or self.attn_seq_shard:
            raise NotImplementedError(
                "repro_torch runs on one device: meshes and attn_seq_shard are "
                "ROADMAP.md, Queue 1, item 10, 'launch/'")

    def constrain(self, x, *spec):
        return x


def _save_products(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(ctx: ShardCtx | None, fn, *args):
    """``fn(*args)``, recomputed in the backward pass as ``ctx.remat`` says
    (a ``None`` ctx: ``"full"``). Without grad mode it is a plain call."""
    mode = ctx.remat if ctx is not None else "full"
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts
    if mode == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_products))
    return checkpoint(fn, *args, use_reentrant=False)
