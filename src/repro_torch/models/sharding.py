"""The context threaded through the port's models: one device, no mesh.

The reference's ``ShardCtx`` (``repro/models/sharding.py``) carries a mesh,
its axis names and a set of knobs. On one card the mesh has one device, so
the port keeps the knobs that change what its prefill and decode run there
and makes ``constrain`` the identity. The reference's ``remat`` (a training
knob) comes with the slice that ports training (ROADMAP.md, Queue 1, item
9, "``train/``"). Sharding over several devices (a mesh, ``attn_seq_shard``,
expert parallelism) is ROADMAP.md, Queue 1, item 10, "``launch/``", and
raises here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    use_flash: bool = False        # attention through the flash kernel
    # (kernels/flashattn.py): no [B, H, S, S] logits in device memory
    bf16_attn: bool = False        # QK^T and RoPE in the compute dtype
    cast_params_once: bool = False  # cast each block's f32 params to bf16
    # before it runs (the reference does it before the layer scan)
    slstm_chunk: int = 1           # sLSTM timesteps per scan iteration of
    # the reference; the port steps one position at a time whatever it is
    attn_seq_shard: bool = False   # context parallelism: needs a mesh
    mesh: object = None

    def __post_init__(self):
        if self.mesh is not None or self.attn_seq_shard:
            raise NotImplementedError(
                "repro_torch runs on one device: meshes and attn_seq_shard are "
                "ROADMAP.md, Queue 1, item 10, 'launch/'")

    def constrain(self, x, *spec):
        return x
