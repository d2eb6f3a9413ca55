"""CUDA kernel for flash attention: ``csrc/flash_attention.cu``.

``flash_attention_cuda`` replaces the TPU kernel
``repro/kernels/flashattn.py:flash_attention_pallas``: tiled online-softmax
SDPA, scale ``D^-1/2``, causal and sliding-window masks, f32 softmax
statistics and accumulation, the output in the input type. It reads the
model's layout in place: q ``[B, S, H, D]`` and k, v ``[B, S, Hkv, D]``,
contiguous, with query head h reading KV head ``h // (H // Hkv)`` (the
reference's ``jnp.repeat``), and writes o ``[B, S, H, D]``. Nothing is
expanded, transposed or copied on the way in.

The dtype picks the kernel; there is no fallback between the two:

* bf16: the tensor cores, ``wgmma`` fed by TMA (Hopper, ``sm_90a``). P is
  kept to f32 accuracy as a sum of two bf16 parts. The TMA row stride must
  be a multiple of 16 bytes, so a D that is not a multiple of 8 is
  zero-padded to a multiple of 16 here (the repo's smoke configs' D 12;
  never the full configs' 64 or 128).
* f32: the CUDA cores. The tensor cores take f32 only as TF32, whose
  10-bit mantissa cannot hold the f32 tolerance.

The plain version is ``kernels/ref.py:flash_bshd_ref`` (``flash_ref`` on
the expanded, flattened heads); the sums run in another order, so the two
agree within a tolerance (f32 rounding; one bf16 rounding of the output).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

MAX_D = 256


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """o [B, S, H, D] for q [B, S, H, D], k/v [B, S, Hkv, D] of one dtype
    (bf16 or f32), contiguous (a strided view raises: it is not copied)."""
    _build.require_cuda("flash_attention", q, k, v)
    _build.require_dtype("flash_attention", q, torch.float32, torch.bfloat16)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be [B, S, H, D] and k, v [B, S, Hkv, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != D or Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of Hkv)")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"flash_attention: D must be in [1, {MAX_D}], got {D}")
    if not (B and S and H):
        return torch.empty_like(q)
    scale = D ** -0.5
    if q.dtype == torch.bfloat16:
        fn = "flash_attention_bf16"
        if D % 8:
            q, k, v = (F.pad(x, (0, -D % 16)) for x in (q, k, v))
    else:
        fn = "flash_attention_f32"
    o = torch.empty_like(q)
    _build.launch("flash_attention", fn, q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), B, S, H, Hkv, q.shape[3], scale,
                  int(causal), int(window))
    return o if o.shape[3] == D else o[..., :D].contiguous()
