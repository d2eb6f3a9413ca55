"""CUDA kernel for flash attention: ``csrc/flash_attention.cu``.

``flash_attention_cuda`` replaces the TPU kernel
``repro/kernels/flashattn.py:flash_attention_pallas``: tiled online-softmax
SDPA over ``[BH, S, D]`` slices, scale ``D^-1/2``, causal and sliding-window
masks, f32 accumulation and the output in the input type. Unlike the TPU
wrapper it pads nothing: the kernel masks the ragged edge of S and pads D to
its template width in shared memory. Its plain version is
``kernels/ref.py:flash_ref``; the sums run in another order, so the two agree
within a tolerance (f32 rounding; bf16 output rounding for bf16 inputs).
"""
from __future__ import annotations

import torch

from . import _build

MAX_D = 256


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """o [BH, S, D] for q, k, v [BH, S, D] of one dtype (bf16 or f32)."""
    _build.require_cuda("flash_attention", q, k, v)
    _build.require_dtype("flash_attention", q, torch.float32, torch.bfloat16)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must be [BH, S, D] of one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, S, D = q.shape
    if not 1 <= D <= MAX_D:
        raise ValueError(f"flash_attention: D must be in [1, {MAX_D}], got {D}")
    o = torch.empty_like(q)
    if BH and S:
        fn = "flash_attention_bf16" if q.dtype == torch.bfloat16 else "flash_attention_f32"
        _build.launch("flash_attention", fn, q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), BH, S, D, D ** -0.5, int(causal),
                      int(window))
    return o
