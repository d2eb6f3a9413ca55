"""CUDA gather kernel backing the device-resident induced-subgraph split.

``split_blocks`` (core/graph.py) builds every child array by one masked
row gather from a flat source vector, ``out[b, j] = src[idx[b, j]]``. This
wrapper launches ``csrc/gather_rows.cu`` (which replaces the TPU kernel
``repro/kernels/split.py:gather_rows_pallas``). Pure data movement, so it
is bitwise the plain version's (``kernels/ref.py:gather_rows_ref``).
"""
from __future__ import annotations

import torch

from . import _build


def gather_rows_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, j] = src[clip(idx[b, j])] for 1-D f32/i32 ``src`` and [k, L] i32 ``idx``."""
    _build.require_cuda("gather_rows", src, idx)
    _build.require_dtype("gather_rows", src, torch.float32, torch.int32)
    _build.require_dtype("gather_rows", idx, torch.int32)
    if src.dim() != 1 or idx.dim() != 2 or src.shape[0] == 0:
        raise ValueError(f"gather_rows: need a non-empty 1-D src and a 2-D idx, "
                         f"got {tuple(src.shape)} and {tuple(idx.shape)}")
    out = torch.empty(idx.shape, dtype=src.dtype, device=src.device)
    if idx.numel():
        _build.launch("gather_rows", "gather_rows_u32", src.device, src.data_ptr(),
                      idx.data_ptr(), out.data_ptr(), src.shape[0], idx.numel())
    return out
