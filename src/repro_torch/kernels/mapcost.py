"""CUDA kernel for J(C, D, Pi), the communication cost of a mapping.

Launches ``csrc/mapcost.cu`` (which replaces the TPU kernel
``repro/kernels/mapcost.py:mapcost_pallas``): one f32 partial per thread
block, summed and halved here, as the TPU wrapper summed its per-tile
partials. The order of the sum differs from the plain version
(``kernels/ref.py:mapcost_ref``), so the two agree within a relative
tolerance, and exactly when all partial sums are integers below 2^24.
"""
from __future__ import annotations

import torch

from . import _build

THREADS = 256
MAX_BLOCKS = 132 * 8   # 8 blocks of 256 threads per SM; grid-stride beyond


def mapcost_cuda(rows, cols, ewgt, pe_of, g_below, dvec) -> torch.Tensor:
    """J over directed edge arrays (padding weight 0); a 0-dim f32 tensor."""
    _build.require_cuda("mapcost", rows, cols, ewgt, pe_of, g_below, dvec)
    for t in (rows, cols, pe_of, g_below):
        _build.require_dtype("mapcost", t, torch.int32)
    for t in (ewgt, dvec):
        _build.require_dtype("mapcost", t, torch.float32)
    M, N, l = rows.shape[0], pe_of.shape[0], g_below.shape[0]
    if cols.shape[0] != M or ewgt.shape[0] != M or dvec.shape[0] != l or N == 0:
        raise ValueError("mapcost: rows/cols/ewgt must share M, g_below/dvec "
                         "must share l, and pe_of must be non-empty")
    blocks = max(1, min(MAX_BLOCKS, (M + THREADS - 1) // THREADS))
    partial = torch.empty(blocks, dtype=torch.float32, device=rows.device)
    _build.launch("mapcost", "mapcost_f32", rows.device, rows.data_ptr(),
                  cols.data_ptr(), ewgt.data_ptr(), pe_of.data_ptr(),
                  g_below.data_ptr(), dvec.data_ptr(), partial.data_ptr(),
                  M, N, l, blocks)
    return partial.sum() / 2.0
