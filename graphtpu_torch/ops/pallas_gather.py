"""Row gather from a 128-wide table (counterpart of
graphtpu/ops/pallas_gather.py:95 dma_row_gather).

On the TPU ``dma_row_gather`` drives one 512 B DMA per index from an
HBM-resident table, its block and slot counts bounded by the scalar
prefetch staged in SMEM. On the GPU the same contract is kernel K1 with
C = 128: one warp per row, 16 B per lane, one coalesced 512 B access per
row, and no bound on the index count. ``vreg_shuffle`` (the single-vreg
Mosaic shuffle) is not ported yet (ROADMAP Queue 2a).
"""

from __future__ import annotations

import torch

from graphtpu_torch.ops.gather import gather_rows


def dma_row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]] for a [R, 128] int32/float32 table and
    int32 indices [N]."""
    if table.dim() != 2 or table.shape[1] != 128 or table.element_size() != 4:
        raise TypeError(
            f"dma_row_gather: table must be [R, 128] of 4-byte elements, got "
            f"{tuple(table.shape)} {table.dtype}"
        )
    return gather_rows(table, idx)
