"""The two Pallas kernels of graphtpu/ops/pallas_gather.py, on the GPU.

``dma_row_gather`` (graphtpu/ops/pallas_gather.py:95): on the TPU it drives
one 512 B DMA per index from an HBM-resident table, its block and slot
counts bounded by the scalar prefetch staged in SMEM. On the GPU the same
contract is kernel K1 with C = 128: one warp per row, 16 B per lane, one
coalesced 512 B access per row, and no bound on the index count.

``vreg_shuffle`` (graphtpu/ops/pallas_gather.py:69): on the TPU, Mosaic's
single-vreg dynamic gather, each lane of an (8, 128) register choosing
among the 8 sublanes of its column. On the GPU it is kernel K4, one thread
per element. No path of the system calls it; the TPU prototype's
measurement script (scripts/perf/measure_pallas_gather.py) was its only
caller.
"""

from __future__ import annotations

import torch

from graphtpu_torch.ops import kernels
from graphtpu_torch.ops.gather import gather_rows

VREG_SHAPE = (8, 128)


def dma_row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]] for a [R, 128] int32/float32 table and
    int32 indices [N]."""
    if table.dim() != 2 or table.shape[1] != 128 or table.element_size() != 4:
        raise TypeError(
            f"dma_row_gather: table must be [R, 128] of 4-byte elements, got "
            f"{tuple(table.shape)} {table.dtype}"
        )
    return gather_rows(table, idx)


def vreg_shuffle_plain(tbl8: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """K4's plain PyTorch version."""
    return torch.gather(tbl8, 0, ind.long())


def vreg_shuffle(tbl8: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """out[i, j] = tbl8[ind[i, j], j] for an [8, 128] int32 or float32
    table and [8, 128] int32 indices in [0, 8). On a CUDA tensor an index
    outside [0, 8) gives 0; the plain version raises on it."""
    if tbl8.dtype not in (torch.int32, torch.float32) or tuple(tbl8.shape) != VREG_SHAPE:
        raise TypeError(f"vreg_shuffle: tbl8 must be [8, 128] int32 or float32, got "
                        f"{tuple(tbl8.shape)} {tbl8.dtype}")
    if ind.dtype != torch.int32 or tuple(ind.shape) != VREG_SHAPE:
        raise TypeError(f"vreg_shuffle: ind must be [8, 128] int32, got "
                        f"{tuple(ind.shape)} {ind.dtype}")
    if tbl8.device != ind.device or not (tbl8.is_contiguous() and ind.is_contiguous()):
        raise ValueError("vreg_shuffle: tbl8 and ind must be contiguous, on one device")
    if not kernels.use_kernel(tbl8):
        return vreg_shuffle_plain(tbl8, ind)
    out = torch.empty_like(tbl8)
    kernels.launch("vreg_shuffle", tbl8.device, tbl8.data_ptr(), ind.data_ptr(),
                   out.data_ptr(), VREG_SHAPE[1])
    return out
