"""Table gather on kernel K1 (counterpart of graphtpu/ops/gather.py).

``gather_rows(table, idx)`` is K1's wrapper: ``out[i, :] = table[idx[i], :]``
for a [R] or [R, C] table of 4- or 8-byte elements (int32, float32, int64,
float64) and int32 indices. ``table_gather(x, idx)`` is ``x[idx]`` for any
index shape; every gather of the port's main path runs through it.

The TPU's [n/W, W] row trick and its chunking knobs were layout
workarounds for XLA on the TPU; on the GPU a gather is a gather.
"""

from __future__ import annotations

import torch

from graphtpu_torch.ops import kernels


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K1's plain PyTorch version."""
    return table.index_select(0, idx)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, ...] = table[idx[i], ...]; ``idx`` int32 [N] in [0, R).

    On a CUDA tensor an index outside [0, R) gives a zero row; the plain
    version raises on it."""
    if table.dim() not in (1, 2) or table.element_size() not in (4, 8):
        raise TypeError(
            f"gather_rows: table must be 1-D or 2-D with 4- or 8-byte elements, "
            f"got shape {tuple(table.shape)} {table.dtype}"
        )
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"gather_rows: idx must be 1-D int32, got {idx.dim()}-D {idx.dtype}")
    if table.device != idx.device:
        raise ValueError(f"gather_rows: table on {table.device}, idx on {idx.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows: table and idx must be contiguous")
    if table.shape[0] >= 1 << 31 or idx.shape[0] >= 1 << 31:
        raise ValueError("gather_rows: tables and index vectors are limited to 2^31 - 1 rows")
    if not kernels.use_kernel(table):
        return gather_rows_plain(table, idx)
    out = torch.empty((idx.shape[0],) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    if idx.shape[0]:
        row_bytes = table.element_size() * (table.shape[1] if table.dim() == 2 else 1)
        kernels.launch(
            "gather_rows", table.device, table.data_ptr(), idx.data_ptr(),
            out.data_ptr(), idx.shape[0], table.shape[0], row_bytes,
        )
    return out


def table_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for a 1-D table ``x`` and int32 indices of any shape in [0, len(x))."""
    flat = gather_rows(x.contiguous(), idx.contiguous().reshape(-1))
    return flat.reshape(idx.shape)
