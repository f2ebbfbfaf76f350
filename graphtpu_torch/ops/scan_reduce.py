"""Reductions over statically sorted segments (counterpart of
graphtpu/ops/scan_reduce.py). They serve the heavy rows of a slab plan.

Segment k occupies [indptr[k], indptr[k+1]) of a stream sorted by
segment. Empty segments yield the reduction identity.

    sum:     one float64 prefix sum, differenced at the segment ends by two
             K1 gathers (a scatter-add would sum in a varying order);
    min/max: one scatter reduction on the segment ids. The JAX package
             packs (segment << 32 | value) into a cummax; torch's cummax of
             one long vector runs in a single CUDA block (40 ms for the
             12.8M heavy edges of RMAT s20/ef32 on an H100 80GB HBM3 at
             700 W), while min and max are exact in any order.

The TPU's two-level lane scan for long float32 sums was a workaround for
XLA's cumsum on the TPU; here the prefix is float64 throughout.
"""

from __future__ import annotations

import torch

from graphtpu_torch.ops.gather import table_gather


def seg_sum_scan(
    values: torch.Tensor, indptr: torch.Tensor, acc_dtype=torch.float64, out_dtype=None
) -> torch.Tensor:
    """Per-segment sums: a ``acc_dtype`` prefix sum, differenced at the
    segment ends."""
    out_dtype = out_dtype or values.dtype
    c = torch.zeros(values.shape[0] + 1, dtype=acc_dtype, device=values.device)
    c[1:] = torch.cumsum(values.to(acc_dtype), 0)
    return (table_gather(c, indptr[1:]) - table_gather(c, indptr[:-1])).to(out_dtype)


def _seg_extreme(values, seg_ids, indptr, identity, reduce):
    """Per-segment min or max by one scatter reduction on the segment ids;
    empty segments keep the identity."""
    out = torch.full((indptr.shape[0] - 1,), identity, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, seg_ids.to(torch.int64), values, reduce, include_self=False)


def seg_max_scan(values, seg_ids, indptr, identity) -> torch.Tensor:
    """Per-segment max; ``seg_ids`` must be ascending and aligned with values."""
    return _seg_extreme(values, seg_ids, indptr, identity, "amax")


def seg_min_scan(values, seg_ids, indptr, identity) -> torch.Tensor:
    """Per-segment min; ``seg_ids`` must be ascending and aligned with values."""
    return _seg_extreme(values, seg_ids, indptr, identity, "amin")
