"""Slab (padded-ELL) semiring SpMV (counterpart of graphtpu/ops/spmv.py).

Per degree bucket, y[row] = (+)_w w * x[slab[w, row]]; the heavy rows
reduce their edge stream by segment scans; one inverse-permutation gather
assembles the result. For the plus monoid without edge values the bucket
body is kernel K3 (``slab_spmv_sum``), the whole of PageRank's slab step.
Other semirings run the bucket body as torch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.semiring import Semiring
from graphtpu_torch.ops import kernels
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.slab import SlabPlan, assemble, build_slab_plan


def slab_spmv_sum_plain(slab: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K3's plain PyTorch version."""
    valid = (slab >= 0) & (slab < x.shape[0])
    xv = x.index_select(0, torch.where(valid, slab, 0).reshape(-1)).reshape(slab.shape)
    return torch.where(valid, xv, torch.zeros((), dtype=x.dtype, device=x.device)).sum(
        0, dtype=x.dtype
    )


def slab_spmv_sum(slab: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K3 wrapper: y[r] = sum over w of x[slab[w, r]] for an int32 [W, R]
    slab (-1 = pad) and a float32/float64 table x."""
    if slab.dtype != torch.int32 or slab.dim() != 2:
        raise TypeError(f"slab_spmv_sum: slab must be 2-D int32, got {slab.dim()}-D {slab.dtype}")
    if x.dim() != 1 or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"slab_spmv_sum: x must be 1-D float32/float64, got {x.dim()}-D {x.dtype}")
    if slab.device != x.device:
        raise ValueError(f"slab_spmv_sum: slab on {slab.device}, x on {x.device}")
    if not (slab.is_contiguous() and x.is_contiguous()):
        raise ValueError("slab_spmv_sum: slab and x must be contiguous")
    if not kernels.use_kernel(slab):
        return slab_spmv_sum_plain(slab, x)
    w, r = slab.shape
    y = torch.empty(r, dtype=x.dtype, device=x.device)
    if r:
        kernels.launch(
            "slab_spmv_sum", slab.device, slab.data_ptr(), x.data_ptr(), y.data_ptr(),
            w, r, x.shape[0], int(x.dtype == torch.float64),
        )
    return y


def pull_reduce(kind: str, terms: torch.Tensor, seg_ids: torch.Tensor,
                indptr: torch.Tensor, identity) -> torch.Tensor:
    """Reduce per-edge ``terms`` into per-segment values over statically
    sorted segments by packed scans (ops/scan_reduce.py)."""
    from graphtpu_torch.ops.scan_reduce import seg_max_scan, seg_min_scan, seg_sum_scan

    if kind == "sum":
        return seg_sum_scan(terms, indptr)
    if kind == "max":
        return seg_max_scan(terms, seg_ids, indptr, identity)
    if kind == "min":
        return seg_min_scan(terms, seg_ids, indptr, identity)
    raise ValueError(kind)


def build_pull_plan(graph: Graph, *, device, wdtype=np.float32, buckets=None,
                    with_values: bool = True) -> SlabPlan:
    """Slab plan over in-edges: centers = dst (pull order), neigh = src.
    ``with_values=False`` skips the value slabs (semirings with mul = second)."""
    s, d, w = graph.pull_arrays()
    centers = d.astype(np.int64)
    values = w.astype(wdtype) if with_values else None
    deg = np.bincount(centers, minlength=graph.n).astype(np.int64)
    return build_slab_plan(centers, s, deg, graph.n, buckets, values=values, device=device)


_REDUCE = {
    "plus": lambda t: t.sum(0, dtype=t.dtype),
    "min": lambda t: t.min(0).values,
    "max": lambda t: t.max(0).values,
    "lor": lambda t: t.max(0).values,
}
_K3_DTYPES = (torch.float32, torch.float64)
_SEG_KIND = {"plus": "sum", "min": "min", "max": "max", "lor": "max"}


def slab_spmv(semiring: Semiring, plan: SlabPlan, x: torch.Tensor, n: int) -> torch.Tensor:
    """y[v] = (+)_{(u,v)} (w_uv * x[u]) over the slab plan; rows with no
    edges get the monoid identity."""
    ident = semiring.add.identity(x.dtype)
    parts = []
    for bucket in plan.slabs:
        if semiring.add.name == "plus" and bucket.values is None and x.dtype in _K3_DTYPES:
            parts.append(slab_spmv_sum(bucket.slab, x))
            continue
        valid = bucket.slab >= 0
        xv = table_gather(x, torch.where(valid, bucket.slab, 0))
        terms = semiring.mul(bucket.values, xv) if bucket.values is not None else xv
        terms = torch.where(valid, terms, torch.tensor(ident, dtype=terms.dtype, device=x.device))
        parts.append(_REDUCE[semiring.add.name](terms))
    heavy = None
    if plan.heavy_rows is not None:
        hx = table_gather(x, plan.heavy_neigh)
        terms = semiring.mul(plan.heavy_values, hx) if plan.heavy_values is not None else hx
        heavy = pull_reduce(
            _SEG_KIND[semiring.add.name], terms, plan.heavy_centers, plan.heavy_indptr, ident
        )
    rest = None
    if plan.rest_rows is not None:
        rest = torch.full((plan.rest_rows.shape[0],), ident, dtype=x.dtype, device=x.device)
    return assemble(plan, parts, heavy, rest)
