"""Slab (padded-ELL) semiring SpMV (counterpart of graphtpu/ops/spmv.py).

Per degree bucket, y[row] = (+)_w w * x[slab[w, row]]; the heavy rows
reduce their edge stream by segment scans; one inverse-permutation gather
assembles the result. Without edge values, the plus bucket body over floats
is kernel K3 (``slab_spmv_sum``, PageRank's slab step) and the min bucket
body over int32 is kernel K6 (``slab_spmv_min``, WCC's full step), whose
heavy rows reduce on kernel K7. Both take all buckets of a plan in one
launch (``slab_spmv_sum_buckets``, ``slab_spmv_min_buckets``) and write
straight into the step's result buffer. Other semirings run as torch ops.

K7 (``csr_pull_reduce``) is also the dense steps' edge-stream reduction:
per row of a pull CSR, the max or min of x over its in-edges, or the min of
x + w (BFS, WCC and SSSP).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.semiring import Semiring
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import kernels
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.slab import (
    BucketTable, SlabPlan, assemble, build_slab_plan, check_result_buffer, fill_buckets,
    result_buffer,
)


def slab_spmv_sum_plain(slab: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K3's plain PyTorch version."""
    valid = (slab >= 0) & (slab < x.shape[0])
    xv = x.index_select(0, torch.where(valid, slab, 0).reshape(-1)).reshape(slab.shape)
    return torch.where(valid, xv, torch.zeros((), dtype=x.dtype, device=x.device)).sum(
        0, dtype=x.dtype
    )


def _check_sum(slabs, x: torch.Tensor) -> None:
    if x.dim() != 1 or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"slab_spmv_sum: x must be 1-D float32/float64, got {x.dim()}-D {x.dtype}")
    for slab in slabs:
        if slab.dtype != torch.int32 or slab.dim() != 2 or slab.shape[0] < 1:
            raise TypeError(f"slab_spmv_sum: slab must be 2-D int32 with W >= 1, got "
                            f"{tuple(slab.shape)} {slab.dtype}")
        if slab.device != x.device:
            raise ValueError(f"slab_spmv_sum: slab on {slab.device}, x on {x.device}")
        if not slab.is_contiguous():
            raise ValueError("slab_spmv_sum: slab and x must be contiguous")
    if not x.is_contiguous():
        raise ValueError("slab_spmv_sum: slab and x must be contiguous")


def _launch_sum(table: BucketTable, x: torch.Tensor, y: torch.Tensor) -> None:
    for desc, count in table.launches():
        kernels.launch("slab_spmv_sum", y.device, desc, count, x.data_ptr(), y.data_ptr(),
                       x.shape[0], int(x.dtype == torch.float64))


def slab_spmv_sum(slab: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K3 wrapper: y[r] = sum over w of x[slab[w, r]] for an int32 [W, R]
    slab (-1 = pad) and a float32/float64 table x."""
    _check_sum([slab], x)
    if not kernels.use_kernel(slab):
        return slab_spmv_sum_plain(slab, x)
    y = torch.empty(slab.shape[1], dtype=x.dtype, device=x.device)
    _launch_sum(BucketTable([slab]), x, y)
    return y


def slab_spmv_sum_buckets(plan: SlabPlan, x: torch.Tensor, out: torch.Tensor) -> None:
    """K3 over every bucket of ``plan`` in one launch: bucket k's sums go
    to ``out[offsets[k] : offsets[k] + R_k]`` (``plan.table``). ``out`` is a
    contiguous result buffer of x's dtype on the plan's device."""
    _check_sum([b.slab for b in plan.slabs], x)
    check_result_buffer("slab_spmv_sum_buckets", out, x.dtype, plan)
    if not kernels.use_kernel(out):
        fill_buckets(plan, out, lambda b: slab_spmv_sum_plain(b.slab, x))
        return
    _launch_sum(plan.table, x, out)


def slab_spmv_min_plain(slab: torch.Tensor, x: torch.Tensor | None, n: int) -> torch.Tensor:
    """K6's plain PyTorch version."""
    valid = (slab >= 0) & (slab < n)
    ids = torch.where(valid, slab, 0)
    vals = ids if x is None else x.index_select(0, ids.reshape(-1)).reshape(slab.shape)
    return torch.where(valid, vals, INT32_INF).min(0).values


def _check_min(slabs, x: torch.Tensor | None, n: int) -> None:
    for slab in slabs:
        if slab.dtype != torch.int32 or slab.dim() != 2 or slab.shape[0] < 1:
            raise TypeError(f"slab_spmv_min: slab must be 2-D int32 with W >= 1, got "
                            f"{tuple(slab.shape)} {slab.dtype}")
        if not slab.is_contiguous():
            raise ValueError("slab_spmv_min: slab must be contiguous")
        if x is not None and x.device != slab.device:
            raise ValueError("slab_spmv_min: x must be contiguous, on the slab's device")
    if x is not None:
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != n:
            raise TypeError(f"slab_spmv_min: x must be 1-D int32 of {n} entries")
        if not x.is_contiguous():
            raise ValueError("slab_spmv_min: x must be contiguous, on the slab's device")


def _launch_min(table: BucketTable, x: torch.Tensor | None, y: torch.Tensor, n: int) -> None:
    for desc, count in table.launches():
        kernels.launch("slab_spmv_min", y.device, desc, count,
                       None if x is None else x.data_ptr(), y.data_ptr(), n)


def slab_spmv_min(slab: torch.Tensor, x: torch.Tensor | None, n: int) -> torch.Tensor:
    """K6 wrapper: y[r] = min over w of x[slab[w, r]] for an int32 [W, R]
    slab (-1 = pad, ids outside [0, n) count as pad) and an int32 table x
    of n entries; with x None, the min of the stored ids (identity mode).
    INT32_INF for a row without entries."""
    _check_min([slab], x, n)
    if not kernels.use_kernel(slab):
        return slab_spmv_min_plain(slab, x, n)
    y = torch.empty(slab.shape[1], dtype=torch.int32, device=slab.device)
    _launch_min(BucketTable([slab]), x, y, n)
    return y


def slab_spmv_min_buckets(plan: SlabPlan, x: torch.Tensor | None, n: int,
                          out: torch.Tensor) -> None:
    """K6 over every bucket of ``plan`` in one launch: bucket k's minima go
    to ``out[offsets[k] : offsets[k] + R_k]`` (``plan.table``). ``out`` is a
    contiguous int32 result buffer on the plan's device."""
    _check_min([b.slab for b in plan.slabs], x, n)
    check_result_buffer("slab_spmv_min_buckets", out, torch.int32, plan)
    if not kernels.use_kernel(out):
        fill_buckets(plan, out, lambda b: slab_spmv_min_plain(b.slab, x, n))
        return
    _launch_min(plan.table, x, out, n)


def int32_tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


class PullCSR(NamedTuple):
    """In-edges on a device: ``src`` sorted by (dst, src), ``indptr`` [n+1]."""

    src: torch.Tensor
    indptr: torch.Tensor


def pull_csr(graph: Graph, device) -> PullCSR:
    """The graph's pull CSR on ``device``, memoized on the Graph."""
    key = ("pull_csr", str(torch.device(device)))
    csr = graph.memo.get(key)
    if csr is None:
        s, _, _ = graph.pull_arrays()
        csr = PullCSR(int32_tensor(s, device), int32_tensor(graph.pull_indptr, device))
        graph.memo[key] = csr
    return csr


# K7 modes: (C mode by dtype, reduction, identity)
CSR_MODES = {
    "max_i32": ({torch.int32: 0}, "max", 0),
    "min_i32": ({torch.int32: 1}, "min", INT32_INF),
    "min_plus": ({torch.float32: 2, torch.float64: 3}, "min", float("inf")),
}


def csr_pull_reduce_plain(mode: str, x, src, indptr, w=None) -> torch.Tensor:
    """K7's plain PyTorch version: the K1 gather, then the segment
    reduction by one scatter on int64 segment ids expanded from ``indptr``."""
    _, kind, identity = CSR_MODES[mode]
    terms = src if x is None else table_gather(x, src)
    if w is not None:
        terms = terms + w
    n = indptr.shape[0] - 1
    seg_ids = torch.repeat_interleave(torch.arange(n, device=src.device), indptr.diff(),
                                      output_size=src.shape[0])
    return pull_reduce(kind, terms, seg_ids, indptr, identity)


def csr_pull_reduce(mode: str, x: torch.Tensor | None, src: torch.Tensor,
                    indptr: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """K7 wrapper: y[v] over the in-edges e of v, [indptr[v], indptr[v+1])
    of the pull-ordered ``src`` (indptr[-1] = len(src)): ``max_i32`` max of
    x[src[e]] (0 for a row without edges), ``min_i32`` min of x[src[e]]
    (INT32_INF), ``min_plus`` min of x[src[e]] + w[e] in x's float dtype
    (+inf). In the int32 modes x None reads src[e] itself. All index
    tensors int32, contiguous."""
    if mode not in CSR_MODES:
        raise ValueError(f"csr_pull_reduce: unknown mode {mode!r}")
    codes, _, _ = CSR_MODES[mode]
    if mode == "min_plus" and (x is None or w is None):
        raise ValueError("csr_pull_reduce: min_plus takes both x and w")
    if mode != "min_plus" and w is not None:
        raise ValueError(f"csr_pull_reduce: {mode} takes no w")
    dtype = torch.int32 if x is None else x.dtype
    if dtype not in codes or (w is not None and w.dtype != dtype):
        raise TypeError(f"csr_pull_reduce: {mode} does not take {dtype} values")
    ts = [t for t in (x, src, indptr, w) if t is not None]
    if any(t.dim() != 1 for t in ts) or any(t.dtype != torch.int32 for t in (src, indptr)):
        raise TypeError("csr_pull_reduce: 1-D tensors, with int32 src and indptr")
    if any(t.device != src.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("csr_pull_reduce: inputs must be contiguous, on one device")
    if not kernels.use_kernel(src):
        return csr_pull_reduce_plain(mode, x, src, indptr, w)
    n = indptr.shape[0] - 1
    y = torch.empty(n, dtype=dtype, device=src.device)
    if n:
        kernels.launch(
            "csr_pull_reduce", src.device, indptr.data_ptr(), src.data_ptr(),
            None if x is None else x.data_ptr(), None if w is None else w.data_ptr(),
            y.data_ptr(), n, codes[dtype],
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


def _slab_min_kernels(semiring: Semiring, plan: SlabPlan, x: torch.Tensor) -> bool:
    """min over int32 without edge values: the buckets run on K6, the heavy rows on K7."""
    return (semiring.add.name == "min" and x.dtype == torch.int32
            and plan.heavy_values is None and all(b.values is None for b in plan.slabs))


def slab_spmv(semiring: Semiring, plan: SlabPlan, x: torch.Tensor, n: int) -> torch.Tensor:
    """y[v] = (+)_{(u,v)} (w_uv * x[u]) over the slab plan; rows with no
    edges get the monoid identity."""
    ident = semiring.add.identity(x.dtype)
    min_kernels = _slab_min_kernels(semiring, plan, x)
    buf = result_buffer(plan, x.dtype)
    if min_kernels:
        slab_spmv_min_buckets(plan, x, n, buf)
    elif (semiring.add.name == "plus" and x.dtype in _K3_DTYPES
          and all(b.values is None for b in plan.slabs)):
        slab_spmv_sum_buckets(plan, x, buf)
    else:
        def bucket_body(bucket):
            valid = bucket.slab >= 0
            xv = table_gather(x, torch.where(valid, bucket.slab, 0))
            terms = semiring.mul(bucket.values, xv) if bucket.values is not None else xv
            terms = torch.where(valid, terms,
                                torch.tensor(ident, dtype=terms.dtype, device=x.device))
            return _REDUCE[semiring.add.name](terms)

        fill_buckets(plan, buf, bucket_body)
    heavy = None
    if plan.heavy_rows is not None and min_kernels:
        heavy = csr_pull_reduce("min_i32", x, plan.heavy_neigh, plan.heavy_indptr)
    elif plan.heavy_rows is not None:
        hx = table_gather(x, plan.heavy_neigh)
        terms = semiring.mul(plan.heavy_values, hx) if plan.heavy_values is not None else hx
        heavy = pull_reduce(
            _SEG_KIND[semiring.add.name], terms, plan.heavy_centers, plan.heavy_indptr, ident
        )
    rest = None
    if plan.rest_rows is not None:
        rest = torch.full((plan.rest_rows.shape[0],), ident, dtype=x.dtype, device=x.device)
    return assemble(plan, buf, heavy, rest)
