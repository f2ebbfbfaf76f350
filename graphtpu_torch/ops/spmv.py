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
x + w (BFS, WCC and SSSP), and PageRank's segment-sum pull (``sum``, the
pr-impl=scan arm). On the card mode ``sum`` runs on a sliced pull
(``PullSlices``: the edges regrouped by slices of x that fit a block's
shared memory), built once per CSR and value size and memoized by the
callers (``memo_pull_slices``).
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


# K7: items of the merged list (row ends + edges) a block takes, by the
# size of a value (csrc/csr_pull_reduce.cu: K7_THREADS * K7Items)
CSR_ITEMS = {4: 256 * 9, 8: 256 * 5}


def csr_scratch_layout(n: int, m: int, itemsize: int):
    """K7's scratch for n rows and m edges of ``itemsize``-byte values:
    (blocks, byte offset of the carry values, bytes). The kernel keeps
    there the row each block starts in [blocks + 1] and each block's carry
    row [blocks], both int32, then from the next multiple of 8 bytes each
    block's carry value [blocks]."""
    ipb = CSR_ITEMS[itemsize]
    nb = (n + m + ipb - 1) // ipb
    val_off = (4 * (2 * nb + 1) + 7) // 8 * 8
    return nb, val_off, val_off + itemsize * nb


def merge_path_starts(indptr: torch.Tensor, items_per_block: int) -> torch.Tensor:
    """The plain version of K7's partition: for block b of the merged list
    of row ends and edges (n + m items, ``items_per_block`` a block), the
    number of row ends before diagonal d = min(b * items_per_block, n + m),
    as int32 [blocks + 1]: the first row r whose end lies past edge
    d - r - 1. Block b owns rows [starts[b], starts[b + 1]) to their ends
    and edges [d_b - starts[b], d_{b+1} - starts[b + 1])."""
    n, m = indptr.shape[0] - 1, int(indptr[-1])
    nb = (n + m + items_per_block - 1) // items_per_block
    d = torch.arange(nb + 1, dtype=torch.int64, device=indptr.device) * items_per_block
    d.clamp_(max=n + m)
    # row end r precedes edge e in the merged list iff indptr[r + 1] <= e:
    # r + indptr[r + 1] ascends strictly, and rows with r + indptr[r + 1] < d
    # are the ones a diagonal d has behind it
    key = torch.arange(n, dtype=torch.int64, device=indptr.device) + indptr[1:].long()
    return torch.searchsorted(key, d, right=False).to(torch.int32)


# K7 modes: (C mode by dtype, reduction, identity)
CSR_MODES = {
    "max_i32": ({torch.int32: 0}, "max", 0),
    "min_i32": ({torch.int32: 1}, "min", INT32_INF),
    "min_plus": ({torch.float32: 2, torch.float64: 3}, "min", float("inf")),
    "sum": ({torch.float32: 4, torch.float64: 5}, "sum", 0.0),
    "sum_i64": ({torch.int32: 6}, "sum", 0),  # int32 values, int64 sums
}
# the launch counter of each mode that has its own (ops/kernels.py COUNTERS)
_CSR_COUNTERS = {"sum": "csr_pull_reduce_sum", "sum_i64": "csr_pull_reduce_sum_i64"}


def csr_pull_reduce_plain(mode: str, x, src, indptr, w=None) -> torch.Tensor:
    """K7's plain PyTorch version: the K1 gather, then the segment
    reduction by one scatter on int64 segment ids expanded from ``indptr``;
    a sum adds in float64 (an index_add_), rounded once to x's dtype, and
    ``sum_i64`` in int64, exact."""
    _, kind, identity = CSR_MODES[mode]
    terms = src if x is None else table_gather(x, src)
    if w is not None:
        terms = terms + w
    n = indptr.shape[0] - 1
    seg_ids = torch.repeat_interleave(torch.arange(n, device=src.device), indptr.diff(),
                                      output_size=src.shape[0])
    if mode == "sum_i64":
        acc = torch.zeros(n, dtype=torch.int64, device=src.device)
        return acc.index_add_(0, seg_ids, terms.to(torch.int64))
    if kind == "sum":
        acc = torch.zeros(n, dtype=torch.float64, device=src.device)
        return acc.index_add_(0, seg_ids, terms.to(torch.float64)).to(terms.dtype)
    return pull_reduce(kind, terms, seg_ids, indptr, identity)


# K7's mode sum on a sliced pull (csrc/csr_pull_reduce.cu k7_reduce_sliced):
# the entries of x a slice holds, by the size of a value (192 KB of shared
# memory, most of an SM's 227 KB), the edges of a group (a thread's, with
# its head word) and of a tile (K7S_THREADS groups)
SLICE_WIDTH = {4: 49152, 8: 24576}
SLICE_GROUP = 16
SLICE_ITEMS = 512 * SLICE_GROUP
# mode sum takes the sliced pull where its layout holds at most one run in
# SLICE_RUN_EDGES edges, else the merge path: on an H100 the bench graph's
# pull took 0.19 ms sliced against 0.31 by the merge path in float32 (a run
# in 11.3 edges), 0.31 against 0.39 in float64 (a run in 8.0), its rows of
# 33-256 in-edges alone 0.073 against 0.059 (a run in 5.6) (PERF.md,
# tools/pull_sum_times.py)
SLICE_RUN_EDGES = 6


class PullSlices(NamedTuple):
    """A pull CSR's edges regrouped by slices of x for K7's mode sum, for
    values of one size: slice s holds x[s * width, (s + 1) * width). The
    stream holds each slice's edges in the CSR's (row, src) order, padded to
    whole groups of ``SLICE_GROUP``, and one group after the last slice,
    which closes the last run; each (row, slice) run of edges, and each
    slice's pad, starts at a head."""

    lid: torch.Tensor          # [M] int16, read as uint16: src - slice * width (pad: 0)
    head: torch.Tensor         # [M / 16] int32: bit i of word g: edge 16 g + i is a head;
    #                            bits 16-31: the heads of g's tile before g
    row_runs: torch.Tensor     # [real runs] int32: the real runs, row-major (a row's in
    #                            slice order); a run is numbered by the heads before it
    part_ptr: torch.Tensor     # [n + 1] int32: row r's entries of row_runs
    slice_edges: torch.Tensor  # [S + 1] int32: the stream's offset of each slice
    tile_edge: torch.Tensor    # [T + 1] int32: the stream's offset of each tile
    tile_run: torch.Tensor     # [T + 1] int32: the heads before each tile
    tile_slice: torch.Tensor   # [T] int32: each tile's slice
    width: int
    itemsize: int              # bytes of the values it was built for
    n_x: int                   # entries of x the edges read: max(src) + 1
    edges: int                 # the CSR's edges
    items: int                 # edges a tile: SLICE_ITEMS, the kernel's
    runs: int                  # the stream's runs, pad runs included

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self[:8])

    def moved_bytes(self) -> int:
        """What a sum over it must move, each input read once and each
        output written once: the stream's ids and heads, each run's partial
        written and read, the row-major list of runs and the row offsets,
        the entries of x the edges reach and y."""
        rows = self.part_ptr.shape[0] - 1
        return (2 * self.lid.shape[0] + 4 * self.head.shape[0] + 4 * self.row_runs.shape[0]
                + 4 * (rows + 1) + self.itemsize * (2 * self.runs + self.n_x + rows))


def build_pull_slices(src: torch.Tensor, indptr: torch.Tensor, itemsize: int,
                      width: int | None = None, items: int = SLICE_ITEMS) -> PullSlices:
    """The sliced layout of the pull CSR (src, indptr) for values of
    ``itemsize`` bytes, on src's device: the stream, its heads, the real
    runs row-major, and each slice's stream cut into tiles of ``items``
    edges. ``width`` (x entries a slice, by default ``SLICE_WIDTH``) and
    ``items`` other than the kernel's are for measuring other builds of
    it."""
    width = width or SLICE_WIDTH[itemsize]
    if not 0 < width <= 1 << 16 or width % 8 or items % SLICE_GROUP or items > 1 << 16:
        raise ValueError(f"build_pull_slices: width {width} not a multiple of 8 in (0, 2^16], "
                         f"or {items} items a tile not whole groups up to 2^16")
    dev = src.device
    n, m, grp = indptr.shape[0] - 1, src.shape[0], SLICE_GROUP
    i32, i64 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.int64, device=dev)
    row = torch.repeat_interleave(torch.arange(n, **i32), indptr.diff(), output_size=m)
    sl = torch.div(src, width, rounding_mode="floor")
    order = torch.sort(sl, stable=True).indices
    sl, row, local = sl[order], row[order], src[order] - sl[order] * width
    del order
    n_x = int(src.max()) + 1 if m else 0
    nslices = -(-n_x // width)
    real_head = torch.ones(m, dtype=torch.bool, device=dev)
    real_head[1:] = (sl[1:] != sl[:-1]) | (row[1:] != row[:-1])
    # the stream: each slice padded to whole groups, the closing group in the last
    count = torch.bincount(sl, minlength=nslices)
    padded = (count + grp - 1) // grp * grp
    if m:
        padded[-1] += grp
    start, real_start = torch.zeros(nslices + 1, **i64), torch.zeros(nslices + 1, **i64)
    start[1:], real_start[1:] = torch.cumsum(padded, 0), torch.cumsum(count, 0)
    total = int(start[-1])
    pos = start[sl] + torch.arange(m, **i64) - real_start[sl]
    lid = torch.zeros(total, dtype=torch.int16, device=dev)
    lid[pos] = torch.where(local >= 1 << 15, local - (1 << 16), local).to(torch.int16)
    heads = torch.zeros(total, dtype=torch.bool, device=dev)
    heads[pos] = real_head
    pad_at = start[:-1] + count
    heads[pad_at[pad_at < start[1:]]] = True
    heads_before = torch.zeros(total + 1, **i64)
    heads_before[1:] = torch.cumsum(heads, 0)
    # the real runs, slice by slice, then row-major
    seg_row = row[real_head]
    row_runs = heads_before[pos[real_head]][torch.sort(seg_row, stable=True).indices]
    part_ptr = torch.zeros(n + 1, **i32)
    part_ptr[1:] = torch.cumsum(torch.bincount(seg_row, minlength=n), 0)
    # the tiles: each slice's stream cut every `items` edges (a handful of slices)
    st = start.cpu().numpy()
    tiles = [np.arange(st[s], st[s + 1], items) for s in range(nslices)]
    tile_slice = np.concatenate([np.full(t.shape[0], s, np.int32) for s, t in enumerate(tiles)]
                                + [np.zeros(0, np.int32)])
    tile_edge = torch.from_numpy(np.concatenate(tiles + [np.array([total])])).to(dev)
    tile_run = heads_before[tile_edge]
    # a group's word: its heads, and above them its tile's heads before it
    group = torch.arange(0, total, grp, **i64)
    tile_of = torch.searchsorted(tile_edge, group, right=True) - 1
    word = (heads.view(-1, grp).long() << torch.arange(grp, **i64)).sum(1)
    word |= (heads_before[group] - tile_run[tile_of]) << grp
    head = torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)
    return PullSlices(lid, head, row_runs.to(torch.int32), part_ptr, start.to(torch.int32),
                      tile_edge.to(torch.int32), tile_run.to(torch.int32),
                      torch.from_numpy(tile_slice).to(dev), width, itemsize, n_x, m, items,
                      int(heads_before[-1]))


def memo_pull_slices(memo: dict, key, src: torch.Tensor, indptr: torch.Tensor,
                     dtype: torch.dtype) -> PullSlices | None:
    """The sliced layout of (src, indptr) for x of ``dtype``, built once and
    kept in ``memo`` (a Graph's memo, a rank's state) under a key made of
    ``key``; None where ``csr_pull_reduce`` takes its plain version."""
    if not kernels.use_kernel(src):
        return None
    k = ("pull_slices", key, str(dtype))
    sl = memo.get(k)
    if sl is None:
        sl = memo[k] = build_pull_slices(src, indptr, torch.empty(0, dtype=dtype).element_size())
    return sl


def pull_slices_heads(sl: PullSlices) -> torch.Tensor:
    """The stream's heads, one bool an edge."""
    bits = torch.arange(SLICE_GROUP, device=sl.head.device)
    return ((sl.head.long().unsqueeze(1) >> bits) & 1).reshape(-1).bool()


def pull_slices_sum_plain(sl: PullSlices, x: torch.Tensor) -> torch.Tensor:
    """The sliced pull's sum in plain PyTorch, as the kernel orders it: each
    run's sum of x over its edges (slice base + local id), then each row's
    runs' sums added in slice order."""
    dev, total = x.device, sl.lid.shape[0]
    n, nslices = sl.part_ptr.shape[0] - 1, sl.slice_edges.shape[0] - 1
    run = torch.cumsum(pull_slices_heads(sl), 0) - 1
    edge_slice = torch.repeat_interleave(torch.arange(nslices, device=dev),
                                         sl.slice_edges.diff(), output_size=total)
    src = edge_slice * sl.width + (sl.lid.long() & 0xFFFF)
    sums = torch.zeros(sl.runs, dtype=x.dtype, device=dev).index_add_(0, run, x[src])
    part = sums[sl.row_runs.long()]
    count, first = sl.part_ptr.diff(), sl.part_ptr[:-1].long()
    y = torch.zeros(n, dtype=x.dtype, device=dev)
    for j in range(int(count.max()) if n else 0):
        has = count > j
        y[has] += part[first[has] + j]
    return y


def csr_pull_reduce(mode: str, x: torch.Tensor | None, src: torch.Tensor,
                    indptr: torch.Tensor, w: torch.Tensor | None = None,
                    slices: PullSlices | None = None) -> torch.Tensor:
    """K7 wrapper: y[v] over the in-edges e of v, [indptr[v], indptr[v+1])
    of the pull-ordered ``src`` (indptr[-1] = len(src)): ``max_i32`` max of
    x[src[e]] (0 for a row without edges), ``min_i32`` min of x[src[e]]
    (INT32_INF), ``min_plus`` min of x[src[e]] + w[e] in x's float dtype
    (+inf), ``sum`` sum of x[src[e]] in x's float dtype (0), ``sum_i64``
    the exact int64 sum of int32 x[src[e]] (0). In the max_i32 and min_i32
    modes x None reads src[e] itself. All index tensors int32, contiguous.
    A launch in mode ``sum`` counts as ``csr_pull_reduce_sum``, in
    ``sum_i64`` as ``csr_pull_reduce_sum_i64``. On the card mode ``sum``
    runs on ``slices``, the CSR's sliced layout for x's dtype, which it
    builds first where the caller has none, unless its runs are short
    (``SLICE_RUN_EDGES``): then on the merge path."""
    if mode not in CSR_MODES:
        raise ValueError(f"csr_pull_reduce: unknown mode {mode!r}")
    codes, _, _ = CSR_MODES[mode]
    if mode == "min_plus" and (x is None or w is None):
        raise ValueError("csr_pull_reduce: min_plus takes both x and w")
    if mode in ("sum", "sum_i64") and x is None:
        raise ValueError(f"csr_pull_reduce: {mode} takes x")
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
    if slices is not None and mode != "sum":
        raise ValueError(f"csr_pull_reduce: {mode} takes no slices")
    if not kernels.use_kernel(src):
        return csr_pull_reduce_plain(mode, x, src, indptr, w)
    if mode == "sum":
        if slices is None:
            slices = build_pull_slices(src, indptr, x.element_size())
        if slices.runs * SLICE_RUN_EDGES <= slices.edges:
            return _pull_slices_launch(x, slices, indptr.shape[0] - 1, src.shape[0])
    out = torch.int64 if mode == "sum_i64" else dtype
    return _csr_pull_reduce_launch(codes[dtype], out, x, src, indptr, w,
                                   _CSR_COUNTERS.get(mode))[0]


def _pull_slices_launch(x: torch.Tensor, sl: PullSlices, n: int, m: int) -> torch.Tensor:
    """y [n] of one K7 launch in mode sum on the sliced pull ``sl`` (of a
    CSR of n rows and m edges): a block an SM over its tiles."""
    args, y, _ = pull_slices_args(x, sl, n, m)
    if n:
        kernels.launch("csr_pull_slices", x.device, *args, counter="csr_pull_reduce_sum")
    return y


def pull_slices_args(x: torch.Tensor, sl: PullSlices, n: int, m: int):
    """(C arguments before the stream, y, keep) of a launch of
    ``gt_csr_pull_slices`` on ``sl``: y and the scratch in ``keep`` are
    allocated here and must outlive the launch (a measuring tool calls the
    C entry of a build of its own with them)."""
    ts = sl[:8]
    if sl.itemsize != x.element_size() or sl.part_ptr.shape[0] != n + 1 or \
            sl.edges != m or x.shape[0] < sl.n_x:
        raise ValueError(f"csr_pull_reduce: slices built for {sl.part_ptr.shape[0] - 1} rows, "
                         f"{sl.edges} edges, {sl.itemsize}-byte values and {sl.n_x} entries "
                         f"of x; got {n}, {m}, {x.element_size()} and {x.shape[0]}")
    if any(t.device != x.device for t in ts):
        raise ValueError("csr_pull_reduce: slices must lie on x's device")
    dev, ntiles = x.device, sl.tile_slice.shape[0]
    grid = min(ntiles, kernels.sm_count(dev))
    y = torch.empty(n, dtype=x.dtype, device=dev)
    part = torch.empty(sl.runs, dtype=x.dtype, device=dev)
    nbytes = (4 * grid + 7) // 8 * 8 + x.element_size() * grid
    scratch = torch.empty(max(nbytes, 8), dtype=torch.uint8, device=dev)
    args = (*(t.data_ptr() for t in (sl.lid, sl.head, sl.row_runs, sl.part_ptr, sl.tile_edge,
                                     sl.tile_run, sl.tile_slice)),
            ntiles, sl.runs, n, x.data_ptr(), x.shape[0], sl.width, sl.items,
            int(x.dtype == torch.float64), grid, part.data_ptr(), scratch.data_ptr(), nbytes,
            y.data_ptr())
    return args, y, (part, scratch)


def _csr_pull_reduce_launch(code: int, dtype, x, src, indptr, w, counter=None):
    """(y, scratch) of one K7 launch, y of ``dtype``: the scratch holds the
    partition and the carries afterwards (``csr_scratch_layout``)."""
    n, m = indptr.shape[0] - 1, src.shape[0]
    y = torch.empty(n, dtype=dtype, device=src.device)
    _, _, nbytes = csr_scratch_layout(n, m, y.element_size())
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=src.device)
    if n:
        kernels.launch(
            "csr_pull_reduce", src.device, indptr.data_ptr(), src.data_ptr(),
            None if x is None else x.data_ptr(), None if w is None else w.data_ptr(),
            y.data_ptr(), n, m, code, CSR_ITEMS[y.element_size()], scratch.data_ptr(), nbytes,
            counter=counter,
        )
    return y, scratch


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


def slab_spmv(semiring: Semiring, plan: SlabPlan, x: torch.Tensor, n: int,
              heavy_slices: PullSlices | None = None) -> torch.Tensor:
    """y[v] = (+)_{(u,v)} (w_uv * x[u]) over the slab plan; rows with no
    edges get the monoid identity. ``heavy_slices``: the heavy rows' sliced
    pull for K7's mode sum (built at the call where it is None)."""
    ident = semiring.add.identity(x.dtype)
    min_kernels = _slab_min_kernels(semiring, plan, x)
    sum_kernels = (semiring.add.name == "plus" and x.dtype in _K3_DTYPES
                   and all(b.values is None for b in plan.slabs))
    buf = result_buffer(plan, x.dtype)
    if min_kernels:
        slab_spmv_min_buckets(plan, x, n, buf)
    elif sum_kernels:
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
    elif plan.heavy_rows is not None and sum_kernels and plan.heavy_values is None:
        heavy = csr_pull_reduce("sum", x, plan.heavy_neigh, plan.heavy_indptr,
                                slices=heavy_slices)
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
