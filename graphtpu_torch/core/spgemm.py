"""Masked semiring SpGEMM and SpMM, the GraphBLAS mxm surface (counterpart
of graphtpu/core/spgemm.py).

For a structurally masked product C<M> = A (+).(x) B, every mask entry
(i, j) gets

    C[i,j] = (+)_{k in A.row(i), j in B.row(k)}  A[i,k] (x) B[k,j]

and the add identity when no k matches. A side without values (``val``
None) is structural: its term is the other side's value, or 1 where
neither side has values. CSR columns must be sorted within each row;
duplicates are allowed, and a search finds the first of equal columns.

``masked_spgemm`` dispatches on the device of A's columns. On the card it
launches kernel K11 (``csrc/masked_spgemm.cu``), which walks each mask row
once: the row's columns in a shared-memory hash table, the B rows that
A.row(i) names streamed through it. ``plan_masked_spgemm`` makes its plan
with torch ops on the mask's device (the mask grouped by row, each row's
work, and task lists for a warp per short row, a block per long row and a
block per column window of a row longer than a table holds): up to three
launches a call. It takes the semirings of ``semiring.BY_NAME`` and raises
on any other. Elsewhere, and inside ``kernels.plain_torch()``, it runs the
JAX package's formulation, the plain version: mask entries bucketed by
deg_A(i) into widths 8 * 4^k, each bucket a padded [R, w] slab searched by
a fixed number of branchless binary-search rounds, reassembled by an
inverse-permutation gather with a trailing identity slot.

``spmm`` (sparse x dense) is the slab SpMV (``ops/spmv.py:slab_spmv``)
applied column by column.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from graphtpu_torch.core.semiring import BY_NAME, Semiring
from graphtpu_torch.ops import kernels
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.spmv import int32_tensor, slab_spmv

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64, torch.int32: np.int32}
# K11's codes: value type, add monoid (lor reduces by max from 0), and the
# multiply of each semiring of BY_NAME (land is times, secondi is second)
_K11_VTYPE = {torch.float32: 0, torch.float64: 1, torch.int32: 2}
_K11_ADD = {"plus": 0, "min": 1, "max": 2, "lor": 3}
_K11_MUL = {"min.second": 1, "min.plus": 2, "plus.second": 1, "plus.times": 3,
            "lor.land": 3, "min.first": 0, "max.second": 1, "any.secondi": 1, "plus.pair": 4}
# K11's task classes (csrc/masked_spgemm.cu): a warp takes a mask row of at
# most K11_WARP_ENTRIES entries whose walk reads at most K11_WARP_WORK B
# entries; a block takes any other row of at most K11_WINDOW entries; a
# longer row is cut, in column order, into windows of K11_WINDOW entries,
# a block each. The tables hold 8x the entries where they can: K11_WARP_SLOTS
# 256, K11_BLOCK_SLOTS 2048.
K11_WARP_ENTRIES = 32
K11_WARP_WORK = 2048
K11_WINDOW = 512


class CSR(NamedTuple):
    """CSR triple on a device. ``col`` must be sorted within each row."""

    indptr: torch.Tensor          # int32 [n+1]
    col: torch.Tensor             # int32 [nnz]
    val: Optional[torch.Tensor]   # [nnz], or None (structural)

    @classmethod
    def from_graph(cls, graph, wdtype=torch.float32, with_values: bool = True,
                   device="cuda") -> "CSR":
        """The push-ordered CSR of a Graph (rows = sources) on ``device``."""
        val = None
        if with_values:
            val = torch.from_numpy(np.ascontiguousarray(graph.w, _NP_DTYPES[wdtype])).to(device)
        return cls(int32_tensor(graph.indptr, device), int32_tensor(graph.dst, device), val)


def _value_dtype(a: CSR, b: CSR) -> torch.dtype:
    if b.val is not None:
        return b.val.dtype
    return a.val.dtype if a.val is not None else torch.float32


def _row_search(indptr, col, rows, x, iters: int):
    """(found, pos): is x in col[indptr[r]:indptr[r+1]] for r = rows, and
    at which index (the first of equal columns)? ``iters`` rounds of a
    branchless binary search; col sorted per row."""
    nnz = col.shape[0]
    lo = table_gather(indptr, rows)
    hi = hi_fixed = table_gather(indptr, rows + 1)
    if nnz == 0:
        return torch.zeros(lo.shape, dtype=torch.bool, device=lo.device), torch.zeros_like(lo)
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) // 2
        go_right = table_gather(col, mid.clamp(0, nnz - 1)) < x
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    pos = lo.clamp(0, nnz - 1)
    return (lo < hi_fixed) & (table_gather(col, pos) == x), pos


def _bucket_bounds(max_deg: int):
    bounds = []
    b = 8
    while b < max(max_deg, 1):
        bounds.append(b)
        b *= 4
    bounds.append(max(b, 8))
    return bounds


_REDUCE = {
    "plus": lambda t: t.sum(1, dtype=t.dtype),
    "min": lambda t: t.min(1).values,
    "max": lambda t: t.max(1).values,
    "lor": lambda t: t.max(1).values,
}


def _spgemm_bucket(semiring: Semiring, a: CSR, b: CSR, rows, cols, w: int, iters: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """One bucket of the plain version: the mask entries (rows, cols) whose
    A-row has at most ``w`` entries, as a padded [R, w] slab."""
    dev = rows.device
    offs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    base = table_gather(a.indptr, rows)[:, None]
    deg = table_gather(a.indptr, rows + 1)[:, None] - base
    pos_a = (base + offs).clamp(0, a.col.shape[0] - 1)
    k = table_gather(a.col, pos_a)                                     # [R, w]
    in_row = offs < deg
    found, pos_b = _row_search(b.indptr, b.col, torch.where(in_row, k, 0), cols[:, None], iters)
    hit = found & in_row
    a_v = table_gather(a.val, pos_a) if a.val is not None else None
    b_v = table_gather(b.val, pos_b) if b.val is not None else None
    if a_v is None and b_v is None:
        terms = torch.ones(k.shape, dtype=dtype, device=dev)
    elif a_v is None:
        terms = b_v
    elif b_v is None:
        terms = a_v
    else:
        terms = semiring.mul(a_v, b_v)
    ident = torch.tensor(semiring.add.identity(dtype), dtype=dtype, device=dev)
    return _REDUCE[semiring.add.name](torch.where(hit, terms.to(dtype), ident))


def masked_spgemm_plain(semiring: Semiring, a: CSR, b: CSR, mask_rows: np.ndarray,
                        mask_cols: np.ndarray, *, a_indptr_host: np.ndarray) -> torch.Tensor:
    """K11's plain version: the JAX package's bucketed sweep, in torch ops
    on a's device. The mask is on the host; ``a_indptr_host`` is the host
    copy of a.indptr that buckets the mask entries by deg_A(row)."""
    dev = a.col.device
    m = mask_rows.shape[0]
    deg_a = a_indptr_host[1:] - a_indptr_host[:-1]
    dc = deg_a[mask_rows]
    max_deg = int(deg_a.max()) if deg_a.size else 0
    # the search walks B's rows: its round count must cover B's longest
    # row, and B's nnz bounds that without a host copy of B's indptr
    nb = int(b.col.shape[0])
    iters = max(1, int(np.ceil(np.log2(max(nb, 2) + 1))))
    dtype = _value_dtype(a, b)
    ident = semiring.add.identity(dtype)
    parts, sels = [], []
    prev = 0
    for w in _bucket_bounds(max_deg):
        sel = np.nonzero((dc > prev) & (dc <= w))[0]
        prev = w
        if sel.size == 0:
            continue
        rows = int32_tensor(mask_rows[sel], dev)
        cols = int32_tensor(mask_cols[sel], dev)
        parts.append(_spgemm_bucket(semiring, a, b, rows, cols, w, iters, dtype))
        sels.append(sel)
    if not parts:  # every mask row has deg_A == 0: all identity
        return torch.full((m,), ident, dtype=dtype, device=dev)
    # mask entries whose A-row is empty are in no bucket: they read the
    # trailing identity slot
    covered = np.concatenate(sels)
    perm = np.full(m, covered.size, dtype=np.int32)
    perm[covered] = np.arange(covered.size, dtype=np.int32)
    flat = torch.cat(parts + [torch.full((1,), ident, dtype=dtype, device=dev)])
    return table_gather(flat, int32_tensor(perm, dev))


class K11Plan(NamedTuple):
    """K11's plan of one call: the mask grouped by row, three task lists
    (int32 rows of (row, start, end) or (row, start, end, c_lo, c_hi)), one
    launch each where not empty, and the work prefix over A's entries by
    which a block cuts its row's work over its warps. Mask rows whose walk
    reads no B entry are in no task: they keep the add identity."""

    cols: torch.Tensor             # int32 [m] mask columns grouped by row
    idx: Optional[torch.Tensor]    # int32 [m] each one's index in the caller's order; None: same
    warp_tasks: torch.Tensor       # int32 [nw, 3] into cols/idx
    block_tasks: torch.Tensor      # int32 [nb, 5] into cols/idx (c_lo, c_hi unused: 0)
    win_cols: torch.Tensor         # int32 [mw] the windowed rows' columns, sorted in each row
    win_idx: torch.Tensor          # int32 [mw] each one's index in the caller's order
    win_tasks: torch.Tensor        # int32 [nwin, 5] into win_cols/win_idx
    cw: torch.Tensor               # int64 [nnz_A + 1] work_prefix: cuts a block row's work

    @property
    def launches(self) -> int:
        """K11 launches the plan takes: one per task list that is not empty."""
        return sum(int(t.shape[0] > 0) for t in (self.warp_tasks, self.block_tasks,
                                                  self.win_tasks))


def group_mask_rows(rows: torch.Tensor, cols: torch.Tensor):
    """(rows, cols, idx, starts) with the mask grouped by row: the caller's
    arrays and idx None where rows do not decrease, else a stable sort by
    row and idx the int32 permutation; starts (int64) the first index of
    each row's group. One scalar read (whether rows are in order, and how
    many groups they hold), and a second one after a sort."""
    m = rows.shape[0]
    change = torch.ones(m, dtype=torch.bool, device=rows.device)
    change[1:] = rows[1:] != rows[:-1]
    in_order = (rows[1:] >= rows[:-1]).all()
    ordered, groups = torch.stack([in_order.long(), change.sum()]).tolist()
    idx = None
    if not ordered:
        order = torch.sort(rows, stable=True).indices
        rows, cols, idx = rows[order], cols[order], order.to(torch.int32)
        change[1:] = rows[1:] != rows[:-1]
        groups = int(change.sum())
    return rows, cols, idx, torch.nonzero_static(change, size=groups).flatten()


def work_prefix(a: CSR, b: CSR) -> torch.Tensor:
    """int64 [nnz_A + 1]: for each A entry, the B entries that the A entries
    before it name (deg_B of their columns; a column outside B's rows names
    none), a cumulative sum over A's entries."""
    b_rows = b.indptr.shape[0] - 1
    k = a.col.long()
    if b_rows > 0:
        deg_b = b.indptr.long().diff()
        w = torch.where((k >= 0) & (k < b_rows), deg_b[k.clamp(0, b_rows - 1)], 0)
    else:
        w = torch.zeros_like(k)
    return torch.cat([w.new_zeros(1), w.cumsum(0)])


def row_work(a: CSR, b: CSR, rows: torch.Tensor, cw: Optional[torch.Tensor] = None):
    """int64 [len(rows)]: the B entries a row-wise walk of each mask row
    reads, sum_{k in A.row(i)} deg_B(k), from ``work_prefix`` (``cw``); 0 for
    a row outside A, and an A column outside B's rows adds 0."""
    a_rows = a.indptr.shape[0] - 1
    if a_rows <= 0:
        return torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    cw = work_prefix(a, b) if cw is None else cw
    r = rows.long()
    rc = r.clamp(0, a_rows - 1)
    ip = a.indptr.long()
    return torch.where((r >= 0) & (r < a_rows), cw[ip[rc + 1]] - cw[ip[rc]], 0)


def plan_masked_spgemm(a: CSR, b: CSR, rows: torch.Tensor, cols: torch.Tensor) -> K11Plan:
    """K11's plan, in torch ops on the mask's device (the CPU too): group
    the mask by row, weigh each row by ``row_work``, and deal the rows with
    work to a warp (at most K11_WARP_ENTRIES entries and K11_WARP_WORK
    work), a block (at most K11_WINDOW entries) or column windows of
    K11_WINDOW entries of the row sorted by column. Two scalar reads for a
    mask in row order: ``group_mask_rows``'s and the task lists' sizes."""
    dev = rows.device
    m = rows.shape[0]
    g_rows, g_cols, g_idx, starts = group_mask_rows(rows, cols)
    ends = torch.cat([starts[1:], starts.new_full((1,), m)])[:starts.shape[0]]
    n = ends - starts
    seg_row = g_rows[starts].long()
    cw = work_prefix(a, b)
    work = row_work(a, b, seg_row, cw)
    # each row's class: 0 warp, 1 block, 2 windows, 3 no work (no task)
    cls = torch.where(n > K11_WINDOW, 2,
                      torch.where((n <= K11_WARP_ENTRIES) & (work <= K11_WARP_WORK), 0, 1))
    cls = torch.where(work > 0, cls, 3)
    is_win = cls == 2
    per = torch.where(is_win, (n + K11_WINDOW - 1) // K11_WINDOW, 0)
    # (no bincount: on the card it reads its input's max back)
    sizes = torch.cat([(cls[:, None] == torch.arange(3, device=dev)).sum(0),
                       torch.stack([torch.where(is_win, n, 0).sum(), per.sum()])])
    nw, nb, nr, total, nwin = sizes.tolist()
    order = torch.sort(cls, stable=True).indices
    zero = torch.zeros_like(starts)
    tasks = torch.stack([seg_row, starts, ends, zero, zero], 1)[order[:nw + nb]].to(torch.int32)
    warp_tasks, block_tasks = tasks[:nw, :3].contiguous(), tasks[nw:]
    if not nr:
        none = torch.zeros(0, dtype=torch.int32, device=dev)
        return K11Plan(g_cols.contiguous(), g_idx, warp_tasks, block_tasks, none, none,
                       none.view(0, 5), cw)
    # windows: each windowed row's entries sorted by column, cut every K11_WINDOW
    wsel = order[nw + nb:nw + nb + nr]
    ws, wn, wrow, per = starts[wsel], n[wsel], seg_row[wsel], per[wsel]
    offs = torch.cat([wn.new_zeros(1), wn.cumsum(0)])
    seg = torch.repeat_interleave(torch.arange(nr, device=dev), wn, output_size=total)
    pos = ws[seg] + torch.arange(total, device=dev) - offs[:-1][seg]
    key = (seg << 32) + (g_cols[pos].long() + (1 << 31))
    pos = pos[torch.sort(key).indices]
    win_cols = g_cols[pos].contiguous()
    win_idx = (pos if g_idx is None else g_idx[pos]).to(torch.int32)
    wid = torch.repeat_interleave(torch.arange(nr, device=dev), per, output_size=nwin)
    first = per.cumsum(0) - per
    w_start = offs[:-1][wid] + (torch.arange(nwin, device=dev) - first[wid]) * K11_WINDOW
    w_end = torch.minimum(w_start + K11_WINDOW, offs[1:][wid])
    win_tasks = torch.stack([wrow[wid], w_start, w_end, win_cols[w_start].long(),
                             win_cols[w_end - 1].long()], 1).to(torch.int32)
    return K11Plan(g_cols.contiguous(), g_idx, warp_tasks, block_tasks, win_cols, win_idx,
                   win_tasks, cw)


def _check_k11(semiring: Semiring, a: CSR, b: CSR, rows: torch.Tensor, cols: torch.Tensor):
    if BY_NAME.get(semiring.name) != semiring:
        raise ValueError(f"masked_spgemm: semiring {semiring.name!r} is not one of "
                         f"semiring.BY_NAME; K11 takes only those")
    idx = (a.indptr, a.col, b.indptr, b.col, rows, cols)
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in idx):
        raise TypeError("masked_spgemm: indptr, col and the mask must be 1-D int32")
    vals = [v for v in (a.val, b.val) if v is not None]
    if any(v.dtype not in _K11_VTYPE or v.dim() != 1 for v in vals) or \
            len({v.dtype for v in vals}) > 1:
        raise TypeError("masked_spgemm: K11 takes 1-D float32, float64 or int32 values, "
                        "one dtype on both sides")
    if any(t.device != a.col.device or not t.is_contiguous() for t in idx + tuple(vals)):
        raise ValueError("masked_spgemm: inputs must be contiguous, on one device")
    if rows.shape != cols.shape:
        raise ValueError("masked_spgemm: mask rows and cols differ in length")
    if max(a.indptr.shape[0], b.indptr.shape[0], rows.shape[0]) >= 1 << 31:
        raise ValueError("masked_spgemm: K11 takes fewer than 2^31 rows and mask entries")


def masked_spgemm_rows(semiring: Semiring, a: CSR, b: CSR, rows: torch.Tensor,
                       cols: torch.Tensor) -> torch.Tensor:
    """K11's wrapper: the values of C<M> = A (+).(x) B at the mask entries
    (rows[e], cols[e]), int32 tensors on a's device. A CUDA tensor launches
    K11 over ``plan_masked_spgemm``'s task lists (up to three launches, each
    counted) or raises; a CPU tensor takes the plain version. On the card a
    mask row outside A, or a column of A outside B's rows, matches nothing;
    the plain version raises on it."""
    if not kernels.use_kernel(a.col):
        return masked_spgemm_plain(semiring, a, b, rows.cpu().numpy(), cols.cpu().numpy(),
                                   a_indptr_host=a.indptr.cpu().numpy())
    _check_k11(semiring, a, b, rows, cols)
    dtype = _value_dtype(a, b)
    dev = rows.device
    out = torch.full((rows.shape[0],), semiring.add.identity(dtype), dtype=dtype, device=dev)
    if not rows.shape[0]:
        return out
    plan = plan_masked_spgemm(a, b, rows, cols)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731  (structural side, idx)
    common = (a.indptr.data_ptr(), a.col.data_ptr(), ptr(a.val), b.indptr.data_ptr(),
              b.col.data_ptr(), ptr(b.val), plan.cw.data_ptr(), a.indptr.shape[0] - 1,
              b.indptr.shape[0] - 1, _K11_VTYPE[dtype], _K11_ADD[semiring.add.name],
              _K11_MUL[semiring.name])
    for kind, tasks, c, idx in ((0, plan.warp_tasks, plan.cols, plan.idx),
                                (1, plan.block_tasks, plan.cols, plan.idx),
                                (2, plan.win_tasks, plan.win_cols, plan.win_idx)):
        if tasks.shape[0]:
            kernels.launch("masked_spgemm", dev, *common, kind, tasks.data_ptr(), tasks.shape[0],
                           c.data_ptr(), ptr(idx), out.data_ptr())
    return out


def masked_spgemm(semiring: Semiring, a: CSR, b: CSR, mask_rows, mask_cols, *,
                  a_indptr_host: Optional[np.ndarray] = None) -> torch.Tensor:
    """Values of C<M> = A (+).(x) B at the mask entries, in the order of
    ``mask_rows``/``mask_cols`` (host arrays; structural mask: only the
    pattern matters). ``a_indptr_host`` is the host copy of a.indptr that
    the plain version buckets by; it is read from a.indptr if not given."""
    mask_rows = np.asarray(mask_rows)
    mask_cols = np.asarray(mask_cols)
    if kernels.use_kernel(a.col):
        dev = a.col.device
        return masked_spgemm_rows(semiring, a, b, int32_tensor(mask_rows, dev),
                                  int32_tensor(mask_cols, dev))
    if a_indptr_host is None:
        a_indptr_host = a.indptr.cpu().numpy()
    return masked_spgemm_plain(semiring, a, b, mask_rows, mask_cols, a_indptr_host=a_indptr_host)


def spmm(semiring: Semiring, plan, x: torch.Tensor, n: int) -> torch.Tensor:
    """Sparse x dense: y[v, :] = (+)_u (w_uv (x) x[u, :]), the slab SpMV of
    each column of ``x`` [n, c] (K3 or K6 where the plan and semiring take
    them)."""
    return torch.stack([slab_spmv(semiring, plan, x[:, c].contiguous(), n)
                        for c in range(x.shape[1])], dim=1)
