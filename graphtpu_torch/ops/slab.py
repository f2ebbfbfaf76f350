"""Degree-bucketed padded-ELL ("slab") layout (counterpart of graphtpu/ops/slab.py).

Rows are bucketed by degree, each bucket padded to a static width; rows
heavier than the largest bucket form a sorted "heavy" edge stream. The
plan is built on the host with numpy, exactly as the JAX package builds
it, and its arrays then move to the plan's device as torch tensors.

Slabs stay TRANSPOSED, [W, R]: neighbouring GPU threads read neighbouring
``r`` at each ``w``, which is the coalesced layout (the TPU kept it for its
lane axis).

The slab kernels (K2, K3, K6) take all buckets of a plan in one launch:
``BucketTable`` holds, per bucket, the descriptor the kernels read (slab
pointer, R, output offset, W), built once with the plan. Bucket k's results
go to ``[offsets[k], offsets[k] + R_k)`` of one result buffer of n entries,
in plan order, followed by the heavy rows' and the zero-degree rows'
results; ``assemble`` gathers that buffer by the inverse permutation.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# The static ladder; plan builders default to per-graph DP-optimal bounds
# with its largest width as the heavy-tail cutoff.
DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
DEFAULT_BUCKET_COUNT = 10


def optimal_bucket_bounds(
    deg: np.ndarray, k: int = DEFAULT_BUCKET_COUNT, kind: str = "elements", lo: int = 0,
    cap: Optional[int] = None,
) -> list:
    """Bucket upper bounds for THIS degree distribution: at most ``k``
    boundaries minimizing the padded cost, where a row in a width-W bucket
    costs W (kind="elements": slab gathers) or W(W-1)/2 (kind="pairs": the
    LCC wedge pair lists). Only degrees in (lo, cap] take part; rows
    above ``cap`` are the heavy tail. Boundaries land on degrees present,
    so distributions with <= k distinct degrees get exact buckets."""
    if kind not in ("elements", "pairs"):
        raise ValueError(f"optimal_bucket_bounds: unknown kind {kind!r}")
    deg = np.asarray(deg)
    mask = deg > lo
    if cap is not None:
        mask &= deg <= cap
    d = deg[mask]
    if d.size == 0:
        return []
    hist = np.bincount(d)
    ends = np.nonzero(hist)[0].astype(np.int64)   # distinct degrees, > lo
    if ends.size <= k:
        return ends.tolist()
    csum = np.cumsum(hist)                        # rows with degree <= d
    if kind == "pairs":
        w = (ends * (ends - 1) // 2).astype(np.float64)
    else:
        w = ends.astype(np.float64)
    s = csum[ends].astype(np.float64)             # rows covered through ends[j]
    e = ends.size
    jlt = np.tril(np.ones((e, e), bool), k=-1)    # j < i
    prev_dp = w * s                               # one bucket covering all of (lo, e_i]
    parents = []
    for _ in range(2, k + 1):
        a = prev_dp[None, :] - s[None, :] * w[:, None]      # [i, j]
        a = np.where(jlt, a, np.inf)
        j_best = np.argmin(a, axis=1)
        cut = a[np.arange(e), j_best] + s * w
        dp = np.minimum(prev_dp, cut)
        parents.append(np.where(cut < prev_dp, j_best, -1))
        prev_dp = dp
    bounds = []
    i = e - 1
    kk = len(parents) - 1
    while True:
        if kk < 0:
            bounds.append(int(ends[i]))
            break
        p = int(parents[kk][i])
        if p < 0:
            kk -= 1                               # fewer buckets suffice
            continue
        bounds.append(int(ends[i]))
        i = p
        kk -= 1
    return sorted(bounds)


def resolve_buckets(deg: np.ndarray, buckets=None) -> tuple:
    """Explicit ``buckets`` verbatim; None = DP-optimal bounds with the
    static ladder's heavy-tail cutoff (the ladder itself when no row has
    a degree in range)."""
    if buckets is not None:
        return tuple(buckets)
    bounds = optimal_bucket_bounds(deg, cap=DEFAULT_BUCKETS[-1])
    return tuple(bounds) if bounds else DEFAULT_BUCKETS


def bucket_policy_key(buckets) -> list:
    """Identity of a bucket choice for plan memo keys and checkpoint
    manifests: explicit bounds verbatim, else the auto policy (the
    DP-optimal bounds with DEFAULT_BUCKET_COUNT buckets) as the JAX
    package's key names it with its two environment knobs unset (the port
    has neither), so that each package accepts the other's plans."""
    if buckets is not None:
        return ["explicit", [int(b) for b in buckets]]
    return ["auto", "", DEFAULT_BUCKET_COUNT]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


MAX_TABLE_BUCKETS = 16  # GT_MAX_BUCKETS of csrc/common.cuh: buckets per launch


class BucketDescriptor(ctypes.Structure):
    """GtBucket of csrc/common.cuh."""

    _fields_ = [
        ("slab", ctypes.c_void_p), ("rows", ctypes.c_longlong),
        ("out_off", ctypes.c_longlong), ("width", ctypes.c_int),
        ("row_major", ctypes.c_int),
    ]


class BucketTable:
    """The [W, R] slabs of a plan as the table kernels take them.

    ``widths``, ``rows`` and ``offsets`` hold W, R and the first result
    index of each bucket; ``total`` is the number of bucket rows. The
    slabs are kept, so the pointers in the descriptors stay valid. A kernel
    that reads rows whole (K2 above SMALL_WIDTH) asks for row-major
    copies [R, W] of its buckets; they are made at its first launch and
    kept with the table: 4 B more per slot of those buckets."""

    def __init__(self, slabs: Sequence[torch.Tensor]):
        self.slabs = tuple(slabs)
        self.widths = tuple(int(s.shape[0]) for s in self.slabs)
        self.rows = tuple(int(s.shape[1]) for s in self.slabs)
        ends = np.cumsum(self.rows, dtype=np.int64)
        self.total = int(ends[-1]) if self.slabs else 0
        self.offsets = tuple(int(e) - r for e, r in zip(ends, self.rows))
        self._launches = {}
        self._row_major = {}

    def launches(self, lo: int = 1, hi: Optional[int] = None, row_major: bool = False) -> list:
        """The non-empty buckets of width in [lo, hi] (no upper end if
        ``hi`` is None) as (descriptor array, count) pairs of at most
        MAX_TABLE_BUCKETS buckets, one pair per kernel launch; memoized.
        With ``row_major`` the descriptors point to [R, W] copies of the
        slabs. The widest buckets come first: their blocks run longest, so
        they start first and the narrow buckets' many short blocks fill the
        tail."""
        key = (lo, hi, row_major)
        got = self._launches.get(key)
        if got is None:
            desc = []
            for k, (s, w, r, off) in enumerate(
                    zip(self.slabs, self.widths, self.rows, self.offsets)):
                if not r or w < lo or (hi is not None and w > hi):
                    continue
                if row_major:
                    s = self._row_major[k] = s.t().contiguous()
                desc.append(BucketDescriptor(s.data_ptr(), r, off, w, int(row_major)))
            desc.sort(key=lambda d: -d.width)
            got = []
            for i in range(0, len(desc), MAX_TABLE_BUCKETS):
                chunk = desc[i:i + MAX_TABLE_BUCKETS]
                got.append(((BucketDescriptor * len(chunk))(*chunk), len(chunk)))
            self._launches[key] = got
        return got


class SlabBucket(NamedTuple):
    rows: torch.Tensor              # [R] int32 — vertex ids of the bucket's rows
    slab: torch.Tensor              # [W, R] int32 — neighbour ids, -1 = pad
    values: Optional[torch.Tensor]  # [W, R] float — edge values aligned with slab


class SlabPlan(NamedTuple):
    """Padded buckets + heavy-tail stream, on one device.

    ``inv_perm`` maps concat(bucket rows..., heavy rows, zero-degree rows)
    back to vertex order, so results are assembled with one gather."""

    slabs: Tuple[SlabBucket, ...]
    heavy_rows: Optional[torch.Tensor]     # [H] int32 row ids
    heavy_centers: Optional[torch.Tensor]  # [M_h] int32 indices into heavy_rows
    heavy_neigh: Optional[torch.Tensor]    # [M_h] int32 global neighbour ids
    heavy_values: Optional[torch.Tensor]   # [M_h] float edge values (or None)
    heavy_indptr: Optional[torch.Tensor]   # [H+1] int32 segment starts
    rest_rows: Optional[torch.Tensor]      # [Z] int32 zero-degree rows (or None)
    inv_perm: torch.Tensor                 # [n] int32 assembly permutation
    table: Optional[BucketTable] = None    # the buckets as the table kernels take them

    @classmethod
    def from_numpy(
        cls,
        slabs: Sequence[tuple],
        heavy_rows, heavy_centers, heavy_neigh, heavy_values, heavy_indptr,
        rest_rows, inv_perm, *, device,
    ) -> "SlabPlan":
        """Move a host plan to ``device``. ``slabs`` holds one
        (rows, slab [W, R], values or None) triple per bucket; the other
        arguments are arrays or None, as the fields. The kernels take the
        slab ids as they are, so they are checked here, once: every id
        must be -1 or a vertex in [0, n)."""
        n = int(np.asarray(inv_perm).shape[0])
        buckets = []
        for rows, slab, values in slabs:
            slab = np.asarray(slab)
            if slab.dtype != np.int32 or slab.ndim != 2:
                raise TypeError(f"slab must be 2-D int32, got {slab.ndim}-D {slab.dtype}")
            if slab.size and (slab.min() < -1 or slab.max() >= n):
                raise ValueError(f"slab ids must lie in [-1, {n})")
            buckets.append(SlabBucket(
                _tensor(rows, device), _tensor(slab, device),
                None if values is None else _tensor(values, device),
            ))
        if heavy_neigh is not None:
            hn = np.asarray(heavy_neigh)
            if hn.size and (hn.min() < 0 or hn.max() >= n):
                raise ValueError(f"heavy neighbour ids must lie in [0, {n})")
        opt = [
            None if a is None else _tensor(a, device)
            for a in (heavy_rows, heavy_centers, heavy_neigh, heavy_values,
                      heavy_indptr, rest_rows)
        ]
        return cls(tuple(buckets), *opt, _tensor(inv_perm, device),
                   BucketTable([b.slab for b in buckets]))


def build_slab_plan(
    centers: np.ndarray,
    neigh: np.ndarray,
    deg: np.ndarray,
    n: int,
    buckets=None,
    values: Optional[np.ndarray] = None,
    *,
    device,
) -> SlabPlan:
    """Partition a center-sorted (centers, neigh[, values]) stream into
    padded slabs on ``device``. ``deg`` must be the per-center multiplicity
    of ``centers``; ``buckets=None`` uses per-graph DP-optimal bounds."""
    buckets = resolve_buckets(deg, buckets)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])

    slabs = []
    order_parts = []
    prev = 0
    for w in buckets:
        sel = np.nonzero((deg > prev) & (deg <= w))[0]
        prev = w
        if sel.size == 0:
            continue
        r = sel.shape[0]
        starts = indptr[sel]
        degs = deg[sel]
        offs = np.arange(w)
        pos = starts[:, None] + offs[None, :]
        mask = offs[None, :] < degs[:, None]
        slab = np.full((r, w), -1, dtype=np.int32)
        slab[mask] = neigh[pos[mask]]
        vslab = None
        if values is not None:
            vslab = np.zeros((r, w), dtype=values.dtype)
            vslab[mask] = values[pos[mask]]
            vslab = vslab.T
        slabs.append((sel.astype(np.int32), slab.T, vslab))
        order_parts.append(sel)

    heavy_sel = np.nonzero(deg > buckets[-1])[0]
    heavy = [None] * 5
    if heavy_sel.size:
        heavy_flag = np.zeros(n, dtype=bool)
        heavy_flag[heavy_sel] = True
        hmask = heavy_flag[centers]
        remap = np.zeros(n, dtype=np.int32)
        remap[heavy_sel] = np.arange(heavy_sel.shape[0], dtype=np.int32)
        h_ind = np.zeros(heavy_sel.shape[0] + 1, dtype=np.int64)
        np.cumsum(deg[heavy_sel], out=h_ind[1:])
        heavy = [
            heavy_sel.astype(np.int32),
            remap[centers[hmask]],
            neigh[hmask].astype(np.int32),
            None if values is None else values[hmask],
            h_ind.astype(np.int32),
        ]
        order_parts.append(heavy_sel)

    rest = np.nonzero(deg == 0)[0]
    if rest.size:
        order_parts.append(rest)

    order = np.concatenate(order_parts) if order_parts else np.empty(0, np.int64)
    inv_perm = np.empty(n, dtype=np.int32)
    inv_perm[order] = np.arange(n, dtype=np.int32)

    return SlabPlan.from_numpy(
        slabs, *heavy, rest.astype(np.int32) if rest.size else None, inv_perm,
        device=device,
    )


def result_buffer(plan: SlabPlan, dtype) -> torch.Tensor:
    """An uninitialized [n] buffer for a step's results in plan order."""
    return torch.empty(plan.inv_perm.shape[0], dtype=dtype, device=plan.inv_perm.device)


def check_result_buffer(name: str, out: torch.Tensor, dtype, plan: SlabPlan) -> None:
    """Raise unless ``out`` can take the bucket results of ``plan``."""
    if out.dtype != dtype or out.dim() != 1 or not out.is_contiguous():
        raise TypeError(f"{name}: out must be a contiguous 1-D {dtype} tensor")
    if out.shape[0] < plan.table.total or out.device != plan.inv_perm.device:
        raise ValueError(f"{name}: out too short, or not on the plan's device")


def fill_buckets(plan: SlabPlan, buf: torch.Tensor, bucket_fn) -> None:
    """Write ``bucket_fn(bucket)`` ([R] results) at each bucket's place in
    ``buf``: the route of the bucket bodies that are not table kernels."""
    for bucket, off, r in zip(plan.slabs, plan.table.offsets, plan.table.rows):
        buf[off:off + r] = bucket_fn(bucket)


def assemble(plan: SlabPlan, buf: torch.Tensor, heavy_result, rest_values) -> torch.Tensor:
    """``buf`` holds the bucket results at ``plan.table.offsets``; place the
    heavy rows' and the zero-degree rows' results after them and apply the
    inverse permutation: one K1 gather instead of per-bucket scatters."""
    from graphtpu_torch.ops.gather import table_gather

    off = plan.table.total
    for part in (heavy_result, rest_values):
        if part is not None:
            buf[off:off + part.shape[0]] = part
            off += part.shape[0]
    if off != buf.shape[0]:
        raise ValueError(f"assemble: {off} results for {buf.shape[0]} rows")
    return table_gather(buf, plan.inv_perm)
