"""Degree-bucketed padded-ELL ("slab") layout (counterpart of graphtpu/ops/slab.py).

Rows are bucketed by degree, each bucket padded to a static width; rows
heavier than the largest bucket form a sorted "heavy" edge stream. The
plan is built on the host with numpy, exactly as the JAX package builds
it, and its arrays then move to the plan's device as torch tensors.

Slabs stay TRANSPOSED, [W, R]: with one GPU thread per row, neighbouring
threads read neighbouring ``r`` at each ``w``, which is the coalesced
layout (the TPU kept it for its lane axis).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# The static ladder; plan builders default to per-graph DP-optimal bounds
# with its largest width as the heavy-tail cutoff.
DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
DEFAULT_BUCKET_COUNT = 10


def optimal_bucket_bounds(
    deg: np.ndarray, k: int = DEFAULT_BUCKET_COUNT, lo: int = 0,
    cap: Optional[int] = None,
) -> list:
    """Bucket upper bounds for THIS degree distribution: at most ``k``
    boundaries minimizing the padded element count, where a row in a
    width-W bucket costs W. Only degrees in (lo, cap] take part; rows
    above ``cap`` are the heavy tail. Boundaries land on degrees present,
    so distributions with <= k distinct degrees get exact buckets."""
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


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


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
        return cls(tuple(buckets), *opt, _tensor(inv_perm, device))


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


def assemble(plan: SlabPlan, bucket_results, heavy_result, rest_values) -> torch.Tensor:
    """Concatenate per-bucket results in plan order and apply the inverse
    permutation: one K1 gather instead of per-bucket scatters."""
    from graphtpu_torch.ops.gather import table_gather

    parts = list(bucket_results)
    if heavy_result is not None:
        parts.append(heavy_result)
    if rest_values is not None:
        parts.append(rest_values)
    return table_gather(torch.cat(parts), plan.inv_perm)
