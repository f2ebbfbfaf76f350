"""Distributed slab min-mode CDLP (counterpart of
graphtpu/parallel/slab_cdlp.py), the JAX package's default distributed CDLP.

One global slab plan is built on the host, and every degree bucket's rows
are split evenly over the ranks, so that each rank holds 1/D of every
bucket and degree skew balances by construction. Rank d's slabs are the
[W, R_dev] slices ``bucket_slabs[k][d]``, the port's own [W, R] layout, so
each rank keeps them as one ``BucketTable`` and runs K2 over all of them in
at most two launches a step, as the one-device path does
(``ops/minmode.py:slab_minmode_buckets``). Rows heavier than the largest
bucket are split the same way into a per-rank edge stream (K12,
``stream_minmode``; iteration 0's minimum id on K7 ``min_i32``), whose
padding edges form a trailing junk segment: K7 reduces it and its result
is cut off, K12 is given the segments before it. A rank's results (its
buckets' columns, then its heavy rows) form one block of L labels; one
all-gather replicates the
[D * L] blocks, and the host-built inverse permutation assembles them in
vertex order by one K1 gather; vertices without neighbours keep their
label. The loop stops at a fixed point, read once a step from the
replicated labels, so every rank takes the same branch.

``_make_step``'s counterpart is ``local_step``: WCC's slab-adaptive full
steps take it with ``reduce="min"`` (K6 over the buckets, K7 ``min_i32``
over the heavy stream).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.minmode import slab_minmode_buckets, stream_minmode
from graphtpu_torch.ops.slab import BucketTable, SlabBucket, SlabPlan, bucket_policy_key
from graphtpu_torch.ops.spmv import csr_pull_reduce, slab_spmv_min_buckets
from graphtpu_torch.parallel.mesh import Mesh, all_gather_rows
from graphtpu_torch.parallel.partition import EDGE_ALIGN, _round_up


def _col_align(r_dev: int) -> int:
    """Each rank's bucket column count, padded as the JAX package pads it
    (multiples of 128 for big buckets, of 8 for small ones)."""
    return _round_up(r_dev, 128 if r_dev > 64 else 8)


class DistSlabPlan(NamedTuple):
    """The host plan, every rank's part (the JAX package's arrays)."""

    bucket_slabs: tuple            # each [D, W, R_dev] int32, -1 pad
    heavy: Optional[tuple]         # (centers [D, M], neigh [D, M], indptr [D, H_dev + 2]) int32
    inv_perm: np.ndarray           # [n] int32 into the gathered [D * L] blocks
    has_neighbors: np.ndarray      # [n] bool: rows with incidence entries


def build_dist_slab_plan(graph, num_devices: int, buckets=None) -> DistSlabPlan:
    """CDLP's incidence slab plan split per bucket over ``num_devices`` ranks."""
    from graphtpu_torch.algorithms.cdlp import build_incidence

    centers, neigh = build_incidence(graph)
    return build_dist_slab_plan_from(centers, neigh, graph.n, num_devices, buckets)


def build_dist_slab_plan_from(centers, neigh, n: int, num_devices: int,
                              buckets=None) -> DistSlabPlan:
    """The bucket-split slab plan of a center-sorted (centers, neigh)
    stream: CDLP's incidence, PageRank's in-edges and WCC's symmetrized
    in-edges."""
    from graphtpu_torch.ops.slab import resolve_buckets

    deg = np.bincount(centers, minlength=n).astype(np.int64)
    buckets = resolve_buckets(deg, buckets)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])

    slabs = []
    layout = []  # (rows, r_dev) per bucket, for the assembly permutation
    prev = 0
    for w in buckets:
        sel = np.nonzero((deg > prev) & (deg <= w))[0]
        prev = w
        if sel.size == 0:
            continue
        r = sel.shape[0]
        r_dev = _col_align(-(-r // num_devices))
        starts = indptr[sel]
        offs = np.arange(w)
        pos = starts[:, None] + offs[None, :]
        mask = offs[None, :] < deg[sel][:, None]
        slab = np.full((r_dev * num_devices, w), -1, dtype=np.int32)
        slab[:r][mask] = neigh[pos[mask]]
        # [r_tot, W] -> [W, r_tot] -> [W, D, r_dev] -> [D, W, r_dev]
        slabs.append(np.ascontiguousarray(
            slab.T.reshape(w, num_devices, r_dev).transpose(1, 0, 2)))
        layout.append((sel, r_dev))

    heavy = None
    heavy_sel = np.nonzero(deg > buckets[-1])[0]
    h_dev = 0
    if heavy_sel.size:
        h_dev = -(-heavy_sel.shape[0] // num_devices)
        # each rank's edge stream (its padded heavy rows contribute none)
        dev_edges = [int(deg[heavy_sel[d * h_dev:(d + 1) * h_dev]].sum())
                     for d in range(num_devices)]
        m_dev = max(_round_up(max(dev_edges), EDGE_ALIGN), EDGE_ALIGN)
        c_loc = np.full((num_devices, m_dev), h_dev, dtype=np.int32)
        nb = np.zeros((num_devices, m_dev), dtype=np.int32)
        ip = np.zeros((num_devices, h_dev + 2), dtype=np.int32)
        for d in range(num_devices):
            rows = heavy_sel[d * h_dev:(d + 1) * h_dev]
            local_deg = np.zeros(h_dev, dtype=np.int64)
            local_deg[:rows.shape[0]] = deg[rows]
            ip[d, 1:h_dev + 1] = np.cumsum(local_deg)
            ip[d, h_dev + 1] = m_dev  # the trailing junk segment holds the padding
            cursor = 0
            for k, row in enumerate(rows):
                s, c = int(indptr[row]), int(deg[row])
                c_loc[d, cursor:cursor + c] = k
                nb[d, cursor:cursor + c] = neigh[s:s + c]
                cursor += c
        heavy = (c_loc, nb, ip)

    # each rank's block length and the assembly permutation
    l_local = sum(r_dev for _, r_dev in layout) + h_dev
    inv_perm = np.zeros(n, dtype=np.int32)
    off = 0
    for sel, r_dev in layout:
        j = np.arange(sel.shape[0], dtype=np.int64)
        inv_perm[sel] = ((j // r_dev) * l_local + off + (j % r_dev)).astype(np.int32)
        off += r_dev
    if heavy is not None:
        k = np.arange(heavy_sel.shape[0], dtype=np.int64)
        inv_perm[heavy_sel] = ((k // h_dev) * l_local + off + (k % h_dev)).astype(np.int32)
    return DistSlabPlan(tuple(slabs), heavy, inv_perm, deg > 0)


# -- what a rank holds, and its step ----------------------------------------


class RankSlabs(NamedTuple):
    """One rank's part of a DistSlabPlan, on its device."""

    plan: SlabPlan                 # its [W, R_dev] buckets as the table kernels take them;
    #                                inv_perm is the replicated [n] assembly permutation
    heavy: Optional[tuple]         # (centers [M], neigh [M], indptr [H_dev + 2]) int32
    has_neighbors: torch.Tensor    # [n] bool, replicated
    length: int                    # L: its buckets' columns, then its heavy rows


def _install_slabs(mesh: Mesh, key, slabs, heavy, inv_perm, has_neighbors) -> None:
    """Per rank: keep this rank's slabs and heavy stream, and the replicated
    assembly arrays, on its device under ``key``."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)

    ts = [dev(s) for s in slabs]
    plan = SlabPlan(tuple(SlabBucket(None, s, None) for s in ts), None, None, None, None,
                    None, None, dev(inv_perm), BucketTable(ts))
    hv = None if heavy is None else tuple(dev(a) for a in heavy)
    h_dev = 0 if hv is None else hv[2].shape[0] - 2
    mesh.state[key] = RankSlabs(plan, hv, dev(has_neighbors), plan.table.total + h_dev)


def install_plan(sg, kind: str, plan: DistSlabPlan) -> tuple:
    """Key of each rank's part of ``plan``, installed once per ShardedGraph."""
    def per_rank():
        heavy = plan.heavy
        return [(tuple(s[d] for s in plan.bucket_slabs),
                 None if heavy is None else tuple(a[d] for a in heavy),
                 plan.inv_perm, plan.has_neighbors) for d in range(sg.num_devices)]

    return sg.installed(kind, _install_slabs, per_rank)


def local_step(rs: RankSlabs, labels: torch.Tensor, first: Optional[str],
               reduce: str = "minmode") -> torch.Tensor:
    """One rank's slab step, all-gathered: the [D * L] blocks in rank order.

    ``first``: "min" (duplicate-free iteration 0: the minimum stored id),
    "mode" (iteration 0 with duplicates: the min-mode of the stored ids) or
    None (the full step on ``labels``). ``reduce``: "minmode" (CDLP, kernel
    K2) or "min" (WCC: the neighbours' minimum label, K6 over the buckets
    and K7 over the heavy stream; any ``first`` reads the stored ids)."""
    n = labels.shape[0]
    buf = torch.empty(rs.length, dtype=torch.int32, device=labels.device)
    if reduce == "min":
        slab_spmv_min_buckets(rs.plan, None if first else labels, n, buf)
    elif first == "min":
        slab_minmode_buckets(rs.plan, "min", n, None, buf)
    elif first == "mode":
        slab_minmode_buckets(rs.plan, "identity", n, None, buf)
    else:
        slab_minmode_buckets(rs.plan, "gather", n, labels, buf)
    if rs.heavy is not None:
        c, nb, ip = rs.heavy
        if reduce == "min" or first == "min":
            hout = csr_pull_reduce("min_i32", None if first else labels, nb, ip)
        else:
            # the padding past ip[-2] joins no segment (K12 would count the
            # trailing junk segment's entries, all of one label, for nothing)
            hout = stream_minmode(labels, c, nb, ip[:-1], identity=first == "mode")
        total = rs.plan.table.total
        buf[total:] = hout[:rs.length - total]  # the junk segment goes
    return all_gather_rows(buf)


def assembled(rs: RankSlabs, gathered: torch.Tensor) -> torch.Tensor:
    """The gathered blocks in vertex order [n] (one K1 gather)."""
    return table_gather(gathered, rs.plan.inv_perm)


# -- CDLP ---------------------------------------------------------------------


def _cdlp_body(mesh: Mesh, key, n: int, itermax: int, undirected: bool):
    """Iteration 0 gather-free (min on undirected graphs, whose incidence
    has no duplicates; the stored ids' min-mode otherwise), counted as a
    change; then full steps to a fixed point or ``itermax``."""
    rs = mesh.state[key]
    labels = torch.arange(n, dtype=torch.int32, device=mesh.device)

    def step(labels, first):
        return torch.where(rs.has_neighbors, assembled(rs, local_step(rs, labels, first)),
                           labels)

    it = 0
    if itermax >= 1:
        labels, it = step(labels, "min" if undirected else "mode"), 1
    changed = True
    while changed and it < itermax:
        new = step(labels, None)
        changed = bool((new != labels).any())  # replicated: every rank reads the same
        labels, it = new, it + 1
    return labels.cpu().numpy(), it


def cdlp_slab_dist(sg, itermax: int, buckets=None):
    """Distributed slab CDLP on a ShardedGraph: (dense-id labels [n] int32,
    iterations). The plan is built (or restored from its checkpoint) once
    per bucket choice and installed once."""
    from graphtpu_torch.parallel.checkpoint import cached_plan

    bkey = bucket_policy_key(buckets)
    if getattr(sg, "_dist_slab_buckets", None) != bkey:
        sg._dist_slab_plan = None  # another bucket choice: another plan
        sg.forget("cdlp-slab")
    plan = cached_plan(sg, "_dist_slab_plan", "cdlp-incidence",
                       lambda: build_dist_slab_plan(sg.graph, sg.num_devices, buckets), buckets)
    sg._dist_slab_buckets = bkey
    if not plan.bucket_slabs and plan.heavy is None:
        return np.arange(sg.n, dtype=np.int32), 0
    key = install_plan(sg, "cdlp-slab", plan)
    return sg.mesh.call(_cdlp_body, [(key, sg.n, int(itermax), not sg.graph.directed)]
                        * sg.num_devices)
