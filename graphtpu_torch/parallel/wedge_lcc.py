"""Distributed oriented-wedge LCC (counterpart of
graphtpu/parallel/wedge_lcc.py, its rowblock buckets), the JAX package's
default distributed LCC.

The wedge plan is the one-device path's (``ops/triangles.py:wedge_plan``,
memoized on the Graph). Every bucket's columns (centre rows) are split
evenly over the ranks: rank d takes columns [d * r_dev, (d + 1) * r_dev)
with r_dev = round_up(ceil(R_pad / D), chunk_cols), so each rank closes
1/D of every bucket's wedges and degree skew balances by construction. On
its columns a rank runs kernel K10 (``wedge_rowblock``), which searches the
replicated closing CSR; a CPU rank runs K10's plain version, which probes
the replicated edge hash instead, so only a CPU rank holds the hash. The
apex (u) credits of a bucket come back by one all-gather; the edge (x, y)
credits are summed per head over the rank's own slab entries (a stable
sort of the entries by head, padding as head n, the junk segment, done
once at install; then a K1 gather in head order and an int64 segment sum)
and one all-reduce sums the ranks' numerators. The spilled keys are
patched on the host, as on one device.

Not ported: the square/pairs bucket (``_dist_wedge_bucket``), the
``GRAPHTPU_LCC_PROBE`` knob and the dispatch slicing of a bucket's columns
(``_MAX_DISPATCH_PAIRS``, a TPU watchdog bound).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from graphtpu_torch.ops.edgehash import EdgeHash
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.scan_reduce import seg_sum_scan
from graphtpu_torch.ops.triangles import (
    ClosingCSR, _patch_spilled, coefficients, wedge_plan, wedge_rowblock,
)
from graphtpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_sum
from graphtpu_torch.parallel.partition import _round_up


class RankWedges(NamedTuple):
    """One rank's columns of every bucket, and what closes and sums them."""

    buckets: tuple                # (slab [W, r_dev], mslab [W, r_dev], r_real, chunk_cols)
    pos: torch.Tensor             # [sum W * r_dev] int32: flat entry positions in head order
    hip: torch.Tensor             # [n + 2] int32: segment bounds by head (n: the padding)
    bucket_rows: torch.Tensor     # [sum R] int64 ranked centre ids, replicated
    closing: ClosingCSR           # replicated
    ehash: Optional[EdgeHash]     # replicated, on a CPU rank only


def _install_wedges(mesh: Mesh, key, buckets, bucket_rows, closing, ehash_table, n: int) -> None:
    """Per rank: keep its bucket columns and the replicated closing arrays
    (host arrays, or the plan's own tensors on the rank that built it) on
    its device, with the head order of its slab entries."""
    def dev(a):
        return torch.as_tensor(a).to(mesh.device).contiguous()

    bs = tuple((dev(s), dev(m), r_real, cc) for s, m, r_real, cc in buckets)
    heads = torch.cat([torch.where(s >= 0, s, n).reshape(-1) for s, _, _, _ in bs])
    heads_s, order = torch.sort(heads, stable=True)
    hip = torch.searchsorted(heads_s, torch.arange(n + 2, dtype=heads_s.dtype, device=mesh.device))
    ehash = None if ehash_table is None else EdgeHash(dev(ehash_table), int(ehash_table.shape[0]))
    mesh.state[key] = RankWedges(bs, order.to(torch.int32), hip.to(torch.int32), dev(bucket_rows),
                                 ClosingCSR(*(dev(a) for a in closing)), ehash)


def _rank_columns(a: torch.Tensor, d: int, r_dev: int, fill: int) -> torch.Tensor:
    """Columns [d * r_dev, (d + 1) * r_dev) of a [W, R_pad] slab, padded with
    ``fill`` past R_pad."""
    w, r_pad = a.shape
    lo, hi = d * r_dev, min((d + 1) * r_dev, r_pad)
    if lo == 0 and hi == r_dev:
        return a[:, :r_dev]
    out = a.new_full((w, r_dev), fill)
    if hi > lo:
        out[:, :hi - lo] = a[:, lo:hi]
    return out


def _per_rank(plan, num_devices: int, here: int, cpu_ranks: bool) -> list:
    """The install arguments of every rank: rank ``here`` (this process) gets
    the plan's tensors, the others host copies."""
    def host(t, d):
        return t if d == here else t.cpu().numpy()

    out = []
    for d in range(num_devices):
        buckets = []
        for b in plan.buckets:
            r_dev = _round_up(-(-b.slab.shape[1] // num_devices), b.chunk_cols)
            buckets.append((host(_rank_columns(b.slab, d, r_dev, -1), d),
                            host(_rank_columns(b.mslab, d, r_dev, 0), d), b.r_real,
                            b.chunk_cols))
        out.append((tuple(buckets), host(plan.bucket_rows, d),
                    tuple(host(t, d) for t in plan.closing),
                    host(plan.ehash.table, d) if cpu_ranks else None, plan.n))
    return out


def _lcc_body(mesh: Mesh, key, n: int, id_bits: int) -> np.ndarray:
    """Numerator per ranked vertex id (int64), on every rank."""
    st = mesh.state[key]
    edge_creds, apex = [], []
    for slab, mslab, r_real, chunk_cols in st.buckets:
        u_cred, edge_cred = wedge_rowblock(slab, mslab, st.ehash, id_bits, chunk_cols,
                                           st.closing)
        apex.append(all_gather_rows(u_cred)[:r_real])
        edge_creds.append(edge_cred.reshape(-1))
    ordered = table_gather(torch.cat(edge_creds), st.pos)
    num = seg_sum_scan(ordered, st.hip, acc_dtype=torch.int64, out_dtype=torch.int64)[:n]
    num = all_reduce_sum(num)
    # a bucket's rows are distinct, and no row is in two buckets
    num[st.bucket_rows] += torch.cat(apex).long()
    return num.cpu().numpy()


def lcc_oriented_dist_numerator(sg, plan) -> np.ndarray:
    """Triangle-credit numerator per ranked vertex id over the mesh, the
    one-device path's credit accounting."""
    numerator_ranked = np.zeros(plan.n, dtype=np.int64)
    if plan.buckets:
        mesh = sg.mesh
        key = sg.installed("lcc-wedge", _install_wedges, lambda: _per_rank(
            plan, sg.num_devices, mesh.rank, mesh.device.type == "cpu"))
        numerator_ranked = sg.mesh.call(_lcc_body, [(key, plan.n, plan.id_bits)]
                                        * sg.num_devices)
    _patch_spilled(plan, numerator_ranked)
    return numerator_ranked


def lcc_oriented_dist(sg, cache_dir=None) -> np.ndarray:
    """Local clustering coefficients (float64 per original vertex id) over
    the ShardedGraph's mesh. The wedge plan is the one-device path's,
    memoized on the Graph for this rank's device; with ``cache_dir`` the
    oriented edge list persists across runs. Raises WedgeCapacityError as
    the one-device path does."""
    plan = wedge_plan(sg.graph, cache_dir, device=sg.mesh.device)
    num_ranked = lcc_oriented_dist_numerator(sg, plan)
    return coefficients(num_ranked[plan.rank], plan.deg_s)
