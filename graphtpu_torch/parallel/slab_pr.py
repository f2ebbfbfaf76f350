"""Distributed slab PageRank (counterpart of graphtpu/parallel/slab_pr.py),
the JAX package's default distributed PageRank.

The pull sum runs over the bucket-split slab plan of the in-edges
(``slab_cdlp.build_dist_slab_plan_from``): each rank sums its columns of
every bucket in one launch of kernel K3 (``slab_spmv_sum_buckets``) and its
heavy rows by one launch of K7 in mode ``sum`` over its edge stream (the
padding's junk segment cut off; on the card over its sliced pull, built
once and kept beside the plan in the rank's state); one all-gather and the inverse
permutation's K1 gather give the pulled vector on every rank. The dangling
mass and the teleport term are computed alike on every rank
(LAGr_PageRankGX, pr.cpp:58-63). The sums add in another order than the
JAX package's, so ranks agree with it to rounding, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtpu_torch.ops.spmv import csr_pull_reduce, memo_pull_slices, slab_spmv_sum_buckets
from graphtpu_torch.parallel.mesh import Mesh, all_gather_rows
from graphtpu_torch.parallel.partition import install_arrays
from graphtpu_torch.parallel.slab_cdlp import (
    RankSlabs, assembled, build_dist_slab_plan_from, install_plan,
)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def pull_step(rs: RankSlabs, x: torch.Tensor, slices=None) -> torch.Tensor:
    """This rank's pull sums of ``x`` (K3 over its buckets, then its heavy
    rows, on their sliced pull ``slices``), all-gathered: the [D * L]
    blocks in rank order."""
    buf = torch.empty(rs.length, dtype=x.dtype, device=x.device)
    slab_spmv_sum_buckets(rs.plan, x, buf)
    if rs.heavy is not None:
        _, nb, ip = rs.heavy
        total = rs.plan.table.total
        buf[total:] = csr_pull_reduce("sum", x, nb, ip, slices=slices)[:rs.length - total]
    return all_gather_rows(buf)


def _pr_body(mesh: Mesh, key, deg_key, damping: float, n: int, iters: int, dtype: str):
    """``iters`` steps of r <- teleport + d * (pull(r / outdeg) + dangling
    mass / n) from the uniform 1/n."""
    dev, dt = mesh.device, _DTYPES[dtype]
    rs = mesh.state[key]
    (out_deg,) = mesh.state[deg_key]
    damping = torch.tensor(damping, dtype=dt, device=dev)
    inv_n = torch.tensor(1.0 / n, dtype=dt, device=dev)
    teleport = (1.0 - damping) * inv_n
    is_dangling = out_deg == 0
    safe_deg = torch.where(is_dangling, 1, out_deg).to(dt)
    inv_deg = torch.where(is_dangling, 0.0, 1.0 / safe_deg)
    r = torch.full((n,), 1.0 / n, dtype=dt, device=dev)
    # the heavy rows' sliced pull, kept beside the plan on the rank
    slices = None if rs.heavy is None else memo_pull_slices(mesh.state, key, *rs.heavy[1:], dt)
    for _ in range(iters):
        if rs.length:
            pulled = torch.where(rs.has_neighbors,
                                 assembled(rs, pull_step(rs, r * inv_deg, slices)), 0.0)
        else:  # no edges: nothing to pull
            pulled = torch.zeros_like(r)
        dangling_mass = torch.where(is_dangling, r, 0.0).sum()
        r = teleport + damping * (pulled + dangling_mass * inv_n)
    return r.cpu().numpy()


def pr_slab_dist(sg, damping: float, num_iterations: int, dtype=np.float32) -> np.ndarray:
    """Distributed slab PageRank on a ShardedGraph: ranks [n] on the host.
    The pull plan (built, or restored from its checkpoint) and the
    out-degrees are installed once."""
    from graphtpu_torch.parallel.checkpoint import cached_plan

    def build():
        src, dst, _ = sg.graph.pull_arrays()
        return build_dist_slab_plan_from(dst.astype(np.int64), src.astype(np.int32), sg.n,
                                         sg.num_devices, None)

    plan = cached_plan(sg, "_dist_pr_plan", "pr-pull", build)
    key = install_plan(sg, "pr-pull", plan)
    deg = sg.graph.out_degree.astype(np.int32)
    deg_key = sg.installed("out-degree", install_arrays, lambda: [(deg,)] * sg.num_devices)
    args = (key, deg_key, float(damping), sg.n, int(num_iterations), np.dtype(dtype).name)
    return sg.mesh.call(_pr_body, [args] * sg.num_devices)
