"""Distributed convergence-adaptive WCC (counterpart of
graphtpu/parallel/adaptive_wcc.py), the JAX package's default distributed
WCC, on the symmetrized structure.

Two kernels share one phase machinery. Rounds whose changed labels fit
the capacities (rows, edges) are active steps: each rank compacts the
changed rows it owns (kernel K14), expands them through its local
symmetrized push CSR (kernel K5), scatter-mins their labels into an [n_pad]
vector of INT32_INF (K8's int32 mode, ``relax_min_i32``) and one all-reduce
of the minimum merges the ranks' vectors. Active steps
propagate minima only (no pointer jumps): a label then changes only through
an edge, so ``new < labels`` is the whole next changed set. Heavier rounds
are full steps: the neighbours' minimum label, then two pointer jumps on
the replicated vector.

* ``wcc-impl`` auto/slab (``_wcc_slab_body``): full steps on the bucket-split
  slab plan of the symmetrized in-edges (``slab_cdlp.local_step`` with
  reduce "min": K6 over the rank's buckets, K7 ``min_i32`` over its heavy
  stream, one all-gather, the inverse permutation's K1 gather); iteration 0
  reads the stored ids, which are the identity labels.
* ``wcc-impl`` adaptive (``_wcc_edge_body``): full steps on the rank's
  symmetrized pull block (K7 ``min_i32``, then an all-gather; iteration 0 on
  the stored ids).

One host loop with one host read a round replaces the JAX package's nested
while_loops; every branch reads replicated values only.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops.frontier import compact, expand, mask_status, relax_min_i32
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.spmv import csr_pull_reduce
from graphtpu_torch.parallel.adaptive_bfs import _local_csr
from graphtpu_torch.parallel.algorithms import _spmv_block
from graphtpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_min
from graphtpu_torch.parallel.slab_cdlp import (
    assembled, build_dist_slab_plan_from, install_plan, local_step,
)


def _build_prep(sg):
    """Each rank's slice of the symmetrized push CSR ([D, r+1] indptr,
    [D, r+1] degrees, [D, M] dst) and the replicated degrees [n_pad + 1],
    memoized on the ShardedGraph."""
    prep = getattr(sg, "_wcc_adaptive_prep", None)
    if prep is not None:
        return prep
    sym = sg.graph.symmetrized()
    push = _local_csr(sym.indptr.astype(np.int64), [sym.dst.astype(np.int32)], sg.n_pad,
                      sg.rows_per_dev, sg.num_devices)
    sdeg = np.zeros(sg.n_pad + 1, dtype=np.int32)
    sdeg[:sg.n] = np.diff(sym.indptr).astype(np.int32)
    prep = sg._wcc_adaptive_prep = (push, sdeg)
    return prep


def _finish(labels, neigh_min):
    """min with the neighbours' minimum, then two pointer jumps: (new
    labels, changed mask)."""
    new = torch.minimum(labels, neigh_min)
    new = torch.minimum(new, table_gather(new, new))
    new = torch.minimum(new, table_gather(new, new))
    return new, new < labels


def _adaptive_loop(mesh: Mesh, key, n: int, r: int, k_cap: int, e_cap: int, full_step,
                   labels, changed):
    """The phases from iteration 0's (labels, changed): an active step while
    the changed set fits (k_cap, e_cap), else a full step. Returns (labels
    [n] on the host, iterations, full steps with iteration 0)."""
    ((pi, pdeg, pdst),), sdeg_pad = mesh.state[key]
    n_pad = sdeg_pad.shape[0] - 1
    sdeg_n = sdeg_pad[:-1]
    my = mesh.rank * r

    def derive(changed):
        cnt, ce = mask_status(changed, sdeg_n).tolist()
        return cnt <= k_cap and ce <= e_cap, cnt > 0

    def active_step(labels, changed):
        ids_l, _ = compact(changed[my:my + r], k_cap)
        exp = expand(ids_l, pdeg, pi, pdst, e_cap)
        cand = relax_min_i32(n_pad, labels, exp.row_ids, exp.neigh, exp.edge_count, my)
        new = torch.minimum(labels, all_reduce_min(cand))
        return new, new < labels

    ok, nonempty = derive(changed)
    it, nf = 1, 1
    while nonempty and it < n:
        if ok:
            labels, changed = active_step(labels, changed)
        else:
            labels, changed = full_step(labels)
            nf += 1
        ok, nonempty = derive(changed)
        it += 1
    return labels[:n].cpu().numpy(), it, nf


def _wcc_edge_body(mesh: Mesh, key, coo_key, n: int, r: int, k_cap: int, e_cap: int):
    shard = mesh.state[coo_key]
    n_pad = mesh.state[key][1].shape[0] - 1
    c = shard.count

    def full_step(labels):
        return _finish(labels, _spmv_block("min_i32", shard, labels))

    # padding rows keep their (unique, larger than any real) identity labels
    labels0 = torch.arange(n_pad, dtype=torch.int32, device=mesh.device)
    neigh0 = all_gather_rows(csr_pull_reduce("min_i32", None, shard.src[:c], shard.indptr))
    return _adaptive_loop(mesh, key, n, r, k_cap, e_cap, full_step, *_finish(labels0, neigh0))


def _wcc_slab_body(mesh: Mesh, key, plan_key, n: int, r: int, k_cap: int, e_cap: int):
    rs = mesh.state[plan_key]
    n_pad = mesh.state[key][1].shape[0] - 1
    pad_inf = torch.full((n_pad - n,), INT32_INF, dtype=torch.int32, device=mesh.device)

    def neigh_min(labels, first):
        gathered = local_step(rs, labels, first, reduce="min")
        nm = torch.where(rs.has_neighbors, assembled(rs, gathered), INT32_INF)
        return torch.cat([nm, pad_inf])

    def full_step(labels):
        return _finish(labels, neigh_min(labels, None))

    labels0 = torch.arange(n_pad, dtype=torch.int32, device=mesh.device)
    return _adaptive_loop(mesh, key, n, r, k_cap, e_cap, full_step,
                          *_finish(labels0, neigh_min(labels0, "min")))


def _build_slab_plan(sg):
    """The bucket-split slab plan of the symmetrized in-edges, memoized."""
    from graphtpu_torch.parallel.checkpoint import cached_plan

    def build():
        src, dst, _ = sg.graph.symmetrized().pull_arrays()
        return build_dist_slab_plan_from(dst.astype(np.int64), src.astype(np.int32), sg.n,
                                         sg.num_devices, None)

    return cached_plan(sg, "_dist_wcc_slab_plan", "wcc-slab", build)


def wcc_adaptive_dist(sg, cfg=None, with_stats: bool = False):
    """Distributed adaptive WCC on a ShardedGraph: (labels [n] int32, the
    smallest dense id of each component, rounds), and with ``with_stats``
    the JAX package's dict (full and active steps are counted on the slab
    impl only, as there)."""
    push, sdeg = _build_prep(sg)
    key = sg.installed_parts("wcc-adaptive", (push,), (sdeg,))
    k_cap = int(getattr(cfg, "wcc_frontier_rows", 0) or 1 << 16)
    e_cap = int(getattr(cfg, "wcc_frontier_edges", 0) or 1 << 18)
    impl = getattr(cfg, "wcc_impl", "auto") or "auto"
    slab = impl in ("auto", "slab")
    stats = {"impl": "slab" if slab else "adaptive", "e_cap": e_cap, "k_cap": k_cap}
    if slab:
        plan = _build_slab_plan(sg)
        if not plan.bucket_slabs and plan.heavy is None:
            # edgeless graph: every vertex is its own component
            out = np.arange(sg.n, dtype=np.int32)
            stats.update(full_steps=0, active_steps=0)
            return (out, 0, stats) if with_stats else (out, 0)
        args = (key, install_plan(sg, "wcc-slab", plan), sg.n, sg.rows_per_dev, k_cap, e_cap)
        labels, it, nf = sg.mesh.call(_wcc_slab_body, [args] * sg.num_devices)
        stats.update(full_steps=nf, active_steps=it - nf)
    else:
        args = (key, sg.pull_symmetrized(), sg.n, sg.rows_per_dev, k_cap, e_cap)
        labels, it, _ = sg.mesh.call(_wcc_edge_body, [args] * sg.num_devices)
        stats.update(full_steps=None, active_steps=None)
    return (labels, it, stats) if with_stats else (labels, it)
