"""The distributed loops over a row-partitioned mesh (counterpart of
graphtpu/parallel/algorithms.py): the wrappers that route each algorithm to
its distributed loop, as the JAX package's do, and the naive loops.

``pr_dist``, ``bfs_dist``, ``sssp_dist``, ``wcc_dist``, ``cdlp_dist`` and
``lcc_dist`` take the PlatformConfig. By default they run the JAX
package's default distributed loops: the slab PageRank and CDLP
(``slab_pr.py``, ``slab_cdlp.py``), the adaptive BFS, SSSP and WCC
(``adaptive_bfs.py``, ``adaptive_sssp.py``, ``adaptive_wcc.py``) and the
oriented-wedge LCC (``wedge_lcc.py``, with the sweep as its fall-back when
the wedge plan's capacity is exceeded, unless ``lcc-impl=oriented``). The
naive loops below run under the JAX package's names ``segment``,
``dense``, ``sort`` and ``sweep``, and under the port's one-device names
for the same loops, ``scan`` and ``device``.

Each naive loop has its single-device sibling's semantics and step
sequence. Per step, every rank reduces the edges that end in its row block
with the port's kernels on its own block (``_spmv_block``: K7 over the
block's pull CSR, whose gather is K1's), then the dense iterate is
replicated again by one all-gather of the row blocks. The dense update then
runs on every rank alike, so each rank reaches the same convergence flag
with no other collective. The per-rank bodies are module-level functions
that ``Mesh.call`` runs on every rank.

* PageRank on K7 in mode sum;
* BFS: one K7 ``max_i32`` pull a level;
* SSSP: one K7 ``min_plus`` sweep a round;
* WCC: one K7 ``min_i32`` sweep a round on the symmetrized structure, then
  two pointer jumps;
* CDLP: each rank sorts and run-length scans its own centre block
  (``ops/minmode.py:stream_minmode``);
* LCC: the membership sweep's A-edges split over the ranks, the numerators
  summed by one all-reduce.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.spmv import csr_pull_reduce
from graphtpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_sum
from graphtpu_torch.parallel.partition import ShardedCOO, ShardedGraph
from graphtpu_torch.utils.logging import get_logger

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the impl names that select each naive loop (the JAX package's, then the
# port's one-device names for the same loops)
_NAIVE = {
    "pr": ("segment", "scan"), "bfs": ("dense", "device"), "sssp": ("dense", "device"),
    "wcc": ("dense", "device"), "cdlp": ("sort",), "lcc": ("sweep",),
}


def _spmv_block(mode: str, shard: ShardedCOO, x: torch.Tensor) -> torch.Tensor:
    """One rank's part of a pull SpMV, replicated again: K7 in ``mode`` over
    the rank's CSR (its valid prefix), then the all-gather of the blocks."""
    c = shard.count
    w = shard.w[:c] if mode == "min_plus" else None
    return all_gather_rows(csr_pull_reduce(mode, x, shard.src[:c], shard.indptr, w))


def _host(t: torch.Tensor, n: int) -> np.ndarray:
    """The replicated result, on the host, without the padding rows."""
    return t[:n].cpu().numpy()


# --------------------------------------------------------------------- PR


def _pr_body(mesh: Mesh, key, out_deg: np.ndarray, damping: float, n: int, iters: int,
             dtype: str):
    """PageRank-GX over the padded vector: padding rows have degree 0 but
    count neither in n nor in the dangling mass."""
    dev, dt = mesh.device, _DTYPES[dtype]
    shard = mesh.state[key]
    out_deg = torch.from_numpy(out_deg).to(dev)
    n_pad = out_deg.shape[0]
    damping = torch.tensor(damping, dtype=dt, device=dev)
    inv_n = torch.tensor(1.0 / n, dtype=dt, device=dev)
    teleport = (1.0 - damping) * inv_n
    in_range = torch.arange(n_pad, device=dev) < n
    is_dangling = (out_deg == 0) & in_range
    safe_deg = torch.where(out_deg == 0, 1, out_deg).to(dt)
    inv_deg = torch.where(out_deg == 0, 0.0, 1.0 / safe_deg)
    r = torch.where(in_range, inv_n, 0.0).to(dt)
    for _ in range(iters):
        pulled = _spmv_block("sum", shard, r * inv_deg)
        dangling_mass = torch.where(is_dangling, r, 0.0).sum()
        r = torch.where(in_range, teleport + damping * (pulled + dangling_mass * inv_n), 0.0)
    return _host(r, n)


def pr_dist(sg: ShardedGraph, damping: float, num_iterations: int, dtype=np.float32, cfg=None):
    """Distributed PageRank: ranks [n]. By default the slab pull plan split
    per bucket over the ranks (``slab_pr.py``); ``pr-impl`` segment or scan
    runs the segment-sum pull on K7."""
    if (getattr(cfg, "pr_impl", "") or "slab") not in _NAIVE["pr"]:
        from graphtpu_torch.parallel.slab_pr import pr_slab_dist

        return pr_slab_dist(sg, damping, num_iterations, dtype=dtype)
    key = sg.pull()
    args = (key, sg.out_degree_padded(), float(damping), sg.n, int(num_iterations),
            np.dtype(dtype).name)
    return sg.mesh.call(_pr_body, [args] * sg.num_devices)


# --------------------------------------------------------------------- BFS


def _bfs_body(mesh: Mesh, key, source: int, n: int, n_pad: int):
    dev = mesh.device
    shard = mesh.state[key]
    levels = torch.full((n_pad,), INT32_INF, dtype=torch.int32, device=dev)
    levels[source] = 0
    frontier = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    frontier[source] = 1
    level, nonempty = 0, True
    while nonempty and level < n:
        reached = _spmv_block("max_i32", shard, frontier)
        frontier = torch.where(levels == INT32_INF, reached, 0)
        levels = torch.where(frontier == 1, level + 1, levels)
        nonempty = bool((frontier == 1).any())
        level += 1
    return _host(levels, n), level


def bfs_dist(sg: ShardedGraph, source_dense: int, cfg=None):
    """Distributed BFS: (int32 levels [n] with INT32_INF unreachable, levels
    run including the last, empty one). By default the three-phase adaptive
    loop (``adaptive_bfs.py``); ``bfs-impl`` dense or device runs one
    full-edge pull a level."""
    if (getattr(cfg, "bfs_impl", "") or "adaptive") not in _NAIVE["bfs"]:
        from graphtpu_torch.parallel.adaptive_bfs import bfs_adaptive_dist

        return bfs_adaptive_dist(sg, source_dense, cfg)
    key = sg.pull()
    return sg.mesh.call(_bfs_body, [(key, int(source_dense), sg.n, sg.n_pad)] * sg.num_devices)


# --------------------------------------------------------------------- SSSP


def _sssp_body(mesh: Mesh, key, source: int, n: int, n_pad: int):
    shard = mesh.state[key]
    dist = torch.full((n_pad,), float("inf"), dtype=shard.w.dtype, device=mesh.device)
    dist[source] = 0.0
    changed, it = True, 0
    while changed and it < n:
        new = torch.minimum(dist, _spmv_block("min_plus", shard, dist))
        changed = bool((new < dist).any())
        dist, it = new, it + 1
    return _host(dist, n), it


def sssp_dist(sg: ShardedGraph, source_dense: int, cfg=None):
    """Distributed SSSP in the graph's wdtype: (float64 distances [n],
    rounds). By default the tiered changed-set loop (``adaptive_sssp.py``);
    ``sssp-impl`` dense or device runs one full min.plus sweep a round."""
    if (getattr(cfg, "sssp_impl", "") or "adaptive") not in _NAIVE["sssp"]:
        from graphtpu_torch.parallel.adaptive_sssp import sssp_adaptive_dist

        return sssp_adaptive_dist(sg, source_dense, cfg)
    key = sg.pull()
    d, it = sg.mesh.call(_sssp_body, [(key, int(source_dense), sg.n, sg.n_pad)] * sg.num_devices)
    return d.astype(np.float64), it


# --------------------------------------------------------------------- WCC


def _wcc_body(mesh: Mesh, key, n: int, n_pad: int):
    shard = mesh.state[key]
    labels = torch.arange(n_pad, dtype=torch.int32, device=mesh.device)
    changed, it = True, 0
    while changed and it < n:
        new = torch.minimum(labels, _spmv_block("min_i32", shard, labels))
        new = torch.minimum(new, table_gather(new, new))
        new = torch.minimum(new, table_gather(new, new))
        changed = bool((new != labels).any())
        labels, it = new, it + 1
    return _host(labels, n), it


def wcc_dist(sg: ShardedGraph, cfg=None):
    """Distributed WCC on the symmetrized structure: (labels [n], rounds).
    By default the convergence-adaptive loop (``adaptive_wcc.py``);
    ``wcc-impl`` dense or device runs one full sweep a round."""
    if (getattr(cfg, "wcc_impl", "") or "adaptive") not in _NAIVE["wcc"]:
        from graphtpu_torch.parallel.adaptive_wcc import wcc_adaptive_dist

        return wcc_adaptive_dist(sg, cfg)
    key = sg.pull_symmetrized()
    return sg.mesh.call(_wcc_body, [(key, sg.n, sg.n_pad)] * sg.num_devices)


# --------------------------------------------------------------------- CDLP


def _cdlp_body(mesh: Mesh, key, deg: np.ndarray, n: int, rows: int, itermax: int):
    """Min-mode label propagation, each rank sorting only its centre block
    (the distributed form of LAGraph_cdlp.c:286's global sort)."""
    from graphtpu_torch.ops.minmode import stream_minmode

    dev = mesh.device
    inc = mesh.state[key]
    centers, neigh = inc.center_local[:inc.count], inc.neigh[:inc.count]
    lo = mesh.rank * rows
    local_has = torch.from_numpy(deg[lo:lo + rows] > 0).to(dev)
    labels = torch.arange(deg.shape[0], dtype=torch.int32, device=dev)
    changed, it = True, 0
    while changed and it < itermax:
        best = stream_minmode(labels, centers, neigh, inc.indptr)
        new = all_gather_rows(torch.where(local_has, best, labels[lo:lo + rows]))
        changed = bool((new != labels).any())
        labels, it = new, it + 1
    return _host(labels, n), it


def cdlp_dist(sg: ShardedGraph, itermax: int, cfg=None):
    """Distributed CDLP: (dense-id labels [n], iterations). By default the
    slab min-mode plan split per bucket over the ranks (``slab_cdlp.py``,
    with ``cfg.slab_buckets``); ``cdlp-impl=sort`` sorts per rank."""
    if (getattr(cfg, "cdlp_impl", "") or "slab") not in _NAIVE["cdlp"]:
        from graphtpu_torch.parallel.slab_cdlp import cdlp_slab_dist

        buckets = getattr(cfg, "slab_buckets", None)
        return cdlp_slab_dist(sg, itermax, tuple(buckets) if buckets else None)
    key = sg.incidence()
    args = (key, sg.incidence_degree_padded(), sg.n, sg.rows_per_dev, int(itermax))
    return sg.mesh.call(_cdlp_body, [args] * sg.num_devices)


# --------------------------------------------------------------------- LCC


def _lcc_body(mesh: Mesh, s_indptr: np.ndarray, s_dst: np.ndarray, n: int, search_iters: int,
              buckets: list):
    """This rank's share of the sweep's A-edges, bucket by bucket; the
    partial numerators summed over the ranks."""
    from graphtpu_torch.algorithms.lcc import _lcc_bucket_sweep

    dev = mesh.device
    indptr = torch.from_numpy(s_indptr).to(dev)
    col = torch.from_numpy(s_dst).to(dev)
    numerator = torch.zeros(n, dtype=torch.int64, device=dev)
    for pad, c, o in buckets:
        if c.shape[0]:
            _lcc_bucket_sweep(numerator, indptr, col, torch.from_numpy(c).to(dev),
                              torch.from_numpy(o).to(dev), pad, search_iters)
    return all_reduce_sum(numerator).cpu().numpy()


def lcc_dist(sg: ShardedGraph, cfg=None) -> np.ndarray:
    """Distributed LCC, coefficients float64 [n]. By default the
    oriented-wedge plan with its bucket columns split over the ranks
    (``wedge_lcc.py``); the membership sweep where ``lcc-impl=sweep``, or
    where the wedge plan's capacity is exceeded and lcc-impl is not
    ``oriented``."""
    impl = getattr(cfg, "lcc_impl", "") or "auto"
    if impl not in _NAIVE["lcc"]:
        from graphtpu_torch.ops.triangles import WedgeCapacityError
        from graphtpu_torch.parallel.wedge_lcc import lcc_oriented_dist

        try:
            return lcc_oriented_dist(sg, cache_dir=getattr(cfg, "intermediate_dir", None))
        except WedgeCapacityError:
            if impl == "oriented":
                raise
            get_logger("dist").warning(
                "wedge-plan capacity exceeded; falling back to membership sweep")
    return _lcc_dist_sweep(sg)


def _lcc_dist_sweep(sg: ShardedGraph) -> np.ndarray:
    """Distributed LCC by the membership sweep: each bucket's A-edges are
    cut into D contiguous runs of ceil(count / (D * chunk)) * chunk edges,
    the JAX package's split; coefficients float64 [n]."""
    from graphtpu_torch.algorithms.lcc import _CHUNK, _bucket_bounds, prepare_lcc
    from graphtpu_torch.ops.triangles import coefficients

    graph, d_count = sg.graph, sg.num_devices
    s_indptr, s_dst, s_deg, c, o, dc = prepare_lcc(graph)
    max_deg = int(s_deg.max()) if graph.n else 0
    search_iters = max(1, int(np.ceil(np.log2(max(max_deg, 2) + 1))))
    per_rank = [[] for _ in range(d_count)]
    for pad in _bucket_bounds(max_deg):
        lo_bound = 0 if pad == 16 else pad // 8
        sel = (dc > lo_bound) & (dc <= pad) if pad > 16 else dc <= pad
        cnt = int(sel.sum())
        if cnt == 0:
            continue
        per_dev = -(-cnt // (d_count * _CHUNK)) * _CHUNK
        flat_c, flat_o = c[sel], o[sel]
        for d in range(d_count):
            run = slice(d * per_dev, (d + 1) * per_dev)
            per_rank[d].append((pad, flat_c[run], flat_o[run]))
    num = sg.mesh.call(_lcc_body, [(s_indptr, s_dst, graph.n, search_iters, per_rank[d])
                                   for d in range(d_count)])
    return coefficients(num, s_deg)
