"""The naive distributed kernels over a row-partitioned mesh (counterpart of
the naive arms of graphtpu/parallel/algorithms.py).

Each loop has its single-device sibling's semantics and step sequence.
Per step, every rank reduces the edges that end in its row block with the
port's kernels on its own block (``_spmv_block``: K7 over the block's pull
CSR, whose gather is K1's), then the dense iterate is replicated again by
one all-gather of the row blocks. The dense update then runs on every rank
alike, so each rank reaches the same convergence flag with no other
collective. The per-rank bodies are module-level functions that
``Mesh.call`` runs on every rank; the ``*_dist`` functions are the callers.

* ``pr_dist`` (``pr-impl=segment``, or the port's name ``scan``): PageRank
  on K7 in mode sum;
* ``bfs_dist`` (``bfs-impl=dense`` or ``device``): one K7 ``max_i32``
  pull a level;
* ``sssp_dist`` (``sssp-impl=dense`` or ``device``): one K7 ``min_plus``
  sweep a round;
* ``wcc_dist`` (``wcc-impl=dense`` or ``device``): one K7 ``min_i32``
  sweep a round on the symmetrized structure, then two pointer jumps;
* ``cdlp_dist`` (``cdlp-impl=sort``): each rank sorts and run-length scans
  its own centre block (``ops/minmode.py:stream_minmode``);
* ``lcc_dist`` (``lcc-impl=sweep``): the membership sweep's A-edges split
  over the ranks, the numerators summed by one all-reduce.

The JAX package's default distributed impls (slab CDLP and PageRank,
adaptive BFS, SSSP and WCC, oriented-wedge LCC) are ROADMAP Queue 1
sub-slices 2b-2d; ``dispatch.try_run_distributed`` declines them.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.spmv import csr_pull_reduce
from graphtpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_sum
from graphtpu_torch.parallel.partition import ShardedCOO, ShardedGraph

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


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


def pr_dist(sg: ShardedGraph, damping: float, num_iterations: int, dtype=np.float32):
    """Distributed PageRank (the segment-sum pull on K7): ranks [n]."""
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


def bfs_dist(sg: ShardedGraph, source_dense: int):
    """Distributed BFS, one full-edge pull a level: (int32 levels [n] with
    INT32_INF unreachable, levels run including the last, empty one)."""
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


def sssp_dist(sg: ShardedGraph, source_dense: int):
    """Distributed SSSP, one full min.plus sweep a round, in the graph's
    wdtype: (float64 distances [n], rounds)."""
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


def wcc_dist(sg: ShardedGraph):
    """Distributed WCC on the symmetrized structure: (labels [n], rounds)."""
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


def cdlp_dist(sg: ShardedGraph, itermax: int):
    """Distributed CDLP by a per-rank sort: (dense-id labels [n], iterations)."""
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


def lcc_dist(sg: ShardedGraph) -> np.ndarray:
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
