"""A single forward step of the port's PageRank scan arm (counterpart of
``__graft_entry__.entry()``).

``entry()`` gives one Graphalytics PageRank power iteration (the pull sum
on kernel K7 in mode sum, then the dangling mass redistributed) over an
RMAT power-law graph, the loop body of ``algorithms/pr.py:_pr_kernel``, and
its example arguments, on the card unless ``device`` says otherwise:

    step, args = entry()
    r1 = step(*args)

``dryrun_multichip(n)`` runs the naive distributed PageRank, BFS and CDLP
over n gloo ranks on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtpu_torch.algorithms.pr import _pr_kernel
from graphtpu_torch.ops.spmv import PullCSR, pull_csr
from graphtpu_torch.utils.synth import rmat_graph


def pr_step(src: torch.Tensor, indptr: torch.Tensor, out_deg: torch.Tensor,
            damping: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """One PageRank-GX iteration from ranks ``r`` through ``_pr_kernel``."""
    return _pr_kernel(PullCSR(src, indptr), out_deg, damping, r.shape[0], 1, r)


def entry(device: str = "cuda"):
    """(pr_step, example_args) on ``rmat_graph(10, 8, directed=True, seed=0)``
    in float32, with d = 0.85 and the uniform ranks 1/n."""
    g = rmat_graph(10, 8, directed=True, seed=0)
    csr = pull_csr(g, device)
    out_deg = torch.from_numpy(g.out_degree.astype(np.int32)).to(device)
    damping = torch.tensor(0.85, dtype=torch.float32, device=device)
    r0 = torch.full((g.n,), 1.0 / g.n, dtype=torch.float32, device=device)
    return pr_step, (csr.src, csr.indptr, out_deg, damping, r0)


def dryrun_multichip(n_devices: int) -> None:
    """One distributed step of each naive kernel over ``n_devices`` gloo ranks
    on the CPU (counterpart of ``__graft_entry__.dryrun_multichip``): the
    segment-sum PageRank (2 iterations), BFS from vertex 0 and CDLP by a
    per-rank sort (2 iterations) on the JAX dry run's graph,
    ``uniform_graph(64 n, 1024 n, directed, seed 0)``, with its checks:
    PageRank's mass is kept, the source is at level 0, every vertex has a
    label. The ranks stop afterwards."""
    from graphtpu_torch.parallel import algorithms as dist
    from graphtpu_torch.parallel.mesh import make_mesh
    from graphtpu_torch.parallel.partition import ShardedGraph
    from graphtpu_torch.utils.config import PlatformConfig
    from graphtpu_torch.utils.synth import uniform_graph

    naive = PlatformConfig(device="cpu", pr_impl="segment", bfs_impl="dense", cdlp_impl="sort")
    mesh = make_mesh(n_devices, "cpu")
    try:
        g = uniform_graph(64 * n_devices, 1024 * n_devices, directed=True, seed=0)
        sg = ShardedGraph(g, mesh, wdtype=np.float32)
        ranks = dist.pr_dist(sg, 0.85, 2, cfg=naive)
        levels, _ = dist.bfs_dist(sg, 0, naive)
        labels, _ = dist.cdlp_dist(sg, 2, naive)
    finally:
        mesh.close()
    total = float(ranks.sum())
    assert 0.9 < total < 1.1, f"PageRank mass not conserved: {total}"
    assert int(levels[0]) == 0, "BFS source level wrong"
    assert labels.shape[0] == sg.n
