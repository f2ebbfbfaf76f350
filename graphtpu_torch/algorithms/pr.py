"""PageRank, the Graphalytics variant with dangling-vertex redistribution
(counterpart of graphtpu/algorithms/pr.py).

Semantics of LAGr_PageRankGX as the reference calls it (pr.cpp:58-63):

    r_{t+1}(v) = (1-d)/n + d * ( sum_{u->v} r_t(u)/outdeg(u)
                                 + sum_{outdeg(u)=0} r_t(u)/n )

for a fixed iteration count. Each iteration is one pull sum and one sum
for the dangling mass. ``pr-impl`` picks the pull: "auto"/"slab" a
plus.second slab SpMV (kernel K3 over the buckets, K7 in mode sum over
the heavy rows, ops/spmv.py), "scan"
(or "segment", the JAX package's name) a segment sum over the pull CSR
(kernel K7 in mode sum); on the card K7's sum runs on a sliced pull of its
CSR, memoized on the Graph beside the CSR or plan; spmv-impl=slab takes
the slab arm whatever pr-impl says, as in the JAX package (pr.py:105).
"""

from __future__ import annotations

import numpy as np
import torch

from graphtpu_torch.algorithms.common import AlgorithmResult, float_dtype, register
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.semiring import PLUS_SECOND
from graphtpu_torch.ops.slab import SlabPlan
from graphtpu_torch.ops.spmv import (
    PullCSR, PullSlices, build_pull_plan, csr_pull_reduce, memo_pull_slices, pull_csr, slab_spmv,
)
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig

# "segment" is the JAX package's name of its segment-sum arm on one
# device: it runs as "scan"
IMPLS = ("auto", "slab", "scan", "segment")
SPMV_IMPLS = ("scan", "xla", "slab")


def _pr_loop(pull, out_deg: torch.Tensor, damping: torch.Tensor, n: int,
             num_iterations: int, r: torch.Tensor | None = None) -> torch.Tensor:
    """Ranks after ``num_iterations`` steps of r <- teleport + d * (pull(r /
    outdeg) + dangling mass / n) from ``r`` (default the uniform 1/n); the
    dtype is damping's."""
    dtype = damping.dtype
    inv_n = torch.tensor(1.0 / n, dtype=dtype, device=out_deg.device)
    teleport = (1.0 - damping) * inv_n
    is_dangling = out_deg == 0
    safe_deg = torch.where(is_dangling, 1, out_deg).to(dtype)
    inv_deg = torch.where(is_dangling, 0.0, 1.0 / safe_deg)
    if r is None:
        r = torch.full((n,), 1.0 / n, dtype=dtype, device=out_deg.device)
    for _ in range(num_iterations):
        pulled = pull(r * inv_deg)
        dangling_mass = torch.where(is_dangling, r, 0.0).sum()
        r = teleport + damping * (pulled + dangling_mass * inv_n)
    return r


def heavy_slices(plan: SlabPlan, dtype: torch.dtype, memo: dict | None = None,
                 key=None) -> PullSlices | None:
    """The sliced pull of a slab plan's heavy rows for K7's mode sum
    (memoized in ``memo`` under ``key``); None without heavy rows or where
    the kernel does not run."""
    if plan.heavy_rows is None:
        return None
    return memo_pull_slices({} if memo is None else memo, key, plan.heavy_neigh,
                            plan.heavy_indptr, dtype)


def _pr_slab_kernel(plan: SlabPlan, out_deg: torch.Tensor, damping: torch.Tensor,
                    n: int, num_iterations: int,
                    slices: PullSlices | None = None) -> torch.Tensor:
    """The slab arm: each pull is one K3 launch over the plan's buckets and
    one K7 launch in mode sum over its heavy rows, on their sliced pull
    ``slices`` (built here, once a call, where the caller has none)."""
    if slices is None:
        slices = heavy_slices(plan, damping.dtype)
    return _pr_loop(lambda x: slab_spmv(PLUS_SECOND, plan, x, n, heavy_slices=slices), out_deg,
                    damping, n, num_iterations)


def _pr_kernel(csr: PullCSR, out_deg: torch.Tensor, damping: torch.Tensor, n: int,
               num_iterations: int, r: torch.Tensor | None = None,
               slices: PullSlices | None = None) -> torch.Tensor:
    """The segment-sum arm (graphtpu/algorithms/pr.py:_pr_kernel): each
    pull is one K7 launch in mode sum over the pull CSR, the gather of
    r / outdeg by source fused into the row sums, on its sliced pull
    ``slices`` (built here, once a call, where the caller has none)."""
    if slices is None:
        slices = memo_pull_slices({}, None, csr.src, csr.indptr, damping.dtype)
    return _pr_loop(lambda x: csr_pull_reduce("sum", x, csr.src, csr.indptr, slices=slices),
                    out_deg, damping, n, num_iterations, r)


def _pull_plan_cached(graph: Graph, dtype: torch.dtype, device) -> SlabPlan:
    """The slab pull plan on ``device``, memoized on the Graph, so timed
    runs after prepare() neither rebuild it nor copy it to the device."""
    key = ("pr_pull_plan", str(dtype), str(device))
    plan = graph.memo.get(key)
    if plan is None:
        wdtype = np.float64 if dtype == torch.float64 else np.float32
        plan = build_pull_plan(graph, device=device, wdtype=wdtype, with_values=False)
        graph.memo[key] = plan
    return plan


@register("pr")
def pr(graph: Graph, params: AlgorithmParams, cfg: PlatformConfig) -> AlgorithmResult:
    if params.damping_factor is None or params.num_iterations is None:
        raise ValueError("pr requires damping-factor and num-iterations")
    if cfg.pr_impl not in IMPLS:
        raise ValueError(f"unknown pr-impl {cfg.pr_impl!r}; expected {'|'.join(IMPLS)}")
    if cfg.spmv_impl not in SPMV_IMPLS:
        raise ValueError(f"unknown spmv-impl {cfg.spmv_impl!r}; expected {'|'.join(SPMV_IMPLS)}")
    dtype = float_dtype(cfg)
    device = torch.device(cfg.device)
    out_deg = torch.from_numpy(graph.out_degree.astype(np.int32)).to(device)
    damping = torch.tensor(params.damping_factor, dtype=dtype, device=device)
    if cfg.pr_impl in ("auto", "slab") or cfg.spmv_impl == "slab":
        plan = _pull_plan_cached(graph, dtype, device)
        slices = heavy_slices(plan, dtype, graph.memo, ("pr_heavy", str(device)))
        ranks = _pr_slab_kernel(plan, out_deg, damping, graph.n, int(params.num_iterations),
                                slices)
    else:
        csr = pull_csr(graph, device)
        slices = memo_pull_slices(graph.memo, ("pull", str(device)), csr.src, csr.indptr, dtype)
        ranks = _pr_kernel(csr, out_deg, damping, graph.n, int(params.num_iterations),
                           slices=slices)
    return AlgorithmResult("pr", ranks.cpu().numpy(), iterations=params.num_iterations)
