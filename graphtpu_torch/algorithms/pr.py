"""PageRank, the Graphalytics variant with dangling-vertex redistribution
(counterpart of graphtpu/algorithms/pr.py).

Semantics of LAGr_PageRankGX as the reference calls it (pr.cpp:58-63):

    r_{t+1}(v) = (1-d)/n + d * ( sum_{u->v} r_t(u)/outdeg(u)
                                 + sum_{outdeg(u)=0} r_t(u)/n )

for a fixed iteration count. Each iteration is one plus.second slab SpMV
(kernel K3 per bucket, ops/spmv.py) and one sum for the dangling mass.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtpu_torch.algorithms.common import AlgorithmResult, float_dtype, register
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.semiring import PLUS_SECOND
from graphtpu_torch.ops.slab import SlabPlan
from graphtpu_torch.ops.spmv import build_pull_plan, slab_spmv
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig


def _pr_slab_kernel(plan: SlabPlan, out_deg: torch.Tensor, damping: torch.Tensor,
                    n: int, num_iterations: int) -> torch.Tensor:
    """Ranks after ``num_iterations`` steps; the dtype is damping's."""
    dtype = damping.dtype
    inv_n = torch.tensor(1.0 / n, dtype=dtype, device=out_deg.device)
    teleport = (1.0 - damping) * inv_n
    is_dangling = out_deg == 0
    safe_deg = torch.where(is_dangling, 1, out_deg).to(dtype)
    inv_deg = torch.where(is_dangling, 0.0, 1.0 / safe_deg)

    r = torch.full((n,), 1.0 / n, dtype=dtype, device=out_deg.device)
    for _ in range(num_iterations):
        pulled = slab_spmv(PLUS_SECOND, plan, r * inv_deg, n)
        dangling_mass = torch.where(is_dangling, r, 0.0).sum()
        r = teleport + damping * (pulled + dangling_mass * inv_n)
    return r


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
    if cfg.pr_impl == "scan":
        raise NotImplementedError(
            "pr-impl=scan (graphtpu/algorithms/pr.py:_pr_kernel) is not ported yet "
            "(ROADMAP Queue 1); use auto or slab"
        )
    if cfg.pr_impl not in ("auto", "slab"):
        raise ValueError(f"unknown pr-impl {cfg.pr_impl!r}; expected auto|slab|scan")
    dtype = float_dtype(cfg)
    device = torch.device(cfg.device)
    plan = _pull_plan_cached(graph, dtype, device)
    out_deg = torch.from_numpy(graph.out_degree.astype(np.int32)).to(device)
    ranks = _pr_slab_kernel(
        plan, out_deg, torch.tensor(params.damping_factor, dtype=dtype, device=device),
        graph.n, int(params.num_iterations),
    )
    return AlgorithmResult("pr", ranks.cpu().numpy(), iterations=params.num_iterations)
