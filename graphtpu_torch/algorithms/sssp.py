"""Single-source shortest paths (counterpart of graphtpu/algorithms/sssp.py):
min.plus relaxation to a fixed point.

Semantics of the reference (sssp.cpp:60-78): distances from the source over
the directed weighted edges; unreachable vertices serialize as the literal
"infinity" (sssp.cpp:45). Distances are computed in ``float_dtype(cfg)``
(float32, or float64 under precision=float64) and returned as float64.

``sssp_impl``:

* "auto" / "adaptive": changed-set Bellman-Ford on a tier ladder. A round
  whose changed vertices fit a tier's (rows, edges) budget relaxes only
  their out-edges, at the smallest fitting tier: an expansion on the
  frontier engine (kernel K5) and a scatter-min (kernel K8). Heavier rounds
  relax every edge (kernel K7 in min-plus mode). JAX runs the phases as
  nested while_loops in one program; here they are a host loop with one
  small device-to-host read per round, and the counts of full and tier
  rounds are the JAX kernel's.
* "device": full rounds only (``_sssp_kernel``).
* "hybrid" (host relaxations of sparse rounds) and "delta" (delta-stepping)
  are not ported yet.

Every candidate is the same addition dist[u] + w in both packages and min
is exact in any order, so the distances equal the JAX package's bit for
bit in the same dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from graphtpu_torch.algorithms.common import AlgorithmResult, float_dtype, register
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.ops.frontier import compact, expand, mask_status, relax_min
from graphtpu_torch.ops.spmv import PullCSR, csr_pull_reduce, int32_tensor, pull_csr
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig

IMPLS = ("auto", "adaptive", "device", "hybrid", "delta")


class SsspPrep(NamedTuple):
    """Device arrays of the SSSP runs, per graph, device and dtype."""

    pull: PullCSR
    pull_w: torch.Tensor       # [m] weights in pull order
    deg_pad: torch.Tensor      # [n+1] out-degrees, 0 at n
    push_indptr: torch.Tensor  # [n+1]
    push_dst: torch.Tensor     # [m]
    push_w: torch.Tensor       # [m] weights in push order


def sssp_prep(graph: Graph, dtype: torch.dtype, device) -> SsspPrep:
    """Memoized on the Graph by device and dtype. Weights are cast on the
    host, as the JAX package casts them."""
    key = ("sssp_prep", str(dtype), str(torch.device(device)))
    prep = graph.memo.get(key)
    if prep is None:
        np_dtype = np.float64 if dtype == torch.float64 else np.float32

        def to_w(a):
            return torch.from_numpy(np.ascontiguousarray(a, np_dtype)).to(device)

        prep = SsspPrep(
            pull_csr(graph, device), to_w(graph.pull_arrays()[2]),
            int32_tensor(np.concatenate([graph.out_degree, [0]]), device),
            int32_tensor(graph.indptr, device), int32_tensor(graph.dst, device),
            to_w(graph.w),
        )
        graph.memo[key] = prep
    return prep


def _sssp_dense_step(dist, pull: PullCSR, pull_w):
    """One synchronous relaxation of every edge, on K7: (new dist, changed mask)."""
    relaxed = csr_pull_reduce("min_plus", dist, pull.src, pull.indptr, pull_w)
    new = torch.minimum(dist, relaxed)
    return new, new < dist


def _initial(n: int, source: int, dtype, device) -> torch.Tensor:
    dist = torch.full((n,), float("inf"), dtype=dtype, device=device)
    dist[source] = 0.0
    return dist


def _sssp_kernel(prep: SsspPrep, source: int, n: int, dtype):
    """Full rounds to the fixed point: (dist, rounds)."""
    dist = _initial(n, source, dtype, prep.deg_pad.device)
    changed, it = True, 0
    while changed and it < n:
        with record_function("sssp.full_step"):
            dist, mask = _sssp_dense_step(dist, prep.pull, prep.pull_w)
            changed = bool(mask.any())
        it += 1
    return dist, it


def _sssp_adaptive_loop(prep: SsspPrep, source: int, n: int, dtype, tiers):
    """The JAX kernel's phases as one host loop: each round runs the
    smallest tier whose budgets hold the changed set, else a full round.
    Returns (dist, rounds, per-phase round counts [tiers..., full])."""
    deg_n = prep.deg_pad[:-1]
    T = len(tiers)
    FULL = T
    k_max = tiers[-1][0]
    counts = [0] * (T + 1)

    def chosen(acnt, ae):
        for i, (k_i, e_i) in enumerate(tiers):
            if acnt <= k_i and ae <= e_i:
                return i
        return FULL

    def derive(mask):
        ids, _ = compact(mask, k_max)
        acnt, ae = mask_status(mask, deg_n).tolist()
        return ids, acnt, ae

    def tier_step(dist, ids, i):
        k_i, e_i = tiers[i]
        exp = expand(ids[:k_i], prep.deg_pad, prep.push_indptr, prep.push_dst, e_i)
        new = relax_min(dist, exp.row_ids, exp.neigh, exp.gpos, exp.valid, prep.push_w)
        return (new,) + derive(new < dist)

    dist = _initial(n, source, dtype, deg_n.device)
    fmask0 = torch.zeros(n, dtype=torch.bool, device=deg_n.device)
    fmask0[source] = True
    ids, acnt, ae = derive(fmask0)
    it = 0
    while acnt > 0 and it < n:
        phase = chosen(acnt, ae)
        counts[phase] += 1
        if phase < T:
            with record_function("sssp.tier_step"):
                dist, ids, acnt, ae = tier_step(dist, ids, phase)
        else:
            with record_function("sssp.full_step"):
                dist, mask = _sssp_dense_step(dist, prep.pull, prep.pull_w)
                ids, acnt, ae = derive(mask)
        it += 1
    return dist, it, counts


def sssp_tiers(k_cap: int, e_cap: int, cfg=None) -> tuple:
    """The frontier ladder: a small tier at 1/8 of the configured budgets
    under the (sssp-frontier-rows, sssp-frontier-edges) tier. ``sssp-tiers``
    (comma edge budgets, rows e/4 capped at the configured rows) overrides."""
    cfg_tiers = getattr(cfg, "sssp_tiers", "") or ""
    if cfg_tiers:
        edge_tiers = sorted({int(t) for t in str(cfg_tiers).split(",") if t})
        return tuple((min(k_cap, max(e // 4, 1)), e) for e in edge_tiers)
    small = (max(k_cap // 8, 1), max(e_cap // 8, 1))
    return (small, (k_cap, e_cap)) if small != (k_cap, e_cap) else ((k_cap, e_cap),)


def sssp_adaptive_run(graph: Graph, src_dense: int, cfg: PlatformConfig, dtype=torch.float32,
                      with_stats: bool = False):
    """Tiered changed-set Bellman-Ford. Returns (dist on cfg.device,
    rounds), and with ``with_stats`` also the JAX package's dict of
    full_steps, active_steps, tier_steps, tiers, e_cap and k_cap."""
    prep = sssp_prep(graph, dtype, cfg.device)
    k_cap = int(cfg.sssp_frontier_rows or 1 << 16)
    e_cap = int(cfg.sssp_frontier_edges or 1 << 18)
    tiers = sssp_tiers(k_cap, e_cap, cfg)
    dist, niter, c = _sssp_adaptive_loop(prep, src_dense, graph.n, dtype, tiers)
    if with_stats:
        stats = {
            "full_steps": c[-1],
            "active_steps": niter - c[-1],
            "tier_steps": {int(e): c[i] for i, (_, e) in enumerate(tiers)},
            "tiers": [(int(k), int(e)) for k, e in tiers],
            "e_cap": e_cap,
            "k_cap": k_cap,
        }
        return dist, niter, stats
    return dist, niter


@register("sssp")
def sssp(graph: Graph, params: AlgorithmParams, cfg: PlatformConfig) -> AlgorithmResult:
    if params.source_vertex is None:
        raise ValueError("sssp requires source-vertex")
    if params.weight_property not in (None, "weight"):
        # the ingested graph keeps exactly one edge property, "weight"
        raise ValueError(
            f"unsupported sssp weight-property {params.weight_property!r}; "
            "only 'weight' exists in the ingested graph"
        )
    impl = cfg.sssp_impl
    if impl not in IMPLS:
        raise ValueError(f"unknown sssp-impl {impl!r}; expected {'|'.join(IMPLS)}")
    if impl in ("hybrid", "delta"):
        where = {"hybrid": "sssp_hybrid_run, ROADMAP Queue 1, item 14",
                 "delta": "_sssp_delta_kernel, ROADMAP Queue 1, item 9"}[impl]
        raise NotImplementedError(
            f"sssp-impl={impl} (graphtpu/algorithms/sssp.py:{where}) is not ported yet; "
            "use auto, adaptive or device"
        )
    dtype = float_dtype(cfg)
    src_dense = graph.dense_source(params.source_vertex)
    if impl == "device":
        dist, niter = _sssp_kernel(sssp_prep(graph, dtype, cfg.device), src_dense, graph.n,
                                   dtype)
    else:
        dist, niter = sssp_adaptive_run(graph, src_dense, cfg, dtype)
    return AlgorithmResult("sssp", dist.cpu().numpy().astype(np.float64), iterations=int(niter))
