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
* "delta": bucketed delta-stepping, the reference's own method
  (LAGr_SingleSourceShortestPath with Delta = 2.5, sssp.cpp:70-78), on the
  same kernels (``sssp_delta_run``).
* "hybrid" (host relaxations of sparse rounds) is not ported yet.

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


class SplitCSR(NamedTuple):
    """The out-edges of one weight class (light or heavy) as a push CSR."""

    deg_pad: torch.Tensor  # [n+1] out-degrees within the class, 0 at n
    indptr: torch.Tensor   # [n+1]
    dst: torch.Tensor      # [m_class]
    w: torch.Tensor        # [m_class]


def sssp_delta_prep(graph: Graph, delta: float, dtype: torch.dtype, device):
    """(light, heavy): the push CSR split at w <= delta against w > delta,
    in CSR order, memoized on the Graph per (delta, dtype, device). An empty
    class is an empty CSR: no sentinel edge is needed here."""
    key = ("sssp_delta_prep", float(delta), str(dtype), str(torch.device(device)))
    prep = graph.memo.get(key)
    if prep is None:
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        n = graph.n
        w = graph.w.astype(np_dtype)
        light = w <= np_dtype(delta)
        src_rep = np.repeat(np.arange(n, dtype=np.int64), graph.out_degree)

        def split(mask):
            cnt = np.bincount(src_rep[mask], minlength=n).astype(np.int64)
            indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(cnt, out=indptr[1:])
            return SplitCSR(
                int32_tensor(np.concatenate([cnt, [0]]), device), int32_tensor(indptr, device),
                int32_tensor(graph.dst[mask], device),
                torch.from_numpy(np.ascontiguousarray(w[mask])).to(device),
            )

        prep = graph.memo[key] = (split(light), split(~light))
    return prep


def _sssp_delta_loop(prep: SsspPrep, light: SplitCSR, heavy: SplitCSR, source: int, n: int,
                     dtype, delta: float, k_cap: int, e_cap: int):
    """The JAX kernel's nested while_loops as one host loop, in its phase
    order. Vertices are taken in buckets of width delta by tentative
    distance. Within bucket k the light edges (w <= delta) relax to a fixed
    point: on the frontier engine (K5, K8) while the active set fits the
    capacities, else by one dense sweep of every edge (K7), which is always
    safe. Then the heavy edges of the settled bucket relax once, by frontier
    if the bucket fits, else by one dense sweep; they land past the next
    boundary, so a bucket is final when left. Then k becomes the smallest
    bucket above k that holds a vertex. Returns (dist, relaxation steps,
    per-phase step counts)."""
    dev = prep.deg_pad.device
    imax = np.iinfo(np.int32).max
    limit = 4 * n
    # bucket() in the run's dtype, with 1 / delta rounded to it, as in JAX
    inv_delta = torch.tensor(1.0 / delta, dtype=dtype, device=dev)
    top = torch.tensor(2**31 - 1, dtype=dtype, device=dev)
    counts = {"buckets": 0, "light_active": 0, "light_dense": 0, "heavy_active": 0,
              "heavy_dense": 0}

    def bucket(dist):
        # floor(dist / delta); inf, and what overflows int32, give imax
        b = torch.floor(dist * inv_delta)
        over = b >= top
        return torch.where(over, imax, torch.where(over, 0, b).to(torch.int32))

    def relax_frontier(dist, ids, csr: SplitCSR):
        """Scatter-min relaxation of the out-edges of ``ids`` in one CSR."""
        if not csr.dst.numel():  # a class without edges relaxes nothing
            return dist, torch.zeros(n, dtype=torch.bool, device=dev)
        exp = expand(ids, csr.deg_pad, csr.indptr, csr.dst, e_cap)
        new = relax_min(dist, exp.row_ids, exp.neigh, exp.gpos, exp.valid, csr.w)
        return new, new < dist

    def derive(mask, deg_n):
        """(ids, fits, any) of a mask: one read of (count, edge sum)."""
        ids, _ = compact(mask, k_cap)
        cnt, fe = mask_status(mask, deg_n).tolist()
        return ids, cnt <= k_cap and fe <= e_cap, cnt > 0

    def settle(changed, ids, improved):
        """changed with the relaxed ids cleared (pad ids dropped) and the
        improved vertices set."""
        pad = torch.cat([changed, changed.new_zeros(1)])
        return pad.index_fill_(0, ids.long(), False)[:n] | improved

    light_deg_n, heavy_deg_n = light.deg_pad[:-1], heavy.deg_pad[:-1]
    dist = _initial(n, source, dtype, dev)
    changed = torch.zeros(n, dtype=torch.bool, device=dev)
    changed[source] = True
    k, it = 0, 0
    while k < imax and it < limit:
        counts["buckets"] += 1
        ids, fits, any_a = derive(changed & (bucket(dist) == k), light_deg_n)
        while any_a and it < limit:
            while any_a and fits and it < limit:
                with record_function("sssp.delta_light_step"):
                    new, improved = relax_frontier(dist, ids, light)
                    changed = settle(changed, ids, improved)
                    dist = new
                    ids, fits, any_a = derive(changed & (bucket(dist) == k), light_deg_n)
                it += 1
                counts["light_active"] += 1
            while any_a and not fits and it < limit:
                with record_function("sssp.delta_dense_step"):
                    # a dense sweep relaxes every vertex's edges: the changed
                    # set becomes exactly the improved vertices
                    dist, changed = _sssp_dense_step(dist, prep.pull, prep.pull_w)
                    ids, fits, any_a = derive(changed & (bucket(dist) == k), light_deg_n)
                it += 1
                counts["light_dense"] += 1
        if it < limit:  # the heavy edges of the settled bucket, once
            with record_function("sssp.delta_heavy_step"):
                ids, fits, _ = derive(bucket(dist) == k, heavy_deg_n)
                if fits:
                    new, improved = relax_frontier(dist, ids, heavy)
                    changed = settle(changed, ids, improved)
                    dist = new
                else:
                    dist, changed = _sssp_dense_step(dist, prep.pull, prep.pull_w)
            it += 1
            counts["heavy_active" if fits else "heavy_dense"] += 1
        b = bucket(dist)
        k = int(torch.where(b > k, b, imax).min())
    return dist, it, counts


def sssp_delta_run(graph: Graph, src_dense: int, cfg: PlatformConfig, dtype=torch.float32,
                   with_stats: bool = False):
    """Delta-stepping SSSP. Returns (dist on cfg.device, relaxation steps),
    and with ``with_stats`` also the per-phase step counts."""
    delta = float(cfg.sssp_delta or 2.5)
    light, heavy = sssp_delta_prep(graph, delta, dtype, cfg.device)
    k_cap = int(cfg.sssp_frontier_rows or 1 << 16)
    e_cap = int(cfg.sssp_frontier_edges or 1 << 18)
    dist, niter, counts = _sssp_delta_loop(
        sssp_prep(graph, dtype, cfg.device), light, heavy, src_dense, graph.n, dtype, delta,
        k_cap, e_cap,
    )
    if with_stats:
        return dist, niter, dict(counts, delta=delta, k_cap=k_cap, e_cap=e_cap)
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
    if impl == "hybrid":
        raise NotImplementedError(
            "sssp-impl=hybrid (graphtpu/algorithms/sssp.py:sssp_hybrid_run, ROADMAP Queue 1) "
            "is not ported yet; use auto, adaptive, device or delta"
        )
    dtype = float_dtype(cfg)
    src_dense = graph.dense_source(params.source_vertex)
    if impl == "device":
        dist, niter = _sssp_kernel(sssp_prep(graph, dtype, cfg.device), src_dense, graph.n,
                                   dtype)
    elif impl == "delta":
        dist, niter = sssp_delta_run(graph, src_dense, cfg, dtype)
    else:
        dist, niter = sssp_adaptive_run(graph, src_dense, cfg, dtype)
    return AlgorithmResult("sssp", dist.cpu().numpy().astype(np.float64), iterations=int(niter))
