"""Breadth-first search (counterpart of graphtpu/algorithms/bfs.py).

Semantics of LAGr_BreadthFirstSearch as the reference uses it
(bfs.cpp:76-80): levels from the source over out-edges (directed) or all
edges (undirected); unreachable vertices serialize as int64 max
(bfs.cpp:47-64).

``bfs_impl``:

* "auto" / "adaptive": direction-optimizing BFS (``bfs_adaptive_run``).
  Each level runs the smallest push tier whose (rows, edges) budget holds
  its frontier, on the frontier engine (ops/frontier.py, kernels K1 and K5);
  frontiers above the top tier run a truncated bottom-up (its probe of the
  first in-neighbours on kernel K13, ``bfs_trunc_probe``, its residual rows'
  test on K17, ``bfs_residual_claim``); a bottom-up whose residual overflows its budgets, and only
  then, a dense pull step. JAX runs the phases as nested while_loops in one
  program (``bfs-step-mode=phases``) or as one while_loop over a switch of
  the step bodies (``switch``); here both are the same host loop over
  device tensors, which runs the step of the chosen phase, with one small
  device-to-host read per step. The step sequence, and so every phase
  counter, is the JAX kernel's under either mode. Frontiers are compacted
  on kernel K14.
* "device": dense pull steps only (``_bfs_kernel``), each one kernel K7
  launch over every edge.
* "hybrid": levels whose frontier's out-edges are at most
  ``bfs_active_threshold`` of the edges expand on the host over the push
  CSR (numpy); heavier levels run dense pull steps on K7 until the
  frontier is light again (``bfs_hybrid_run``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from graphtpu_torch.algorithms.common import AlgorithmResult, register
from graphtpu_torch.core.graph import Graph, frontier_edge_positions
from graphtpu_torch.core.types import INT32_INF, UNREACHABLE
from graphtpu_torch.ops.frontier import (
    bfs_trunc_probe,
    compact,
    compact_stream,
    expand,
    frontier_deg_sum,
    mask_status,
    residual_claim,
)
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.spmv import PullCSR, csr_pull_reduce, int32_tensor, pull_csr
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig

# "dense" is the JAX package's name of the dense kernel on one device:
# it runs as "device"
IMPLS = ("auto", "adaptive", "device", "dense", "hybrid")

# in-neighbours probed per row by the truncated bottom-up (the JAX
# package's measured default; bfs-trunc overrides)
BFS_TRUNC = 2


def _bfs_dense_step(levels, frontier, level: int, csr: PullCSR):
    """One dense level expansion (pull orientation), on K7: the updated
    levels and the new frontier mask."""
    reached = csr_pull_reduce("max_i32", frontier, csr.src, csr.indptr)
    new_frontier = torch.where(levels == INT32_INF, reached, 0)
    levels = torch.where(new_frontier == 1, level + 1, levels)
    return levels, new_frontier


def _bfs_kernel(csr: PullCSR, source: int, n: int):
    """Dense steps until the frontier is empty: (int32 levels with
    INT32_INF unreachable, steps including the last, empty one)."""
    dev = csr.src.device
    levels = torch.full((n,), INT32_INF, dtype=torch.int32, device=dev)
    levels[source] = 0
    frontier = torch.zeros(n, dtype=torch.int32, device=dev)
    frontier[source] = 1
    level, nonempty = 0, True
    while nonempty and level < n:
        with record_function("bfs.dense"):
            levels, frontier = _bfs_dense_step(levels, frontier, level, csr)
            nonempty = bool((frontier == 1).any())
        level += 1
    return levels, level


class BfsPrep(NamedTuple):
    """Device arrays of the adaptive BFS, per graph, device and trunc depth."""

    pull: PullCSR
    deg_pad: torch.Tensor       # [n+1] out-degrees, 0 at n
    push_indptr: torch.Tensor   # [n+1]
    push_dst: torch.Tensor      # [m] out-neighbours, (src, dst) order
    pull_deg_pad: torch.Tensor  # [n+1] in-degrees, 0 at n
    trunc_tbl: torch.Tensor     # [t*n] t-th smallest in-neighbour of v at t*n + v, n past deg


def bfs_adaptive_prep(graph: Graph, t_trunc: int, device) -> BfsPrep:
    """The adaptive kernel's arrays on ``device``, memoized on the Graph by
    device and ``t_trunc``. The probe table is built on the host, as the
    JAX package builds it."""
    key = ("bfs_adaptive_prep", t_trunc, str(torch.device(device)))
    prep = graph.memo.get(key)
    if prep is None:
        n = graph.n
        pull_deg = np.diff(graph.pull_indptr)
        psrc = graph.pull_arrays()[0]
        offs = np.arange(t_trunc, dtype=np.int64)
        pos = graph.pull_indptr[:-1, None] + offs[None, :]
        valid = offs[None, :] < pull_deg[:, None]
        trunc = np.full((n, t_trunc), n, dtype=np.int32)
        trunc[valid] = psrc[np.minimum(pos, max(len(psrc) - 1, 0))[valid]]
        prep = BfsPrep(
            pull_csr(graph, device),
            int32_tensor(np.concatenate([graph.out_degree, [0]]), device),
            int32_tensor(graph.indptr, device),
            int32_tensor(graph.dst, device),
            int32_tensor(np.concatenate([pull_deg, [0]]), device),
            int32_tensor(trunc.T.reshape(-1), device),
        )
        graph.memo[key] = prep
    return prep


def _bfs_adaptive_loop(prep: BfsPrep, source: int, n: int, t_trunc: int, tiers, k_bu: int,
                       e_bu: int):
    """The JAX kernel's phases as one host loop: at every step, the step of
    phase ``chosen = max(first_fit(cnt, fe), min_tier)`` (index T is
    bottom-up, T+1 dense), as its nested while_loops run it. Returns (int32
    levels, levels done, per-phase step counts); aborted steps count."""
    (pull, deg_pad, push_indptr, push_dst, pull_deg_pad, trunc_tbl) = prep
    deg_n, pdeg_n = deg_pad[:-1], pull_deg_pad[:-1]
    T = len(tiers)
    BU, DENSE = T, T + 1
    counts = [0] * (T + 2)

    def status(levels, level):
        return mask_status(levels == level, deg_n)

    def tier_step(i, levels, level, cnt, fe):
        k, e = tiers[i]
        ids, _ = compact(levels == level, k)
        exp = expand(ids, deg_pad, push_indptr, push_dst, e, with_row_ids=False)
        unvisited = exp.valid & (table_gather(levels, exp.neigh) == INT32_INF)
        # the deduped new frontier; if it overflows the tier's rows the
        # level is aborted (levels unchanged) and escalates one tier up
        ids2, cnt2 = compact_stream(exp.neigh, unvisited, k, n)
        cnt2, fe2 = torch.stack([cnt2, frontier_deg_sum(ids2, deg_pad)]).tolist()
        if cnt2 > k:
            return levels, level, cnt, fe, i + 1
        # slot n of the [n+1] buffer takes the pad ids
        levels = torch.cat([levels, levels.new_zeros(1)]).index_fill_(
            0, ids2.long(), level + 1)[:n]
        return levels, level + 1, cnt2, fe2, 0

    def bu_step(levels, level, cnt, fe):
        # truncated bottom-up: unvisited rows whose first t_trunc
        # in-neighbours hit the frontier are claimed; rows with more
        # in-edges that the probe missed get their full lists checked
        # through the frontier engine, unless that residual overflows
        claim_trunc, resid_mask = bfs_trunc_probe(levels, level, trunc_tbl, pdeg_n, t_trunc)
        rids, rcnt = compact(resid_mask, k_bu)
        fe_r = frontier_deg_sum(rids, pull_deg_pad)
        ok = (rcnt <= k_bu) & (fe_r <= e_bu)
        exp = expand(rids, pull_deg_pad, pull.indptr, pull.src, e_bu, with_row_ids=False)
        # segment-any per residual row (K17; a residual past e_bu is
        # discarded by ok anyway)
        claimed = residual_claim(levels, level, exp, e_bu, rids, n)
        updated = torch.where(claim_trunc, level + 1, levels)
        updated = torch.cat([updated, updated.new_zeros(1)]).index_fill_(
            0, claimed.long(), level + 1)[:n]
        # selected on the device, so that one read brings ok and the status
        levels = torch.where(ok, updated, levels)
        ok, ncnt, nfe = torch.cat([ok.reshape(1).long(), status(levels, level + 1)]).tolist()
        if ok:
            return levels, level + 1, ncnt, nfe, 0
        return levels, level, cnt, fe, DENSE

    def dense_step(levels, level, cnt, fe):
        # the frontier is the set of vertices at the current level
        levels, _ = _bfs_dense_step(levels, (levels == level).to(torch.int32), level, pull)
        ncnt, nfe = status(levels, level + 1).tolist()
        return levels, level + 1, ncnt, nfe, 0

    def first_fit(cnt, fe):
        for i, (k_i, e_i) in enumerate(tiers):
            if cnt <= k_i and fe <= e_i:
                return i
        return BU

    levels = torch.full((n,), INT32_INF, dtype=torch.int32, device=deg_pad.device)
    levels[source] = 0
    cnt, fe = status(levels, 0).tolist()
    level, min_tier = 0, 0
    while cnt > 0 and level < n:
        phase = max(first_fit(cnt, fe), min_tier)
        counts[phase] += 1
        if phase < T:
            with record_function("bfs.tier_step"):
                levels, level, cnt, fe, min_tier = tier_step(phase, levels, level, cnt, fe)
        elif phase == BU:
            with record_function("bfs.bottom_up"):
                levels, level, cnt, fe, min_tier = bu_step(levels, level, cnt, fe)
        else:
            with record_function("bfs.dense"):
                levels, level, cnt, fe, min_tier = dense_step(levels, level, cnt, fe)
    return levels, level, counts


STEP_MODES = ("phases", "switch")


def _step_mode(cfg) -> None:
    """Both of the JAX package's step modes run the one host loop: each
    step is the chosen phase's, which is what the switch's body computes
    (the JAX package's own test holds the two modes equal, counters and
    all)."""
    mode = cfg.bfs_step_mode or "phases"
    if mode not in STEP_MODES:
        raise ValueError(f"unknown bfs-step-mode {mode!r}; expected {'|'.join(STEP_MODES)}")


def bfs_adaptive_run(graph: Graph, src_dense: int, cfg: Optional[PlatformConfig] = None,
                     with_stats: bool = False):
    """Direction-optimizing BFS. Returns (int32 levels on cfg.device with
    INT32_INF unreachable, iterations), and with ``with_stats`` also the
    JAX package's dict of per-phase step counts."""
    cfg = cfg or PlatformConfig()
    _step_mode(cfg)
    n = graph.n
    t_trunc = int(cfg.bfs_trunc or BFS_TRUNC)
    prep = bfs_adaptive_prep(graph, t_trunc, cfg.device)
    # ascending (rows, edges) push tiers; rows are capped on their own,
    # since only push steps size buffers by rows
    if cfg.bfs_push_tiers:
        edge_tiers = sorted({int(t) for t in str(cfg.bfs_push_tiers).split(",") if t})
    else:
        e_cap = int(cfg.bfs_frontier_edges or 1 << 22)
        edge_tiers = [t for t in (1 << 16, 1 << 18, 1 << 20) if t < e_cap] + [e_cap]
    k_cap = int(cfg.bfs_frontier_rows or 1 << 18)
    tiers = tuple((min(k_cap, e, n), e) for e in edge_tiers)
    k_bu = int(cfg.bfs_bu_rows or 1 << 15)
    e_bu = int(cfg.bfs_bu_edges or 1 << 18)
    levels, niter, c = _bfs_adaptive_loop(prep, src_dense, n, t_trunc, tiers, k_bu, e_bu)
    if with_stats:
        stats = {
            "tier_steps": {int(e): c[i] for i, (_, e) in enumerate(tiers)},
            "tiers": [(int(k), int(e)) for k, e in tiers],
            "bu_steps": c[len(tiers)],
            "dense_steps": c[len(tiers) + 1],
            "t_trunc": t_trunc,
            "k_bu": k_bu,
            "e_bu": e_bu,
        }
        return levels, niter, stats
    return levels, niter


def bfs_hybrid_run(graph: Graph, src_dense: int, cfg: Optional[PlatformConfig] = None):
    """Direction-optimizing hybrid: sparse frontiers expand on the host over
    the push CSR (out-edges, the right direction for directed graphs);
    frontiers whose out-edges exceed ``bfs_active_threshold`` of the edges
    run dense pull steps on cfg.device. Returns (int32 numpy levels with
    INT32_INF unreachable, iterations), as the JAX package's does."""
    cfg = cfg or PlatformConfig()
    n, m = graph.n, graph.nnz
    indptr_h, dst_h = graph.indptr, graph.dst
    tau = cfg.bfs_active_threshold * max(m, 1)  # 0 runs every level with an edge dense

    levels = np.full(n, INT32_INF, dtype=np.int32)
    levels[src_dense] = 0
    frontier = np.array([src_dense], dtype=np.int64)
    level = 0
    while frontier.size:
        fe = int((indptr_h[frontier + 1] - indptr_h[frontier]).sum())
        if fe <= tau:
            with record_function("bfs.host_step"):
                pos, _ = frontier_edge_positions(indptr_h, frontier)
                cand = dst_h[pos]
                cand = cand[levels[cand] == INT32_INF]
                # dedupe by a mask scatter (cheaper than np.unique's sort)
                mask = np.zeros(n, dtype=bool)
                mask[cand] = True
                frontier = np.nonzero(mask)[0]
                levels[frontier] = level + 1
            level += 1
            continue
        # dense device steps while the frontier stays heavy
        csr = pull_csr(graph, cfg.device)
        levels_d = torch.from_numpy(levels).to(cfg.device)
        f_mask = np.zeros(n, dtype=np.int32)
        f_mask[frontier] = 1
        frontier_d = torch.from_numpy(f_mask).to(cfg.device)
        while True:
            with record_function("bfs.dense"):
                levels_d, frontier_d = _bfs_dense_step(levels_d, frontier_d, level, csr)
                frontier = np.nonzero(frontier_d.cpu().numpy())[0]
            level += 1
            if frontier.size == 0:
                break
            fe = int((indptr_h[frontier + 1] - indptr_h[frontier]).sum())
            if fe <= tau:
                break
        levels = levels_d.cpu().numpy()
    return levels, level


@register("bfs")
def bfs(graph: Graph, params: AlgorithmParams, cfg: PlatformConfig) -> AlgorithmResult:
    if params.source_vertex is None:
        raise ValueError("bfs requires source-vertex")
    impl = cfg.bfs_impl
    if impl not in IMPLS:
        raise ValueError(f"unknown bfs-impl {impl!r}; expected {'|'.join(IMPLS)}")
    src_dense = graph.dense_source(params.source_vertex)
    if impl == "hybrid":
        levels, niter = bfs_hybrid_run(graph, src_dense, cfg)
    else:
        if impl in ("device", "dense"):
            levels, niter = _bfs_kernel(pull_csr(graph, cfg.device), src_dense, graph.n)
        else:
            levels, niter = bfs_adaptive_run(graph, src_dense, cfg)
        levels = levels.cpu().numpy()
    levels = levels.astype(np.int64)
    levels[levels == INT32_INF] = UNREACHABLE
    return AlgorithmResult("bfs", levels, iterations=int(niter))
