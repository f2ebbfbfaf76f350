"""Distributed direction-optimizing BFS (counterpart of
graphtpu/parallel/adaptive_bfs.py), the JAX package's default distributed
BFS: the one-device three-phase kernel (algorithms/bfs.py) with each rank
working on its own rows.

* push, for small frontiers: each rank compacts the frontier rows it owns,
  expands them through its local push CSR (kernel K5) and marks the
  unvisited targets in an int32 claim mask over [n_pad]; one all-reduce
  sums the masks (a vertex claimed from several ranks counts more than
  once, so a claim is a count >= 1);
* truncated bottom-up, for heavy levels: each rank probes the first
  ``t_trunc`` in-neighbours of its unvisited rows against the replicated
  levels (kernel K13, ``bfs_trunc_probe``), checks the rows the probe
  missed through its local pull CSR (K5, then K17 ``bfs_residual_claim``
  over the rows' slots), and one all-gather replicates
  the new levels; an all-reduced count of the ranks whose residual fits
  aborts the level everywhere when one does not;
* dense pull, the fallback: K7 ``max_i32`` over the rank's pull block,
  then an all-gather.

Levels are replicated. JAX runs the phases as nested while_loops in one
program; here they are one host loop that runs, at every step, the phase
``max(first_fit(cnt, fe), min_tier)`` (index T is bottom-up, T + 1 dense),
which is what the nested loops run. Every branch reads only replicated
values (the frontier's count and edge sum, the all-reduced ``ok``), one
host read a step, so all ranks take the same branches and meet in the same
collectives. The push budgets are per rank, smaller than the one-device
ladder: each rank expands only its own rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphtpu_torch.algorithms.bfs import BFS_TRUNC
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops.frontier import (
    bfs_trunc_probe, compact, expand, frontier_deg_sum, mask_status, residual_claim,
)
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.parallel.algorithms import _spmv_block
from graphtpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_sum
from graphtpu_torch.parallel.partition import EDGE_ALIGN, _round_up


def _local_csr(indptr: np.ndarray, streams, n_pad: int, r: int, d: int):
    """Each rank's slice of a CSR padded to ``n_pad`` rows, rank k taking
    rows [k * r, (k + 1) * r): ([D, r + 1] indptr, [D, r + 1] degrees with a
    0 at r, and one [D, M] block per edge stream in ``streams``)."""
    ip = np.zeros(n_pad + 1, dtype=np.int64)
    ip[:indptr.shape[0]] = indptr
    ip[indptr.shape[0]:] = indptr[-1]
    deg = np.diff(ip)
    m_dev = max(_round_up(int(max(ip[(k + 1) * r] - ip[k * r] for k in range(d))), EDGE_ALIGN),
                EDGE_ALIGN)
    l_ip = np.zeros((d, r + 1), dtype=np.int32)
    l_deg = np.zeros((d, r + 1), dtype=np.int32)
    l_streams = [np.zeros((d, m_dev), dtype=s.dtype) for s in streams]
    for k in range(d):
        lo, hi = k * r, (k + 1) * r
        l_ip[k] = (ip[lo:hi + 1] - ip[lo]).astype(np.int32)
        l_deg[k, :r] = deg[lo:hi].astype(np.int32)
        for s, out in zip(streams, l_streams):
            seg = s[ip[lo]:ip[hi]]
            out[k, :seg.shape[0]] = seg
    return (l_ip, l_deg, *l_streams)


class BfsDistPrep(NamedTuple):
    """The host arrays of the adaptive kernel, every rank's part."""

    push: tuple           # ([D, r+1] indptr, [D, r+1] out-degrees, [D, M] dst)
    pull: tuple           # ([D, r+1] indptr, [D, r+1] in-degrees, [D, M'] src)
    trunc: np.ndarray     # [D, t * r]: row's t-th smallest in-neighbour at t * r + row
    gdeg_pad: np.ndarray  # [n_pad + 1] out-degrees, 0 past n, replicated


def _build_prep(sg, t_trunc: int = BFS_TRUNC) -> BfsDistPrep:
    """The adaptive kernel's host arrays, memoized on the ShardedGraph per
    probe depth."""
    cached = getattr(sg, "_bfs_adaptive_prep", None)
    if cached is not None and cached[0] == t_trunc:
        return cached[1]
    g = sg.graph
    n, n_pad, r, d = g.n, sg.n_pad, sg.rows_per_dev, sg.num_devices
    push = _local_csr(g.indptr.astype(np.int64), [g.dst.astype(np.int32)], n_pad, r, d)
    psrc = g.pull_arrays()[0]
    pull = _local_csr(g.pull_indptr.astype(np.int64), [psrc.astype(np.int32)], n_pad, r, d)
    # trunc[k, t * r + row] = the row's t-th smallest in-neighbour (global
    # id), n_pad past its degree (the frontier mask is padded at n_pad)
    pdeg = np.diff(g.pull_indptr).astype(np.int64)
    offs = np.arange(t_trunc, dtype=np.int64)
    pos = g.pull_indptr[:-1, None] + offs[None, :]
    valid = offs[None, :] < pdeg[:, None]
    trunc = np.full((n_pad, t_trunc), n_pad, dtype=np.int32)
    trunc[:n][valid] = psrc[np.minimum(pos, max(len(psrc) - 1, 0))[valid]]
    trunc_d = np.ascontiguousarray(
        trunc.reshape(d, r, t_trunc).transpose(0, 2, 1).reshape(d, t_trunc * r))
    out_deg = np.zeros(n_pad + 1, dtype=np.int32)
    out_deg[:n] = np.diff(g.indptr).astype(np.int32)
    prep = BfsDistPrep(push, pull, trunc_d, out_deg)
    sg._bfs_adaptive_prep = (t_trunc, prep)
    return prep


def _bfs_body(mesh: Mesh, key, coo_key, source: int, n: int, r: int, t_trunc: int,
              tiers: tuple, k_bu: int, e_bu: int, with_counts: bool):
    dev = mesh.device
    ((pi, pdeg, pdst), (qi, qdeg, qsrc), trunc), gdeg_pad = mesh.state[key]
    shard = mesh.state[coo_key]
    n_pad = gdeg_pad.shape[0] - 1
    gdeg_n = gdeg_pad[:-1]
    my = mesh.rank * r
    T = len(tiers)
    BU, DENSE = T, T + 1
    counts = [0] * (T + 2)

    def status(levels, level):
        return mask_status(levels == level, gdeg_n)

    def push_step(i, levels, level):
        k_cap, e_cap = tiers[i]
        ids_l, _ = compact(levels[my:my + r] == level, k_cap)
        exp = expand(ids_l, pdeg, pi, pdst, e_cap, with_row_ids=False)
        unvis = table_gather(levels, exp.neigh) == INT32_INF
        idx = torch.where(exp.valid & unvis, exp.neigh, n_pad).long()
        claims = torch.zeros(n_pad + 1, dtype=torch.int32, device=dev).index_fill_(0, idx, 1)
        # the ranks' masks are summed: a claim is a count >= 1
        claims = all_reduce_sum(claims[:n_pad])
        levels = torch.where((claims >= 1) & (levels == INT32_INF), level + 1, levels)
        return levels, status(levels, level + 1).tolist()

    def bu_step(levels, level):
        claim_trunc, resid = bfs_trunc_probe(levels, level, trunc, qdeg[:r], t_trunc, my)
        lv_local = levels[my:my + r]
        rids, rcnt = compact(resid, k_bu)
        fe_r = frontier_deg_sum(rids, qdeg)
        ok_l = (rcnt <= k_bu) & (fe_r <= e_bu)
        # the level applies only where every rank's residual fits
        ok = all_reduce_sum(ok_l.to(torch.int32).reshape(1))[0] == mesh.size
        exp = expand(rids, qdeg, qi, qsrc, e_bu, with_row_ids=False)
        # segment-any per residual row (K17; a residual past e_bu is
        # discarded by ok anyway)
        claimed = residual_claim(levels, level, exp, e_bu, rids, r)
        updated = torch.where(claim_trunc, level + 1, lv_local)
        updated = torch.cat([updated, updated.new_zeros(1)]).index_fill_(
            0, claimed.long(), level + 1)[:r]
        new_levels = all_gather_rows(torch.where(ok, updated, lv_local))
        levels = torch.where(ok, new_levels, levels)
        ok, ncnt, nfe = torch.cat([ok.reshape(1).long(), status(levels, level + 1)]).tolist()
        return levels, bool(ok), ncnt, nfe

    def dense_step(levels, level):
        reached = _spmv_block("max_i32", shard, (levels == level).to(torch.int32))
        # K7's max of an empty row is 0: "== 1" keeps it unreached
        levels = torch.where((reached == 1) & (levels == INT32_INF), level + 1, levels)
        return levels, status(levels, level + 1).tolist()

    def first_fit(cnt, fe):
        for i, (k_i, e_i) in enumerate(tiers):
            if cnt <= k_i and fe <= e_i:
                return i
        return BU

    levels = torch.full((n_pad,), INT32_INF, dtype=torch.int32, device=dev)
    levels[source] = 0
    cnt, fe = status(levels, 0).tolist()
    level, min_tier = 0, 0
    while cnt > 0 and level < n:
        phase = max(first_fit(cnt, fe), min_tier)
        counts[phase] += 1
        if phase < T:
            levels, (cnt, fe) = push_step(phase, levels, level)
            level, min_tier = level + 1, 0
        elif phase == BU:
            levels, ok, ncnt, nfe = bu_step(levels, level)
            if ok:
                cnt, fe, level, min_tier = ncnt, nfe, level + 1, 0
            else:
                min_tier = DENSE
        else:
            levels, (cnt, fe) = dense_step(levels, level)
            level, min_tier = level + 1, 0
    out = (levels[:n].cpu().numpy(), level)
    return out + (counts,) if with_counts else out


def bfs_tiers(sg, cfg=None):
    """The per-rank budgets: ((rows, edges) push tiers, k_bu, e_bu), as the
    JAX package's ``bfs_adaptive_dist`` sets them."""
    tiers_cfg = getattr(cfg, "bfs_push_tiers", "") or ""
    if tiers_cfg:
        edge_tiers = sorted({int(t) for t in str(tiers_cfg).split(",") if t})
    else:
        e_cap = int(getattr(cfg, "bfs_frontier_edges", 0) or 1 << 18)
        edge_tiers = [t for t in (1 << 14, 1 << 16) if t < e_cap] + [e_cap]
    k_cap = int(getattr(cfg, "bfs_frontier_rows", 0) or 1 << 16)
    tiers = tuple((min(k_cap, e, sg.rows_per_dev), e) for e in edge_tiers)
    k_bu = int(getattr(cfg, "bfs_bu_rows", 0) or 1 << 15)
    e_bu = int(getattr(cfg, "bfs_bu_edges", 0) or 1 << 18)
    return tiers, k_bu, e_bu


def bfs_adaptive_dist(sg, source_dense: int, cfg=None, with_stats: bool = False):
    """Distributed adaptive BFS on a ShardedGraph: (int32 levels [n] with
    INT32_INF unreachable, levels run), and with ``with_stats`` the per-phase
    step counts (tier steps by edge budget, bottom-up steps, aborted ones
    included, and dense steps)."""
    t_trunc = int(getattr(cfg, "bfs_trunc", 0) or BFS_TRUNC)
    prep = _build_prep(sg, t_trunc)
    key = sg.installed_parts(f"bfs-adaptive-{t_trunc}", prep[:3], prep[3:])
    coo_key = sg.pull()
    tiers, k_bu, e_bu = bfs_tiers(sg, cfg)
    args = (key, coo_key, int(source_dense), sg.n, sg.rows_per_dev, t_trunc, tiers, k_bu, e_bu,
            with_stats)
    out = sg.mesh.call(_bfs_body, [args] * sg.num_devices)
    if not with_stats:
        return out
    levels, it, c = out
    T = len(tiers)
    return levels, it, {
        "tier_steps": {int(e): c[i] for i, (_, e) in enumerate(tiers)},
        "tiers": [(int(k), int(e)) for k, e in tiers],
        "bu_steps": c[T], "dense_steps": c[T + 1], "t_trunc": t_trunc, "k_bu": k_bu,
        "e_bu": e_bu,
    }
