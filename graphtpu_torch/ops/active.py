"""Convergence-adaptive CDLP (counterpart of graphtpu/ops/active.py): full
slab steps while many labels change, then steps restricted to the rows
next to a changed vertex.

With synchronous updates a row's label can change at iteration t+1 only if
one of its incidence neighbours changed at t, and the incidence is
symmetric (directed graphs list both directions, LAGraph_cdlp.c:47-50), so
the next active set is the union of the changed vertices' incidence lists.
Rows outside it keep their label.

Two entry points, each with the JAX package's results:

* ``cdlp_adaptive_device_run`` (cdlp-impl auto/adaptive) routes each
  step between a full slab step and the smallest active tier whose
  (rows, edges) budget holds the next active set, on the frontier engine
  (ops/frontier.py, kernel K5). JAX runs it as one while_loop program; here
  the same phases are a host loop over device tensors with one small
  device-to-host read per step (the packed status), plus one at each
  phase boundary. The routing, and so the counts of full and active steps,
  is the JAX kernel's, step for step.
* ``cdlp_adaptive_run`` (adaptive-host, and auto under iteration timing)
  decides on the host from the changed ids, slicing the incidence with
  numpy, by the ``cdlp_active_threshold`` share of the incidence.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops.frontier import (
    compact,
    compact_stream,
    expand,
    frontier_deg_sum,
    mask_status,
)
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.minmode import (
    _iter0_minmode,
    _iter0_mode,
    cdlp_step,
    memoized_cdlp_plan,
    stream_minmode,
)
from graphtpu_torch.ops.slab import SlabPlan
from graphtpu_torch.ops.spmv import int32_tensor

# the routing's active-count sentinels, as in the JAX kernel
STAY_FULL = INT32_INF  # the changed mask exceeds the largest tier
DERIVE = -1            # the changed mask fits: derive the active set at the boundary


def _first_iteration(plan: SlabPlan, labels0: torch.Tensor, directed: bool) -> torch.Tensor:
    """Iteration 0 without a label gather: the minimum neighbour id on
    duplicate-free (undirected) incidence, the stored-id mode otherwise."""
    return _iter0_mode(plan, labels0) if directed else _iter0_minmode(plan, labels0)


def _active_step(labels, rows, centers, neigh, indptr):
    """One synchronous CDLP iteration restricted to ``rows``, every one of
    which has an incidence entry: (new labels, per-row changed flags,
    per-row winners)."""
    winners = stream_minmode(labels, centers, neigh, indptr)
    changed = winners != table_gather(labels, rows)
    new = labels.clone()
    new[rows.long()] = winners
    return new, changed, winners


def _slice_incidence(ids: np.ndarray, deg: np.ndarray, indptr: np.ndarray):
    """Concatenated incidence positions of the given center ids:
    (positions, per-id lengths, total), O(total edges of ids)."""
    lens = deg[ids]
    m = int(lens.sum())
    if m == 0:
        return np.empty(0, dtype=np.int64), lens, m
    offs = np.zeros(ids.shape[0], dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    pos = np.arange(m, dtype=np.int64) - np.repeat(offs, lens) + np.repeat(indptr[ids], lens)
    return pos, lens, m


class AdaptivePrep(NamedTuple):
    """Device state of the adaptive run, built once per graph and device."""

    plan: SlabPlan
    deg_pad: torch.Tensor     # [n+1] int32, deg_pad[n] == 0
    indptr_pad: torch.Tensor  # [n+1] int32
    neigh: torch.Tensor       # [m] int32 incidence neighbours, center-sorted


def prepare_cdlp_adaptive(graph, centers, neigh, deg, cfg) -> AdaptivePrep:
    """The slab plan and the CSR arrays on ``cfg.device``, memoized on the
    Graph by device and buckets, so a warm run copies nothing."""
    device = torch.device(cfg.device)
    buckets = tuple(cfg.slab_buckets) if cfg.slab_buckets else None
    key = ("cdlp_adaptive_prep", buckets, str(device))
    prep = graph.memo.get(key)
    if prep is None:
        deg = np.asarray(deg, dtype=np.int64)
        indptr = np.zeros(graph.n + 1, dtype=np.int64)
        np.cumsum(deg, out=indptr[1:])
        prep = AdaptivePrep(
            memoized_cdlp_plan(graph, centers, neigh, deg, buckets, device),
            int32_tensor(np.concatenate([deg, [0]]), device), int32_tensor(indptr, device),
            int32_tensor(neigh, device),
        )
        graph.memo[key] = prep
    return prep


def cdlp_tiers(k_cap: int, e_cap: int, m_inc: int, cfg=None) -> tuple:
    """Ascending (rows, edges) budgets of the active tiers. By default the
    single (cdlp-frontier-rows, cdlp-frontier-edges) tier; ``cdlp_tiers``
    (comma edge budgets) gives a ladder, budgets above m_inc/4 dropped
    (they would cost more than the full sweep they replace), with row
    budgets min(max(k, e/16), 2^18)."""
    cfg_tiers = getattr(cfg, "cdlp_tiers", "") or ""
    if cfg_tiers:
        edge_tiers = sorted({int(t) for t in str(cfg_tiers).split(",") if t})
        edge_tiers = (
            [e for e in edge_tiers if e <= max(m_inc // 4, edge_tiers[0])]
            or edge_tiers[:1]
        )
    else:
        edge_tiers = [e_cap]
    return tuple((min(max(k_cap, e // 16), 1 << 18), e) for e in edge_tiers)


def _adaptive_loop(prep: AdaptivePrep, n: int, itermax: int, directed: bool, tiers):
    """The JAX kernel's phases as a host loop. Returns (labels, iterations,
    full steps); iteration 0 counts as a full step."""
    plan, deg_pad, indptr_pad, neigh = prep
    deg_n = deg_pad[:-1]
    k_max, e_max = tiers[-1]
    full = len(tiers)

    def chosen(acnt, ae):
        """The smallest tier whose budgets hold the active set, else full."""
        for i, (k_i, e_i) in enumerate(tiers):
            if 0 <= acnt <= k_i and ae <= e_i:
                return i
        return full

    def status(labels, new):
        """Changed mask and routing of a full step, from one device read."""
        mask = new != labels
        cnt, ce = mask_status(mask, deg_n).tolist()
        return mask, DERIVE if cnt <= k_max and ce <= e_max else STAY_FULL, cnt > 0

    def derive(mask):
        """Active set = union of the changed vertices' incidence lists, at
        the largest tier's sizes; the mask is known to fit them."""
        ids, _ = compact(mask, k_max)
        exp = expand(ids, deg_pad, indptr_pad, neigh, e_max, with_row_ids=False)
        nxt_ids, nxt_cnt = compact_stream(exp.neigh, exp.valid, k_max, n)
        cnt, ne = torch.stack([nxt_cnt, frontier_deg_sum(nxt_ids, deg_pad)]).tolist()
        return nxt_ids, cnt, ne

    def tier_step(labels, ids, k_i, e_i):
        ids_i = ids[:k_i]  # ascending, pad = n
        exp = expand(ids_i, deg_pad, indptr_pad, neigh, e_i, with_row_ids=False)
        # the pad slots lie past seg_starts[k_i] and join no segment (the JAX
        # kernel gives them a segment k_i of their own and drops its result)
        centers = torch.where(exp.valid, exp.rows_local, k_i)
        winners = stream_minmode(labels, centers, exp.neigh, exp.seg_starts)
        valid_row = ids_i < n
        old = table_gather(labels, torch.where(valid_row, ids_i, 0))
        changed_row = valid_row & (winners != old)
        # slot n of the [n+1] buffer takes the writes of unchanged and pad rows
        new = torch.cat([labels, labels.new_zeros(1)])
        new.index_copy_(0, torch.where(changed_row, ids_i, n).long(),
                        torch.where(changed_row, winners, 0))
        # next active set: the neighbours of the rows that changed, from
        # this step's own expansion
        ch_edge = exp.valid & (table_gather(changed_row.to(torch.int32), exp.rows_local) == 1)
        nxt_ids, nxt_cnt = compact_stream(exp.neigh, ch_edge, k_max, n)
        cnt, ne, ch = torch.stack([
            nxt_cnt, frontier_deg_sum(nxt_ids, deg_pad), changed_row.any().to(torch.int32)
        ]).tolist()
        return new[:n], nxt_ids, cnt, ne, bool(ch)

    # each step kind runs in a named profiler range, so a trace splits the
    # wall time (host included) between them
    labels = torch.arange(n, dtype=torch.int32, device=deg_pad.device)
    if itermax < 1:
        return labels, 0, 0
    with record_function("cdlp.full_step"):
        new = _first_iteration(plan, labels, directed)
        mask, acnt, ch = status(labels, new)
    labels, ids, ae, it, nf = new, None, 0, 1, 1
    while ch and it < itermax:
        while ch and it < itermax and acnt == STAY_FULL:
            with record_function("cdlp.full_step"):
                new = cdlp_step(labels, plan)
                mask, acnt, ch = status(labels, new)
            labels, it, nf = new, it + 1, nf + 1
        if not (ch and it < itermax):
            break
        if acnt == DERIVE:  # a full step asked for its active set
            with record_function("cdlp.derive"):
                ids, acnt, ae = derive(mask)
        if chosen(acnt, ae) == full:  # the exact set exceeds every tier
            acnt = STAY_FULL
        for i, (k_i, e_i) in enumerate(tiers):
            while ch and it < itermax and chosen(acnt, ae) == i:
                with record_function("cdlp.tier_step"):
                    labels, ids, acnt, ae, ch = tier_step(labels, ids, k_i, e_i)
                it += 1
    return labels, it, nf


def cdlp_adaptive_device_run(graph, centers, neigh, deg, itermax, cfg,
                             prep: AdaptivePrep | None = None, with_stats: bool = False):
    """CDLP with frontier-tier active steps. Returns (labels on cfg.device,
    iterations), and with ``with_stats`` also a dict of full_steps,
    active_steps, e_cap and k_cap."""
    if prep is None:
        prep = prepare_cdlp_adaptive(graph, centers, neigh, deg, cfg)
    k_cap = int(cfg.cdlp_frontier_rows or 1 << 16)
    e_cap = int(cfg.cdlp_frontier_edges or 1 << 18)
    tiers = cdlp_tiers(k_cap, e_cap, int(np.asarray(deg).sum()), cfg)
    labels, it, nf = _adaptive_loop(prep, graph.n, int(itermax), graph.directed, tiers)
    if with_stats:
        stats = {"full_steps": nf, "active_steps": it - nf, "e_cap": e_cap, "k_cap": k_cap}
        return labels, it, stats
    return labels, it


def cdlp_adaptive_run(graph, centers, neigh, deg, itermax, cfg):
    """Host-stepped adaptive CDLP: full steps until the rows next to the
    changed vertices hold at most ``cdlp_active_threshold`` of the
    incidence, then steps on those rows, sliced on the host. Returns
    (labels on cfg.device, iterations), as the slab run does."""
    from graphtpu_torch.utils.timers import IterationTimer

    n, itermax = graph.n, int(itermax)
    device = torch.device(cfg.device)
    deg = np.asarray(deg, dtype=np.int64)
    neigh = np.asarray(neigh)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    buckets = tuple(cfg.slab_buckets) if cfg.slab_buckets else None
    plan = memoized_cdlp_plan(graph, centers, neigh, deg, buckets, device)
    thresh_edges = cfg.cdlp_active_threshold * max(int(np.asarray(centers).shape[0]), 1)
    timer = IterationTimer() if cfg.iteration_timing else None
    to = lambda a: int32_tensor(a, device)  # noqa: E731

    labels = torch.arange(n, dtype=torch.int32, device=device)
    prev = np.arange(n, dtype=np.int32)
    act_rows = None  # rows of the next iteration; None = a full step
    it = 0
    for i in range(itermax):
        if timer:
            timer.start()
        if act_rows is None:
            labels = (_first_iteration(plan, labels, graph.directed) if i == 0
                      else cdlp_step(labels, plan))
            cur = labels.to("cpu", copy=True).numpy()
            changed_ids = np.nonzero(cur != prev)[0]
            prev = cur
        else:
            pos, lens, _ = _slice_incidence(act_rows, deg, indptr)
            seg = np.zeros(act_rows.shape[0] + 1, dtype=np.int64)
            np.cumsum(lens, out=seg[1:])
            centers_a = np.repeat(np.arange(act_rows.shape[0]), lens)
            labels, flags, winners = _active_step(
                labels, to(act_rows), to(centers_a), to(neigh[pos]), to(seg)
            )
            flags = flags.cpu().numpy()
            changed_ids = act_rows[flags]
            prev[changed_ids] = winners.cpu().numpy()[flags]
        it = i + 1
        if timer:
            timer.stop(f"cdlp iteration {i}", labels)
        if changed_ids.size == 0 or it == itermax:
            break
        # next active set = union of the changed vertices' incidence lists,
        # sliced only when its cheap upper bound is under the threshold
        act_rows = None
        if int(deg[changed_ids].sum()) <= thresh_edges:
            cpos, _, _ = _slice_incidence(changed_ids, deg, indptr)
            mark = np.zeros(n, dtype=bool)
            mark[neigh[cpos]] = True
            nxt = np.nonzero(mark)[0]
            if nxt.size and int(deg[nxt].sum()) <= thresh_edges:
                act_rows = nxt
    return labels, it
