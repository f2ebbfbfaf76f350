"""Weakly connected components (counterpart of graphtpu/algorithms/wcc.py):
min-label propagation on the symmetrized structure.

Semantics of the reference (wcc.cpp:53-63): directed graphs are
symmetrized (A | A^T) first; the output is one representative per vertex,
the original id of the component's smallest dense id (the validator
matches the partition).

Labels start as the vertex ids. A full step takes each vertex's minimum
over its neighbours' labels and its own, then jumps pointers twice
(labels = min(labels, labels[labels])). ``wcc_impl``:

* "auto" / "slab": full steps on the slab pull plan (kernel K6 per bucket,
  K7 for the heavy rows) with a gather-free iteration 0 (K6's identity
  mode), then active-set steps on the frontier engine once the changed
  rows fit its capacities (``_wcc_adaptive_loop``);
* "adaptive": the same, with full steps on the edge stream (kernel K7);
* "device": full steps on K7 only, to the fixed point.

The adaptive phases, one while_loop program in JAX, are a host loop here
with one small device-to-host read per step; the counts of full and active
steps are the JAX kernel's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from graphtpu_torch.algorithms.common import AlgorithmResult, register
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.semiring import MIN_SECOND
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops.frontier import (
    compact,
    compact_stream,
    expand,
    frontier_deg_sum,
    mask_status,
)
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.slab import SlabPlan, assemble, result_buffer
from graphtpu_torch.ops.spmv import (
    PullCSR, build_pull_plan, csr_pull_reduce, int32_tensor, pull_csr, slab_spmv,
    slab_spmv_min_buckets,
)
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
from graphtpu_torch.utils.roofline import plan_gather_count

# "dense" is the JAX package's name of the dense kernel on one device:
# it runs as "device"
IMPLS = ("auto", "slab", "adaptive", "device", "dense")


def _finish(labels: torch.Tensor, neigh_min: torch.Tensor):
    """min with the neighbours' minimum, then two pointer jumps: (new
    labels, changed mask)."""
    new = torch.minimum(labels, neigh_min)
    new = torch.minimum(new, table_gather(new, new))
    new = torch.minimum(new, table_gather(new, new))
    return new, new != labels


def _wcc_kernel(csr: PullCSR, n: int):
    """Full edge-stream steps (K7) to the fixed point: (labels, steps)."""
    labels = torch.arange(n, dtype=torch.int32, device=csr.src.device)
    changed, it = True, 0
    while changed and it < n:
        with record_function("wcc.full_step"):
            neigh_min = csr_pull_reduce("min_i32", labels, csr.src, csr.indptr)
            labels, mask = _finish(labels, neigh_min)
            changed = bool(mask.any())
        it += 1
    return labels, it


class WccPrep(NamedTuple):
    """The symmetrized graph's pull CSR and in-degrees on one device."""

    pull: PullCSR
    deg_pad: torch.Tensor  # [n+1] int32, 0 at n


def _wcc_adaptive_loop(full_step, iter0_step, prep: WccPrep, n: int, k_cap: int, e_cap: int):
    """The JAX kernel's phases as a host loop: full steps while the changed
    rows overflow (k_cap, e_cap); then the active set (the changed rows'
    neighbours) is derived and, while it fits, active steps of pure
    min-propagation follow. ``full_step(labels)`` and ``iter0_step()``
    return (new labels, changed mask). Returns (labels, iterations, full
    steps); iteration 0 counts as a full step."""
    (pull, deg_pad) = prep
    indptr, edges_src = pull.indptr, pull.src
    deg_n = deg_pad[:-1]

    def gated(new, mask):
        cnt, ce = mask_status(mask, deg_n).tolist()
        return new, mask, cnt <= k_cap and ce <= e_cap, cnt > 0

    def derive(mask):
        ids, _ = compact(mask, k_cap)
        exp = expand(ids, deg_pad, indptr, edges_src, e_cap, with_row_ids=False)
        nxt_ids, nxt_cnt = compact_stream(exp.neigh, exp.valid, k_cap, n)
        cnt, ne = torch.stack([nxt_cnt, frontier_deg_sum(nxt_ids, deg_pad)]).tolist()
        return nxt_ids, cnt <= k_cap and ne <= e_cap

    def active_step(labels, act_ids):
        exp = expand(act_ids, deg_pad, indptr, edges_src, e_cap, with_row_ids=False)
        # each active row's minimum neighbour label on K7; the valid slots are
        # exactly those before seg_starts[k_cap] (the active set's edges fit
        # e_cap here), so segment k_cap holds every pad slot (neighbour 0,
        # inside the labels) and is dropped
        indptr_ext = torch.cat([exp.seg_starts, exp.seg_starts.new_full((1,), e_cap)])
        mins = csr_pull_reduce("min_i32", labels, exp.neigh, indptr_ext)[:k_cap]
        valid_row = act_ids < n
        old = table_gather(labels, torch.where(valid_row, act_ids, 0))
        winners = torch.minimum(old, mins)
        changed_row = valid_row & (winners < old)
        # slot n of the [n+1] buffer takes the writes of unchanged and pad rows
        new = torch.cat([labels, labels.new_zeros(1)])
        new.index_copy_(0, torch.where(changed_row, act_ids, n).long(),
                        torch.where(changed_row, winners, 0))
        # a label changes only through an edge: the next active set is the
        # changed rows' neighbours, from this step's own expansion
        ch_edge = exp.valid & (table_gather(changed_row.to(torch.int32), exp.rows_local) == 1)
        nxt_ids, nxt_cnt = compact_stream(exp.neigh, ch_edge, k_cap, n)
        cnt, ne, ch = torch.stack([
            nxt_cnt, frontier_deg_sum(nxt_ids, deg_pad), changed_row.any().to(torch.int32)
        ]).tolist()
        return new[:n], nxt_ids, cnt <= k_cap and ne <= e_cap, bool(ch)

    with record_function("wcc.full_step"):
        labels, mask, ok, changed = gated(*iter0_step())
    it, nf = 1, 1
    while changed and it < n:
        while changed and it < n and not ok:
            with record_function("wcc.full_step"):
                labels, mask, ok, changed = gated(*full_step(labels))
            it, nf = it + 1, nf + 1
        if not (changed and it < n):
            break
        with record_function("wcc.derive"):
            ids, ok = derive(mask)
        while changed and it < n and ok:
            with record_function("wcc.active_step"):
                labels, ids, ok, changed = active_step(labels, ids)
            it += 1
    return labels, it, nf


def _wcc_edge_steps(prep: WccPrep, n: int):
    """(full_step, iter0_step) of the edge-stream kernel, on K7; iteration
    0 reads the stored ids, which are the identity labels."""
    pull = prep.pull

    def full_step(labels):
        return _finish(labels, csr_pull_reduce("min_i32", labels, pull.src, pull.indptr))

    def iter0_step():
        labels0 = torch.arange(n, dtype=torch.int32, device=pull.src.device)
        return _finish(labels0, csr_pull_reduce("min_i32", None, pull.src, pull.indptr))

    return full_step, iter0_step


def _wcc_slab_steps(plan: SlabPlan, n: int):
    """(full_step, iter0_step) on the slab plan: K6 per bucket and K7 for
    the heavy rows; iteration 0 takes the minimum stored id (K6 identity
    mode, K7 on the stored ids)."""

    def full_step(labels):
        return _finish(labels, slab_spmv(MIN_SECOND, plan, labels, n))

    def iter0_step():
        labels0 = torch.arange(n, dtype=torch.int32, device=plan.inv_perm.device)
        buf = result_buffer(plan, torch.int32)
        slab_spmv_min_buckets(plan, None, n, buf)
        heavy = None
        if plan.heavy_rows is not None:
            heavy = csr_pull_reduce("min_i32", None, plan.heavy_neigh, plan.heavy_indptr)
        rest = None
        if plan.rest_rows is not None:
            rest = torch.full((plan.rest_rows.shape[0],), INT32_INF, dtype=torch.int32,
                              device=labels0.device)
        return _finish(labels0, assemble(plan, buf, heavy, rest))

    return full_step, iter0_step


def wcc_prep(sym: Graph, device) -> WccPrep:
    """The symmetrized graph's arrays on ``device``, memoized on it."""
    key = ("wcc_prep", str(torch.device(device)))
    prep = sym.memo.get(key)
    if prep is None:
        prep = WccPrep(pull_csr(sym, device),
                       int32_tensor(np.concatenate([sym.in_degree, [0]]), device))
        sym.memo[key] = prep
    return prep


def wcc_slab_plan(sym: Graph, device) -> SlabPlan:
    """The slab pull plan of the symmetrized graph, without values,
    memoized on it."""
    key = ("wcc_slab_plan", str(torch.device(device)))
    plan = sym.memo.get(key)
    if plan is None:
        plan = build_pull_plan(sym, device=device, with_values=False)
        sym.memo[key] = plan
    return plan


def wcc_adaptive_run(graph: Graph, cfg: PlatformConfig, with_stats: bool = False):
    """Adaptive WCC (impl auto, slab or adaptive). Returns (labels on
    cfg.device, iterations), and with ``with_stats`` also the JAX package's
    dict of full_steps, active_steps, e_cap, k_cap and plan_gathers (None on
    the edge-stream impl)."""
    sym = graph.symmetrized()
    prep = wcc_prep(sym, cfg.device)
    k_cap = int(cfg.wcc_frontier_rows or 1 << 16)
    e_cap = int(cfg.wcc_frontier_edges or 1 << 18)
    plan_gathers = None
    if cfg.wcc_impl in ("auto", "slab"):
        plan = wcc_slab_plan(sym, cfg.device)
        steps = _wcc_slab_steps(plan, sym.n)
        plan_gathers = plan_gather_count(plan)
    else:
        steps = _wcc_edge_steps(prep, sym.n)
    labels, niter, nfull = _wcc_adaptive_loop(*steps, prep, sym.n, k_cap, e_cap)
    if with_stats:
        stats = {"full_steps": nfull, "active_steps": niter - nfull, "e_cap": e_cap,
                 "k_cap": k_cap, "plan_gathers": plan_gathers}
        return labels, niter, stats
    return labels, niter


@register("wcc")
def wcc(graph: Graph, params: AlgorithmParams, cfg: PlatformConfig) -> AlgorithmResult:
    if cfg.wcc_impl not in IMPLS:
        raise ValueError(f"unknown wcc-impl {cfg.wcc_impl!r}; expected {'|'.join(IMPLS)}")
    if cfg.wcc_impl in ("device", "dense"):
        sym = graph.symmetrized()
        labels, niter = _wcc_kernel(pull_csr(sym, cfg.device), sym.n)
    else:
        labels, niter = wcc_adaptive_run(graph, cfg)
    comp = graph.mapping[labels.cpu().numpy()]
    return AlgorithmResult("wcc", comp, iterations=int(niter))
