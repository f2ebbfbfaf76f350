"""Breadth-first search (counterpart of graphtpu/algorithms/bfs.py).

Semantics of LAGr_BreadthFirstSearch as the reference uses it
(bfs.cpp:76-80): levels from the source over out-edges (directed) or all
edges (undirected); unreachable vertices serialize as int64 max
(bfs.cpp:47-64).

``bfs_impl``:

* "auto" / "adaptive": direction-optimizing BFS (``bfs_adaptive_run``).
  Each level runs the smallest push tier whose (rows, edges) budget holds
  its frontier, on the frontier engine (ops/frontier.py: the frontier
  compacted by K14's level mode, expanded by K18 and K5, its unvisited
  neighbours deduped by K14's unvisited mode); frontiers above the top tier
  run a truncated bottom-up (its probe of the first in-neighbours on kernel
  K13, ``bfs_trunc_probe``, the residual rows compacted by K14 and tested
  on K17, ``bfs_residual_claim``); a bottom-up whose residual overflows its
  budgets, and only then, a dense pull step (K7 max_i32). Every step ends
  with K23 (``bfs_apply``), which updates the levels, counts the new
  frontier and its out-degrees and routes the next step (the JAX kernel's
  ``applied``/``ok``, status, ``chosen``, conditions and counters). JAX runs
  the phases as nested while_loops in one program (``bfs-step-mode=phases``)
  or as one while_loop over a switch of the step bodies (``switch``); here
  both run the phases' nest (``loop_nest``), whose state lives in
  preallocated buffers and a control vector, and whose steps are
  hand-kernel launches that read nothing back (the level the kernels test
  against is read on the card): on a card one CUDA graph with while nodes
  (ops/device_loop.py) and one read of the control words after it, on the
  CPU and inside ``kernels.plain_torch()`` the host loop of the same nest.
  The step sequence, and so every phase counter, is the JAX kernel's under
  either mode.
* "device": dense pull steps only (``_bfs_kernel``), each one K7 launch over
  every edge and K23, as a second nest of the same dense step
  (``DENSE_NEST``): one CUDA graph on a card.
* "hybrid": levels whose frontier's out-edges are at most
  ``bfs_active_threshold`` of the edges expand on the host over the push
  CSR (numpy); heavier levels run dense pull steps on K7 until the
  frontier is light again (``bfs_hybrid_run``).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from graphtpu_torch.algorithms.common import AlgorithmResult, register
from graphtpu_torch.core.graph import Graph, frontier_edge_positions
from graphtpu_torch.core.types import INT32_INF, UNREACHABLE
from graphtpu_torch.ops import device_loop, kernels
from graphtpu_torch.ops.frontier import (
    bfs_trunc_probe,
    compact_into,
    compact_level_into,
    compact_unvisited_into,
    expand,
    mask_status,
    residual_claim,
)
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


# The control words of the device loops (int32, csrc/bfs_loop.cu BCTL_*): the
# frontier's count and out-degree sum (cnt, fe), the level, min_tier (the
# lowest phase a level may take after an abort) and the levels' limit (n);
# from BCTL_COND the conditions (outer, one a tier, bottom-up, dense), then the
# steps run by phase (one a tier, bottom-up, dense), aborted steps included.
BCTL_CNT, BCTL_FE, BCTL_LEVEL, BCTL_MINTIER, BCTL_LEVELMAX, BCTL_COND = range(6)
# K23's stages: the source's init, after a bottom-up step, after a dense
# step, after a step of tier i (STAGE_TIER + i)
STAGE_INIT, STAGE_BU, STAGE_DENSE, STAGE_TIER = range(4)
# bfs-impl=device's nest: init, then dense steps while the frontier is live
DENSE_NEST = ("init", ("while", 0, ("dense",)))
RANGES = {"bu": "bfs.bottom_up", "dense": "bfs.dense"}  # the steps' profiler ranges


def ctl_words(t: int) -> int:
    """Words of ``ctl`` for t tiers."""
    return BCTL_COND + (t + 3) + (t + 2)


def loop_nest(t: int) -> tuple:
    """The JAX kernel's phases (its ``phases`` mode) over the steps of
    ``_steps`` (t tiers), conditions indexed from BCTL_COND: init, then WHILE
    outer { WHILE tier 0 {tier0}; ...; WHILE bottom-up {bu}; WHILE dense
    {dense} }."""
    return ("init", ("while", 0, (*(("while", 1 + i, (f"tier{i}",)) for i in range(t)),
                                  ("while", t + 1, ("bu",)), ("while", t + 2, ("dense",)))))


def loop_runs(ctl: list, t: int) -> dict:
    """Each step's executions in a run, from the run's control words."""
    counts = ctl[BCTL_COND + t + 3:]
    return {"init": 1, "bu": counts[t], "dense": counts[t + 1],
            **{f"tier{i}": counts[i] for i in range(t)}}


def bfs_apply_plain(levels, fmask, ctl, tiers, stage: int, itermax: int, reached=None,
                    claim=None, ids=None, stat=None, deg_pad=None, source=None, k_bu: int = 0,
                    e_bu: int = 0) -> None:
    """K23's plain PyTorch version, the JAX kernels' formulation: the
    stage's levels (the source's; a tier step's scatter under ``applied``;
    the bottom-up's claims and scatter under ``ok``; the dense step's where),
    ``mask_status`` of the new frontier, then ``chosen``, the phase loops'
    conditions and counters."""
    n, t, dev = levels.shape[0], tiers.shape[0], levels.device
    cond, counts = ctl[BCTL_COND:BCTL_COND + t + 3], ctl[BCTL_COND + t + 3:]
    level = ctl[BCTL_LEVEL].clone()
    nxt = level + 1

    def status(lv):
        mask = levels == lv
        if deg_pad is None:
            return mask.sum(), torch.zeros((), dtype=torch.int64, device=dev)
        return tuple(mask_status(mask, deg_pad[:n]))

    def scatter(base, at):  # base.at[at].set(level + 1, mode="drop"), pad ids n
        return torch.cat([base, base.new_zeros(1)]).index_fill_(0, at.long(), nxt)[:n]

    if stage == STAGE_INIT:
        src = source.to(dev).long()
        levels.fill_(INT32_INF).index_fill_(0, src, 0)
        fmask.zero_().index_fill_(0, src, 1)
        cnt, fe = status(0)
        ctl[BCTL_LEVEL], ctl[BCTL_MINTIER], ctl[BCTL_LEVELMAX] = 0, 0, itermax
        counts.zero_()
    elif stage >= STAGE_TIER:
        i = stage - STAGE_TIER
        applied = stat[0] <= ids.shape[0]
        levels.copy_(torch.where(applied, scatter(levels, ids), levels))
        cnt = torch.where(applied, stat[0], ctl[BCTL_CNT])
        fe = torch.where(applied, stat[1], ctl[BCTL_FE])
        ctl[BCTL_MINTIER] = torch.where(applied, 0, i + 1)
        ctl[BCTL_LEVEL] = level + applied.to(torch.int32)
        counts[i] += 1
    elif stage == STAGE_BU:
        ok = (stat[0] <= k_bu) & (stat[1] <= e_bu)
        fmask.copy_(torch.where(ok, fmask, (levels == level).to(torch.int32)))
        levels.copy_(torch.where(ok, scatter(torch.where(claim, nxt, levels), ids), levels))
        ncnt, nfe = status(nxt)
        cnt = torch.where(ok, ncnt, ctl[BCTL_CNT])
        fe = torch.where(ok, nfe, ctl[BCTL_FE])
        ctl[BCTL_MINTIER] = torch.where(ok, 0, t + 1)
        ctl[BCTL_LEVEL] = level + ok.to(torch.int32)
        counts[t] += 1
    else:
        new_frontier = torch.where(levels == INT32_INF, reached, 0)
        levels.copy_(torch.where(new_frontier == 1, nxt, levels))
        fmask.copy_((new_frontier == 1).to(torch.int32))
        cnt, fe = status(nxt)
        ctl[BCTL_MINTIER], ctl[BCTL_LEVEL] = 0, nxt
        counts[t + 1] += 1
    ctl[BCTL_CNT], ctl[BCTL_FE] = cnt, fe
    cnt, fe = ctl[BCTL_CNT], ctl[BCTL_FE]
    outer = (cnt > 0) & (ctl[BCTL_LEVEL] < ctl[BCTL_LEVELMAX])
    fits = (cnt <= tiers[:, 0]) & (fe <= tiers[:, 1])
    first_fit = torch.cat([torch.where(fits, torch.arange(t, device=dev), t),
                           torch.full((1,), t, device=dev)]).min()
    chosen = torch.maximum(first_fit, ctl[BCTL_MINTIER])
    cond[0] = outer
    cond[1:] = outer & (chosen == torch.arange(t + 2, device=dev))


def bfs_apply(levels, fmask, ctl, tiers, stage: int, itermax: int, reached=None, claim=None,
              ids=None, stat=None, deg_pad=None, source=None, k_bu: int = 0, e_bu: int = 0,
              handles=None) -> None:
    """K23 wrapper, every BFS device-loop step's update, status and routing:
    at STAGE_INIT levels := INT32_INF but 0 at the source (``source``, an
    int32 [1] host tensor, pinned on a card, which the kernel reads) and the
    dense frontier ``fmask`` (int32 [n]) the source alone; after a step of
    tier i (STAGE_TIER + i) the new frontier ``ids`` [k_i] (padded with n;
    its length is the tier's rows k_i) gets level + 1 where its count
    ``stat[0]`` is at most k_i, else the level escalates a tier; after a bottom-up step (STAGE_BU) the ``claim`` mask
    (bool [n]) and the claimed ``ids`` get level + 1 where the residual's
    count and edge sum (``stat``) fit ``k_bu`` and ``e_bu``, else the level
    goes dense and ``fmask`` := levels == level; after a dense step
    (STAGE_DENSE) the unvisited vertices with ``reached`` (int32 [n]) == 1
    get level + 1 and are the new ``fmask``. Then in ``ctl`` the frontier's
    count and out-degree sum (``deg_pad`` [n+1] int32; None: sums of 0), the
    level, min_tier, the steps run by phase and every condition: outer =
    count > 0 and level < itermax; phase j = outer and chosen == j, chosen
    = max(first_fit, min_tier) over ``tiers`` ([T, 2] int32 (rows, edges)
    budgets on the device), bottom-up T and dense T + 1; and, given the
    graph's ``handles`` (int64, the nest's first conditions), into the
    graph's conditional nodes. One launch, nothing read back."""
    n, t = levels.shape[0], tiers.shape[0]
    opt = (reached, ids, stat, deg_pad)
    if any(x.dtype != torch.int32 for x in (levels, fmask, ctl, tiers) + opt if x is not None) \
            or (claim is not None and claim.dtype != torch.bool):
        raise TypeError("bfs_apply: int32 levels, fmask, ctl, tiers, reached, ids, stat, "
                        "deg_pad and a bool claim")
    need = {STAGE_INIT: (source,), STAGE_BU: (claim, ids, stat),
            STAGE_DENSE: (reached,)}.get(stage, (ids, stat))
    if not STAGE_INIT <= stage < STAGE_TIER + t or any(x is None for x in need) or \
            fmask.shape != (n,) or ctl.shape != (ctl_words(t),) or tiers.shape != (t, 2) or \
            any(x is not None and x.shape != (n,) for x in (reached, claim)) or \
            (stat is not None and stat.shape != (2,)) or \
            (deg_pad is not None and deg_pad.shape[0] < n) or \
            (source is not None and source.device.type != "cpu"):
        raise ValueError(f"bfs_apply: shapes, the inputs of stage {stage} for {t} tiers, or "
                         "source not on the host")
    ts = [x for x in (levels, fmask, ctl, tiers, claim) + opt if x is not None]
    if any(x.device != levels.device for x in ts) or not all(x.is_contiguous() for x in ts):
        raise ValueError("bfs_apply: inputs must be contiguous, on one device")
    if not kernels.use_kernel(levels):
        bfs_apply_plain(levels, fmask, ctl, tiers, stage, itermax, reached, claim, ids, stat,
                        deg_pad, source, k_bu, e_bu)
        return
    if source is not None and not source.is_pinned():
        raise ValueError("bfs_apply: on a card source must be pinned, the kernel reads it")
    acc = torch.empty(3, dtype=torch.int64, device=levels.device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    kernels.launch("bfs_apply", levels.device, levels.data_ptr(), n, fmask.data_ptr(),
                   ptr(reached), ptr(claim), ptr(ids), 0 if ids is None else ids.shape[0],
                   ptr(stat), ptr(deg_pad), ptr(source), acc.data_ptr(), ctl.data_ptr(),
                   tiers.data_ptr() if t else None, t, stage, k_bu, e_bu, itermax,
                   ptr(handles), 0 if handles is None else handles.shape[0],
                   8 * kernels.sm_count(levels.device))


class LoopState(NamedTuple):
    """A BFS device loop's state, allocated once (per graph, device and
    ladder on a card). The dense nest (bfs-impl=device) has no tier or
    bottom-up buffers."""

    levels: torch.Tensor          # [n] int32
    fmask: torch.Tensor           # [n] int32: the dense step's frontier
    ids: Optional[torch.Tensor]   # [k_max] int32: a tier step's frontier, padded with n
    ids2: Optional[torch.Tensor]  # [k_max] int32: its new frontier
    starts: Optional[torch.Tensor]  # [max(k_max, k_bu) + 1] int32: an expansion's row starts
    rids: Optional[torch.Tensor]  # [k_bu] int32: the bottom-up's residual rows
    stat: torch.Tensor            # [3] int32: a step's K14 count and degree sum, then a count
    ctl: torch.Tensor             # [ctl_words(T)] int32 control words (BCTL_*)
    tiers: torch.Tensor           # [T, 2] int32 (rows, edges) budgets, on the device
    source: torch.Tensor          # [1] int32 on the host, pinned on a card
    handles: Optional[torch.Tensor]  # int64 conditional handles, or None
    budgets: tuple                # the tiers as Python ints
    k_bu: int
    e_bu: int


def _loop_state(device, n: int, budgets: tuple, k_bu: int, e_bu: int, nest,
                handles: bool) -> LoopState:
    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    t = len(budgets)
    k_max = max((k for k, _ in budgets), default=0)
    buf = lambda k: torch.full((k,), n, **i32) if t else None  # noqa: E731
    return LoopState(
        torch.zeros(n, **i32), torch.zeros(n, **i32), buf(k_max), buf(k_max),
        buf(max(k_max, k_bu) + 1), buf(k_bu), torch.zeros(3, **i32),
        torch.zeros(ctl_words(t), **i32), torch.tensor(budgets, **i32).reshape(t, 2),
        torch.zeros(1, dtype=torch.int32, pin_memory=dev.type == "cuda"),
        torch.zeros(device_loop.conditions(nest), dtype=torch.int64, device=dev)
        if handles else None, budgets, k_bu, e_bu,
    )


# The step functions: hand-kernel launches and memsets only, no host read.
# Each ends with K23, which updates the levels and routes the next step; the
# level the kernels test against is read on the card, from ctl.

def _apply(st: LoopState, stage: int, deg_pad, **kw) -> None:
    bfs_apply(st.levels, st.fmask, st.ctl, st.tiers, stage, min(st.levels.shape[0], INT32_INF),
              deg_pad=deg_pad, source=st.source, k_bu=st.k_bu, e_bu=st.e_bu, handles=st.handles,
              **kw)


def _level(st: LoopState) -> torch.Tensor:
    return st.ctl[BCTL_LEVEL:BCTL_LEVEL + 1]


def _step_init(deg_pad, st: LoopState) -> None:
    """The source's level: count 1, level 0."""
    _apply(st, STAGE_INIT, deg_pad)


def _step_tier(prep: BfsPrep, st: LoopState, i: int) -> None:
    """A push step of tier i: the frontier (K14's level mode) expanded over
    its out-edges in e_i slots (K18, K5), its unvisited neighbours deduped
    into the new frontier (K14's unvisited mode), then K23."""
    k, e = st.budgets[i]
    n, ids, ids2 = st.levels.shape[0], st.ids[:k], st.ids2[:k]
    compact_level_into(st.levels, _level(st), ids, st.stat[2:])
    exp = expand(ids, prep.deg_pad, prep.push_indptr, prep.push_dst, e, with_row_ids=False,
                 starts=st.starts[:k + 1])
    compact_unvisited_into(exp, st.levels, n, prep.deg_pad, ids2, st.stat[:2])
    _apply(st, STAGE_TIER + i, prep.deg_pad, ids=ids2, stat=st.stat[:2])


def _step_bu(prep: BfsPrep, st: LoopState) -> None:
    """A truncated bottom-up step: unvisited rows whose first t_trunc
    in-neighbours hit the frontier are claimed (K13); the rows with more
    in-edges that the probe missed (K14, with their in-degree sum) get their
    full in-lists checked (K18, K5, K17), unless that residual overflows its
    budgets; then K23."""
    n = st.levels.shape[0]
    pdeg_n = prep.pull_deg_pad[:-1]
    claim, resid = bfs_trunc_probe(st.levels, _level(st), prep.trunc_tbl, pdeg_n,
                                   prep.trunc_tbl.shape[0] // max(n, 1))
    compact_into(resid, prep.pull_deg_pad, st.rids, st.stat[:2])
    exp = expand(st.rids, prep.pull_deg_pad, prep.pull.indptr, prep.pull.src, st.e_bu,
                 with_row_ids=False, starts=st.starts[:st.k_bu + 1])
    claimed = residual_claim(st.levels, _level(st), exp, st.e_bu, st.rids, n)
    _apply(st, STAGE_BU, prep.deg_pad, claim=claim, ids=claimed, stat=st.stat[:2])


def _step_dense(pull: PullCSR, deg_pad, st: LoopState) -> None:
    """A dense pull step: the frontier's reach over every in-edge (K7
    max_i32 over ``fmask``), then K23."""
    reached = csr_pull_reduce("max_i32", st.fmask, pull.src, pull.indptr)
    _apply(st, STAGE_DENSE, deg_pad, reached=reached)


def _steps(prep: BfsPrep, st: LoopState):
    """(name, step) of every step kind of BFS auto, in the graph's order."""
    return ([("init", functools.partial(_step_init, prep.deg_pad, st))]
            + [(f"tier{i}", functools.partial(_step_tier, prep, st, i))
               for i in range(len(st.budgets))]
            + [("bu", functools.partial(_step_bu, prep, st)),
               ("dense", functools.partial(_step_dense, prep.pull, prep.deg_pad, st))])


def _dense_steps(pull: PullCSR, st: LoopState):
    """(name, step) of bfs-impl=device's loop: the JAX kernel's one
    while_loop of dense steps, whose status needs no degree sum."""
    return [("init", functools.partial(_step_init, None, st)),
            ("dense", functools.partial(_step_dense, pull, None, st))]


class _LoopGraph(device_loop.LoopGraph):
    """A BFS device loop as one CUDA graph: ``nest`` over ``steps_of``'s steps
    -> copy of the levels. A run writes the source into pinned host memory
    (init's K23 reads it) and launches the graph."""

    def __init__(self, st: LoopState, steps_of, nest):
        self.st = st
        eager = [step for _, step in steps_of(st._replace(handles=None))]
        super().__init__(st.levels.device, steps_of(st), eager, nest, st.handles, st.levels)


class _Loop(NamedTuple):
    """A BFS device loop's set-up: its graph's key in the Graph's memo, a
    tensor on its device, its LoopState given whether it has handles, its
    steps given a state (``_steps`` or ``_dense_steps``) and its nest."""

    key: tuple
    on: torch.Tensor
    state: Callable
    steps_of: Callable
    nest: tuple


def _auto_loop(graph: Graph, cfg: PlatformConfig):
    """BFS auto's loop under ``cfg``: ((t_trunc, tiers, k_bu, e_bu), _Loop)."""
    ladder = t_trunc, tiers, k_bu, e_bu = bfs_ladder(graph.n, cfg)
    prep = bfs_adaptive_prep(graph, t_trunc, cfg.device)
    nest = loop_nest(len(tiers))
    return ladder, _Loop(
        ("bfs_loop", str(torch.device(cfg.device)), t_trunc, tiers, k_bu, e_bu), prep.deg_pad,
        lambda handles: _loop_state(cfg.device, graph.n, tiers, k_bu, e_bu, nest, handles),
        functools.partial(_steps, prep), nest)


def _dense_loop(graph: Graph, device) -> _Loop:
    """bfs-impl=device's loop (``DENSE_NEST``)."""
    pull = pull_csr(graph, device)
    return _Loop(("bfs_dense_loop", str(torch.device(device))), pull.indptr,
                 lambda handles: _loop_state(device, graph.n, (), 0, 0, DENSE_NEST, handles),
                 functools.partial(_dense_steps, pull), DENSE_NEST)


def _launch_loop(graph: Graph, spec: _Loop, source: int):
    """A device loop's run up to its last step, nothing read back on a card:
    (levels, ctl, the graph or None, the host loop's reads of ctl). On a card
    (the device of ``spec.on``) one graph launch (the graph memoized on
    ``graph`` under ``spec.key``); on the CPU, or inside
    ``kernels.plain_torch()``, the host loop of the same nest."""
    if kernels.use_kernel(spec.on):
        loop = graph.memo.get(spec.key)
        if loop is None:
            loop = graph.memo[spec.key] = _LoopGraph(spec.state(True), spec.steps_of, spec.nest)
        loop.st.source[0] = source
        return loop.launch("bfs.graph"), loop.st.ctl, loop, 0
    st, reads = _walk(spec, source)
    return st.levels, st.ctl, None, reads


def _walk(spec: _Loop, source: int):
    """The host loop of ``spec``'s nest from ``source``, on a new state with
    no handles, each wrapper launching its kernel on a card: (the state, the
    conditions read)."""
    st = spec.state(False)
    st.source[0] = source
    ranges = {**RANGES, **{f"tier{i}": "bfs.tier_step" for i in range(len(st.budgets))}}
    reads = device_loop.run_host(spec.nest, dict(spec.steps_of(st)),
                                 lambda j: bool(st.ctl[BCTL_COND + j]), ranges)
    return st, reads


# how the last bfs_adaptive_run or _bfs_kernel went: its driver ("graph" or
# "host loop") and the host loop's reads of a condition in ctl
last_run: dict = {}


def _finish_run(loop, ctl: list, t: int, reads: int) -> None:
    if loop is not None:
        loop.account(loop_runs(ctl, t))
    last_run.clear()
    last_run.update(driver="host loop" if loop is None else "graph", condition_reads=reads)


def _bfs_kernel(graph: Graph, source: int, device):
    """bfs-impl=device: dense steps (K7, K23) until the frontier is empty, as
    one device loop (``DENSE_NEST``): (int32 levels with INT32_INF
    unreachable, steps including the last, empty one)."""
    levels, ctl_t, loop, reads = _launch_loop(graph, _dense_loop(graph, device), source)
    ctl = ctl_t.tolist()  # the run's one read
    _finish_run(loop, ctl, 0, reads)
    return levels, ctl[BCTL_LEVEL]


STEP_MODES = ("phases", "switch")


def _step_mode(cfg) -> None:
    """Both of the JAX package's step modes run the one nest of phases
    (``loop_nest``): its step sequence is a function of the state alone,
    which is what the switch's body computes too (the JAX package's own test
    holds the two modes equal, counters and all)."""
    mode = cfg.bfs_step_mode or "phases"
    if mode not in STEP_MODES:
        raise ValueError(f"unknown bfs-step-mode {mode!r}; expected {'|'.join(STEP_MODES)}")


def bfs_ladder(n: int, cfg: PlatformConfig):
    """(t_trunc, tiers, k_bu, e_bu) of BFS auto under ``cfg``: the probe
    depth, the ascending (rows, edges) push tiers (rows capped on their own,
    since only push steps size buffers by rows) and the bottom-up's
    residual budgets, as the JAX package reads them."""
    t_trunc = int(cfg.bfs_trunc or BFS_TRUNC)
    if cfg.bfs_push_tiers:
        edge_tiers = sorted({int(t) for t in str(cfg.bfs_push_tiers).split(",") if t})
    else:
        e_cap = int(cfg.bfs_frontier_edges or 1 << 22)
        edge_tiers = [t for t in (1 << 16, 1 << 18, 1 << 20) if t < e_cap] + [e_cap]
    k_cap = int(cfg.bfs_frontier_rows or 1 << 18)
    tiers = tuple((min(k_cap, e, n), e) for e in edge_tiers)
    return t_trunc, tiers, int(cfg.bfs_bu_rows or 1 << 15), int(cfg.bfs_bu_edges or 1 << 18)


def bfs_adaptive_run(graph: Graph, src_dense: int, cfg: Optional[PlatformConfig] = None,
                     with_stats: bool = False):
    """Direction-optimizing BFS. Returns (int32 levels on cfg.device with
    INT32_INF unreachable, iterations), and with ``with_stats`` also the
    JAX package's dict of per-phase step counts, read from the control
    words in one read after the run; ``last_run`` says how it went."""
    cfg = cfg or PlatformConfig()
    _step_mode(cfg)
    (t_trunc, tiers, k_bu, e_bu), spec = _auto_loop(graph, cfg)
    levels, ctl_t, loop, reads = _launch_loop(graph, spec, src_dense)
    ctl = ctl_t.tolist()  # the run's one read
    t = len(tiers)
    _finish_run(loop, ctl, t, reads)
    niter, c = ctl[BCTL_LEVEL], ctl[BCTL_COND + t + 3:]
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
            levels, niter = _bfs_kernel(graph, src_dense, cfg.device)
        else:
            levels, niter = bfs_adaptive_run(graph, src_dense, cfg)
        levels = levels.cpu().numpy()
    levels = levels.astype(np.int64)
    levels[levels == INT32_INF] = UNREACHABLE
    return AlgorithmResult("bfs", levels, iterations=int(niter))
