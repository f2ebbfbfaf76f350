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
  (ops/frontier.py). JAX runs it as one while_loop program
  (``_cdlp_adaptive_kernel``); so does the port. The loop state lives on
  the device (``LoopState``: the labels, the changed mask, the active ids
  and a small int32 control vector ``ctl``), and the loop is a set of step
  functions that issue only hand-kernel launches and read nothing back: the
  first iteration, the full step, the boundary's derive and routing, and
  one tier step per tier. Each step ends with kernel K20's route
  (``cdlp_route``), which updates the loop counters and writes every loop
  condition into ``ctl``. On a card those steps are captured once per
  (prep, tiers, directedness) into one CUDA graph whose conditional nodes
  are the JAX kernel's loops (``_LoopGraph`` on ops/device_loop.py, nest
  ``loop_nest``: an outer WHILE, the full phase's WHILE, derive under an
  IF, one WHILE per tier); a run is one graph launch and one read of
  ``ctl`` at its end. On the CPU, and on a card inside
  ``kernels.plain_torch()``, a host loop of the same nest
  (``device_loop.run_host``) reads the conditions from ``ctl`` and calls the
  same step functions (each wrapper then takes its plain version): the
  reference the graph is held against. The routing, and so the counts of
  full and active steps, is the JAX kernel's, step for step. WCC's device
  loop (algorithms/wcc.py) has the same nest, control words and route with
  one tier.
* ``cdlp_adaptive_run`` (adaptive-host, and auto under iteration timing)
  decides on the host from the changed ids, slicing the incidence with
  numpy, by the ``cdlp_active_threshold`` share of the incidence.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import device_loop, kernels
from graphtpu_torch.ops.frontier import compact, compact_rows_into, compact_stream_into, expand
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

# The control words of the device loop (int32, csrc/cdlp_loop.cu CTL_*): the
# JAX kernel's routing state (acnt, ae, ch, it, nf), itermax, the last full
# step's changed count and their degree sum, the derives and the outer
# iterations run; from CTL_COND the conditions (outer, full, derive, then one
# a tier), then the tier steps run, one count a tier.
CTL_ACNT, CTL_AE, CTL_CH, CTL_IT, CTL_NF, CTL_ITERMAX, CTL_MCNT, CTL_MES = range(8)
CTL_DERIVES, CTL_OUTERS, CTL_COND = 8, 9, 10
COND_OUTER, COND_FULL, COND_DERIVE, COND_TIER = range(4)
# K20 route's stages: after the first iteration, a full step, a derive, at
# the boundary, and after a step of tier i (STAGE_TIER + i)
STAGE_INIT, STAGE_FULL, STAGE_DERIVE, STAGE_BOUNDARY, STAGE_TIER = range(5)

# the routing's active-count sentinels, as in the JAX kernel
STAY_FULL = INT32_INF  # the changed mask exceeds the largest tier
DERIVE = -1            # the changed mask fits: derive the active set at the boundary


# how the last cdlp_adaptive_device_run went (its docstring)
last_run: dict = {}


def ctl_words(t: int) -> int:
    """Words of ``ctl`` for t tiers."""
    return CTL_COND + COND_TIER + 2 * t


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
    loops: dict               # the device loop's CUDA graphs, by (tiers, directed)


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
            int32_tensor(neigh, device), {},
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


def cdlp_status_plain(labels, new, deg_pad, mask, ctl, k_max: int, e_max: int,
                      jump: bool = False) -> None:
    """K20's status entry, plain PyTorch: the JAX kernel's changed mask,
    ``mask_status`` (count, degree sum) and ``fits_mask``, then labels :=
    new; in the jump mode new is first min(new, new[new]), WCC's second
    pointer jump."""
    if jump:
        new = torch.minimum(new, table_gather(new, new))
    torch.ne(labels, new, out=mask)
    cnt = mask.sum()
    es = torch.where(mask, deg_pad[:labels.shape[0]], 0).sum()
    ctl[CTL_ACNT] = torch.where((cnt <= k_max) & (es <= e_max), DERIVE, STAY_FULL)
    ctl[CTL_CH] = cnt > 0
    ctl[CTL_MCNT] = cnt.clamp(max=INT32_INF)
    ctl[CTL_MES] = es.clamp(max=INT32_INF)
    labels.copy_(new)


def cdlp_status(labels, new, deg_pad, mask, ctl, k_max: int, e_max: int,
                jump: bool = False) -> None:
    """K20 wrapper, a full step's status: ``mask`` [n] := new != labels,
    ``labels`` [n] := new, and in ``ctl`` the routing's acnt (DERIVE when
    the changed vertices' count and degree sum fit (k_max, e_max), the
    largest tier, else STAY_FULL), ch (any changed) and the count and degree
    sum (clamped to int32). ``deg_pad`` [n+1] int32. With ``jump`` (WCC's
    full step; ``new`` holds ids in [0, n), K21's first jump) the new labels
    are min(new, new[new]). One pass on the card (counted as
    ``cdlp_route_status``, in the jump mode ``cdlp_route_status_jump``),
    nothing read back."""
    n = labels.shape[0]
    ts = (labels, new, deg_pad, ctl)
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in ts) or mask.dtype != torch.bool:
        raise TypeError("cdlp_status: labels, new, deg_pad and ctl must be 1-D int32, mask bool")
    if new.shape[0] != n or mask.shape != new.shape or deg_pad.shape[0] < n:
        raise ValueError("cdlp_status: labels, new and mask of one length, deg_pad no shorter")
    if any(t.device != labels.device for t in ts + (mask,)) or \
            not all(t.is_contiguous() for t in ts + (mask,)):
        raise ValueError("cdlp_status: inputs must be contiguous, on one device")
    if not kernels.use_kernel(labels):
        cdlp_status_plain(labels, new, deg_pad, mask, ctl, k_max, e_max, jump)
        return
    acc = torch.empty(3, dtype=torch.int64, device=labels.device)
    kernels.launch("cdlp_route_status", labels.device, labels.data_ptr(), new.data_ptr(), n,
                   deg_pad.data_ptr(), mask.data_ptr(), acc.data_ptr(), ctl.data_ptr(), k_max,
                   e_max, 1 if jump else 0, 8 * kernels.sm_count(labels.device),
                   counter="cdlp_route_status_jump" if jump else None)


def _chosen(ctl, tiers):
    """The smallest tier whose budgets hold (acnt, ae), else T (full), as
    a 0-d tensor: the JAX kernel's ``chosen``."""
    t = tiers.shape[0]
    acnt, ae = ctl[CTL_ACNT], ctl[CTL_AE]
    fits = (acnt >= 0) & (acnt <= tiers[:, 0]) & (ae <= tiers[:, 1])
    return torch.where(fits, torch.arange(t, device=ctl.device), t).min()


def cdlp_route_plain(ctl, tiers, stage: int, itermax) -> None:
    """K20's route, plain PyTorch (see ``cdlp_route``)."""
    t = tiers.shape[0]
    cond, tier_steps = ctl[CTL_COND:CTL_COND + COND_TIER + t], ctl[CTL_COND + COND_TIER + t:]
    if stage == STAGE_INIT:
        ctl[CTL_ITERMAX] = itermax[0]
        ctl[CTL_AE], ctl[CTL_IT], ctl[CTL_NF], ctl[CTL_DERIVES], ctl[CTL_OUTERS] = 0, 1, 1, 0, 0
        tier_steps.zero_()
    elif stage == STAGE_FULL:
        ctl[CTL_IT:CTL_NF + 1] += 1
    elif stage == STAGE_DERIVE:
        ctl[CTL_DERIVES] += 1
    elif stage == STAGE_BOUNDARY:
        # forward progress: an exact active set past every tier goes back to full
        ctl[CTL_OUTERS] += 1
        ctl[CTL_ACNT] = torch.where(_chosen(ctl, tiers) == t, STAY_FULL, ctl[CTL_ACNT])
    else:
        ctl[CTL_IT] += 1
        tier_steps[stage - STAGE_TIER] += 1
    live = (ctl[CTL_CH] != 0) & (ctl[CTL_IT] < ctl[CTL_ITERMAX])
    cond[COND_OUTER] = live
    cond[COND_FULL] = live & (ctl[CTL_ACNT] == STAY_FULL)
    cond[COND_DERIVE] = live & (ctl[CTL_ACNT] == DERIVE)
    cond[COND_TIER:] = live & (_chosen(ctl, tiers) == torch.arange(t, device=ctl.device))


def cdlp_route(ctl, tiers, stage: int, itermax, handles=None) -> None:
    """K20 wrapper, the loop's routing after a step of kind ``stage``
    (STAGE_*): at STAGE_INIT it sets itermax (read from ``itermax``, an
    int32 [1] host tensor, pinned on a card, which the kernel reads) and
    it = nf = 1; a full step adds one to it and nf, a tier step to it and
    its tier's count; the boundary sends an active set that no tier holds
    back to full. Then it writes every condition into ``ctl`` (outer, full,
    derive and one a tier; ``tiers`` [T, 2] int32 on the device) and, given
    the graph's ``handles`` (int64 [3 + T] on the device), into the
    graph's conditional nodes. One thread, one launch."""
    t = tiers.shape[0]
    if ctl.dtype != torch.int32 or tiers.dtype != torch.int32 or ctl.shape[0] != ctl_words(t):
        raise TypeError(f"cdlp_route: ctl must be int32 [{ctl_words(t)}], tiers int32 [T, 2]")
    if not STAGE_INIT <= stage < STAGE_TIER + t or itermax.device.type != "cpu":
        raise ValueError(f"cdlp_route: stage {stage} for {t} tiers, or itermax not on the host")
    if not kernels.use_kernel(ctl):
        cdlp_route_plain(ctl, tiers, stage, itermax)
        return
    if not itermax.is_pinned():
        raise ValueError("cdlp_route: on a card itermax must be pinned, the kernel reads it")
    kernels.launch("cdlp_route", ctl.device, ctl.data_ptr(), tiers.data_ptr(), t, stage,
                   itermax.data_ptr(), None if handles is None else handles.data_ptr())


def cdlp_tier_apply_plain(labels_buf, ids, winners, rowflag, ch, mode: str = "set") -> None:
    """K19's plain PyTorch version, the JAX kernels' formulation: valid
    rows, old labels, changed rows (winners != old; in mode "min", WCC's,
    winners = min(old, winners) and winners < old), a scatter whose
    unchanged and pad rows write the spare slot n, the flags and their any."""
    n = labels_buf.shape[0] - 1
    valid = ids < n
    old = table_gather(labels_buf[:n], torch.where(valid, ids, 0))
    if mode == "min":
        winners = torch.minimum(old, winners)
        changed = valid & (winners < old)
    else:
        changed = valid & (winners != old)
    labels_buf.index_copy_(0, torch.where(changed, ids, n).long(), torch.where(changed, winners, 0))
    rowflag.copy_(changed)
    ch.copy_(changed.any())


def cdlp_tier_apply(labels_buf, ids, winners, rowflag, ch, mode: str = "set") -> None:
    """K19 wrapper, a tier step's update: for each row r, when ids[r] < n
    and winners[r] != labels[ids[r]] (mode "min", WCC's active step:
    winners[r] < labels[ids[r]]), labels[ids[r]] := winners[r] in place
    and rowflag[r] is set; ``ch`` (an int32 0-d view of ``ctl``) := any row
    changed. ``labels_buf`` is [n+1] int32 (the labels, then a spare slot
    that only the plain version writes), ``ids`` [k] int32 (ascending,
    padded with n) and ``winners`` [k] int32, ``rowflag`` [k] bool. One
    launch (mode "min" counted as ``cdlp_tier_apply_min``), nothing read
    back."""
    if mode not in ("set", "min"):
        raise ValueError(f"cdlp_tier_apply: unknown mode {mode!r}")
    ts = (labels_buf, ids, winners)
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in ts) or rowflag.dtype != torch.bool \
            or ch.dtype != torch.int32 or ch.dim() != 0:
        raise TypeError("cdlp_tier_apply: 1-D int32 labels_buf, ids and winners, bool rowflag, "
                        "a 0-d int32 ch")
    k = ids.shape[0]
    if winners.shape[0] != k or rowflag.shape != ids.shape or labels_buf.shape[0] < 1:
        raise ValueError("cdlp_tier_apply: ids, winners and rowflag of one length")
    if any(t.device != ids.device for t in ts + (rowflag, ch)) or \
            not all(t.is_contiguous() for t in ts + (rowflag,)):
        raise ValueError("cdlp_tier_apply: inputs must be contiguous, on one device")
    if not kernels.use_kernel(ids):
        cdlp_tier_apply_plain(labels_buf, ids, winners, rowflag, ch, mode)
        return
    is_min = mode == "min"
    kernels.launch("cdlp_tier_apply", ids.device, labels_buf.data_ptr(), labels_buf.shape[0] - 1,
                   ids.data_ptr(), winners.data_ptr(), k, rowflag.data_ptr(), ch.data_ptr(),
                   1 if is_min else 0, counter="cdlp_tier_apply_min" if is_min else None)


class LoopState(NamedTuple):
    """The device loop's state, allocated once (per graph on a card)."""

    labels_buf: torch.Tensor  # [n+1] int32: the labels, then K19's plain spare slot
    mask: torch.Tensor        # [n] bool: the last full step's changed vertices
    ids: torch.Tensor         # [k_max] int32: the active set, ascending, padded with n
    rowflag: torch.Tensor     # [k_max] bool: the rows a tier step changed
    ctl: torch.Tensor         # [ctl_words(T)] int32 control words (CTL_*)
    tiers: torch.Tensor       # [T, 2] int32 (rows, edges) budgets, on the device
    itermax: torch.Tensor     # [1] int32 on the host, pinned on a card
    handles: Optional[torch.Tensor]  # [3 + T] int64 conditional handles, or None
    budgets: tuple            # the tiers as Python ints

    @property
    def labels(self) -> torch.Tensor:
        return self.labels_buf[:self.mask.shape[0]]


def _loop_state(prep: AdaptivePrep, n: int, budgets: tuple, handles: bool) -> LoopState:
    dev = prep.deg_pad.device
    k_max, t = budgets[-1][0], len(budgets)
    i32 = dict(dtype=torch.int32, device=dev)
    return LoopState(
        torch.zeros(n + 1, **i32), torch.zeros(n, dtype=torch.bool, device=dev),
        torch.full((k_max,), n, **i32), torch.zeros(k_max, dtype=torch.bool, device=dev),
        torch.zeros(ctl_words(t), **i32), torch.tensor(budgets, **i32),
        torch.zeros(1, dtype=torch.int32, pin_memory=dev.type == "cuda"),
        torch.zeros(COND_TIER + t, dtype=torch.int64, device=dev) if handles else None, budgets,
    )


# The step functions: hand-kernel launches only, no host read. Each ends
# with K20's route, which leaves every loop condition in ctl.

def _route(st: LoopState, stage: int) -> None:
    cdlp_route(st.ctl, st.tiers, stage, st.itermax, st.handles)


def _status(prep: AdaptivePrep, st: LoopState, new: torch.Tensor) -> None:
    k_max, e_max = st.budgets[-1]
    cdlp_status(st.labels, new, prep.deg_pad, st.mask, st.ctl, k_max, e_max)


def _step_init(prep: AdaptivePrep, st: LoopState, directed: bool) -> None:
    """Iteration 0 from labels = ids, then its status: it = nf = 1."""
    labels = st.labels
    torch.arange(labels.shape[0], dtype=torch.int32, device=labels.device, out=labels)
    _status(prep, st, _first_iteration(prep.plan, labels, directed))
    _route(st, STAGE_INIT)


def _step_full(prep: AdaptivePrep, st: LoopState) -> None:
    """A full slab step over every vertex."""
    _status(prep, st, cdlp_step(st.labels, prep.plan))
    _route(st, STAGE_FULL)


def _step_derive(prep: AdaptivePrep, st: LoopState) -> None:
    """The active set, the union of the last full step's changed vertices'
    incidence lists, at the largest tier's sizes (the mask fits them), with
    its count and degree sum: the JAX kernel's derive, adopted."""
    k_max, e_max = st.budgets[-1]
    ids, _ = compact(st.mask, k_max)
    exp = expand(ids, prep.deg_pad, prep.indptr_pad, prep.neigh, e_max, with_row_ids=False)
    compact_stream_into(exp.neigh, exp.valid, st.mask.shape[0], prep.deg_pad, st.ids,
                        st.ctl[CTL_ACNT:CTL_AE + 1])
    _route(st, STAGE_DERIVE)


def _step_boundary(prep: AdaptivePrep, st: LoopState) -> None:
    """The phase boundary's forward-progress rule and the tiers' conditions."""
    _route(st, STAGE_BOUNDARY)


def _step_tier(prep: AdaptivePrep, st: LoopState, i: int) -> None:
    """A step of tier i over the active ids: their min-mode, the labels'
    update, and the next active set (the neighbours of the rows that
    changed, from this step's own expansion) with its count and degree sum."""
    k_i, e_i = st.budgets[i]
    n = st.mask.shape[0]
    ids_i = st.ids[:k_i]
    exp = expand(ids_i, prep.deg_pad, prep.indptr_pad, prep.neigh, e_i, with_row_ids=False)
    winners = stream_minmode(st.labels, None, exp.neigh, exp.seg_starts)
    rowflag = st.rowflag[:k_i]
    cdlp_tier_apply(st.labels_buf, ids_i, winners, rowflag, st.ctl[CTL_CH])
    compact_rows_into(exp, rowflag, n, prep.deg_pad, st.ids, st.ctl[CTL_ACNT:CTL_AE + 1])
    _route(st, STAGE_TIER + i)


def _steps(prep: AdaptivePrep, st: LoopState, directed: bool):
    """(name, step) of every step kind, in the graph's order."""
    return ([("init", functools.partial(_step_init, prep, st, directed)),
             ("full", functools.partial(_step_full, prep, st)),
             ("derive", functools.partial(_step_derive, prep, st)),
             ("boundary", functools.partial(_step_boundary, prep, st))]
            + [(f"tier{i}", functools.partial(_step_tier, prep, st, i))
               for i in range(len(st.budgets))])


def loop_nest(t: int) -> tuple:
    """The JAX kernel's nested loops over the steps of ``_steps`` (t tiers),
    conditions indexed from CTL_COND: init, then WHILE outer { WHILE full
    {full}; IF derive {derive}; boundary; WHILE tier i {tier i} ... }."""
    return ("init", ("while", COND_OUTER, (
        ("while", COND_FULL, ("full",)), ("if", COND_DERIVE, ("derive",)), "boundary",
        *(("while", COND_TIER + i, (f"tier{i}",)) for i in range(t)))))


def loop_runs(ctl: list, t: int) -> dict:
    """Each step's executions in a run, from the run's control words."""
    runs = {"init": 1, "full": ctl[CTL_NF] - 1, "derive": ctl[CTL_DERIVES],
            "boundary": ctl[CTL_OUTERS]}
    runs.update((f"tier{i}", ctl[CTL_COND + COND_TIER + t + i]) for i in range(t))
    return runs


def _host_loop(prep: AdaptivePrep, st: LoopState, directed: bool) -> int:
    """The JAX kernel's nested loops on the host, each condition read from
    ctl, each step kind in a named profiler range (so a trace splits the wall
    time, host included, between them). Returns the number of conditions
    read."""
    t = len(st.budgets)
    ranges = {"init": "cdlp.full_step", "full": "cdlp.full_step", "derive": "cdlp.derive",
              **{f"tier{i}": "cdlp.tier_step" for i in range(t)}}
    return device_loop.run_host(loop_nest(t), dict(_steps(prep, st, directed)),
                                lambda j: bool(st.ctl[CTL_COND + j]), ranges)


class _LoopGraph(device_loop.LoopGraph):
    """The device loop as one CUDA graph (ops/device_loop.py), for one prep,
    tier ladder and directedness:

        init -> WHILE outer { WHILE full {full}; IF derive {derive};
                              boundary; WHILE tier 0 {tier0}; ... } -> copy

    A run writes itermax into pinned host memory (the first step's K20 reads
    it) and launches the graph; ``account`` takes the step counts from a
    run's ctl."""

    def __init__(self, prep: AdaptivePrep, n: int, budgets: tuple, directed: bool):
        self.n, self.st = n, _loop_state(prep, n, budgets, handles=True)
        self.st.itermax[0] = 1
        eager = [step for _, step in _steps(prep, self.st._replace(handles=None), directed)]
        super().__init__(prep.deg_pad.device, _steps(prep, self.st, directed), eager,
                         loop_nest(len(budgets)), self.st.handles, self.st.labels)

    def launch(self, itermax: int) -> torch.Tensor:
        """One run: the labels, on the card, once the stream gets there."""
        self.st.itermax[0] = itermax
        return super().launch("cdlp.graph")

    def account(self, ctl: list) -> None:
        """Adds each step's captured launches times its executions that ctl
        reports to ``kernels.replayed_counts``."""
        super().account(loop_runs(ctl, len(self.st.budgets)))


def _loop_graph(prep: AdaptivePrep, n: int, budgets: tuple, directed: bool) -> _LoopGraph:
    """The memoized graph of the device loop for this prep."""
    key = (budgets, bool(directed))
    if key not in prep.loops:
        prep.loops[key] = _LoopGraph(prep, n, budgets, directed)
    return prep.loops[key]


def _launch_loop(prep: AdaptivePrep, n: int, itermax: int, directed: bool, budgets: tuple):
    """The device loop's run up to its last step, nothing read back on a
    card: (labels, ctl, the graph or None, the host loop's reads of ctl).
    On a card one graph launch; on the CPU, or inside
    ``kernels.plain_torch()``, the host loop."""
    itermax = min(itermax, INT32_INF)
    if kernels.use_kernel(prep.deg_pad):
        loop = _loop_graph(prep, n, budgets, directed)
        return loop.launch(itermax), loop.st.ctl, loop, 0
    st = _loop_state(prep, n, budgets, handles=False)
    st.itermax[0] = itermax
    reads = _host_loop(prep, st, directed)
    return st.labels, st.ctl, None, reads


def cdlp_adaptive_device_run(graph, centers, neigh, deg, itermax, cfg,
                             prep: AdaptivePrep | None = None, with_stats: bool = False):
    """CDLP with frontier-tier active steps. Returns (labels on cfg.device,
    iterations), and with ``with_stats`` also a dict of full_steps,
    active_steps, e_cap and k_cap (the JAX entry's). How the run went is
    left in ``last_run``: its derives, outer iterations and tier steps by
    tier (from ctl), its driver ("graph" or "host loop") and the host
    loop's reads of a condition in ctl (0 under the graph, whose conditional
    nodes read them on the device). Either ends with one read of ctl."""
    if prep is None:
        prep = prepare_cdlp_adaptive(graph, centers, neigh, deg, cfg)
    k_cap = int(cfg.cdlp_frontier_rows or 1 << 16)
    e_cap = int(cfg.cdlp_frontier_edges or 1 << 18)
    tiers = cdlp_tiers(k_cap, e_cap, int(np.asarray(deg).sum()), cfg)
    itermax, loop, reads = int(itermax), None, 0
    if itermax < 1:
        labels = torch.arange(graph.n, dtype=torch.int32, device=prep.deg_pad.device)
        ctl = [0] * ctl_words(len(tiers))
    else:
        labels, ctl_t, loop, reads = _launch_loop(prep, graph.n, itermax, graph.directed, tiers)
        ctl = ctl_t.tolist()  # the run's last host read
        if loop is not None:
            loop.account(ctl)
    it, nf = ctl[CTL_IT], ctl[CTL_NF]
    last_run.clear()
    last_run.update(derives=ctl[CTL_DERIVES], outer_iterations=ctl[CTL_OUTERS],
                    tier_steps=ctl[CTL_COND + COND_TIER + len(tiers):],
                    driver="host loop" if loop is None else "graph", condition_reads=reads)
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
