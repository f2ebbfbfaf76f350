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
* "device": full steps on K7 only, to the fixed point (``wcc_device_run``):
  each K7 ``min_i32``, K21 and K20's jump mode, then K25 (ops/fixed_point.py)
  routes the one WHILE; on a card one CUDA graph.

The adaptive phases, one while_loop program in JAX (``_wcc_adaptive_loop``),
are a device loop here with the nest, control words and route of CDLP auto's
(ops/active.py, one tier of the frontier capacities): the labels, the last
full step's changed mask, the active ids and row flags live in preallocated
buffers, and the steps (``_steps``: iteration 0, a full step, the derive,
the boundary, an active step) issue only hand-kernel launches, memsets and
copies and read nothing back. A full step's neighbours' minimum is K6 and K7
(slab) or K7 (edge stream); then K21 (``wcc_jump``) takes the first pointer
jump and K20's status entry in its jump mode the second, with the changed
mask, the labels' update and the routing's status in the same pass. An
active step is K18 and K5 (the expansion), K7 (each row's minimum), K19's
min mode (the update) and K14's row-flag mode (the next active set). On a
card the run is one CUDA graph (ops/device_loop.py) and one read of the
control words after it; on the CPU, and inside ``kernels.plain_torch()``,
the host loop of the same nest. The counts of full and active steps are the
JAX kernel's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from graphtpu_torch.algorithms.common import AlgorithmResult, register
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import active as A
from graphtpu_torch.ops import device_loop, fixed_point, kernels
from graphtpu_torch.ops.frontier import compact, compact_rows_into, compact_stream_into, expand
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.slab import SlabPlan, assemble, result_buffer
from graphtpu_torch.ops.spmv import (
    PullCSR, build_pull_plan, csr_pull_reduce, int32_tensor, pull_csr, slab_spmv_min_buckets,
)
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
from graphtpu_torch.utils.roofline import plan_gather_count

# "dense" is the JAX package's name of the dense kernel on one device:
# it runs as "device"
IMPLS = ("auto", "slab", "adaptive", "device", "dense")


class WccPrep(NamedTuple):
    """The symmetrized graph's pull CSR and in-degrees on one device."""

    pull: PullCSR
    deg_pad: torch.Tensor  # [n+1] int32, 0 at n


def wcc_jump_plain(labels: torch.Tensor, neigh_min: torch.Tensor) -> torch.Tensor:
    """K21's plain PyTorch version, the JAX formulation: min(labels,
    neigh_min), then one pointer jump."""
    new = torch.minimum(labels, neigh_min)
    return torch.minimum(new, table_gather(new, new))


def wcc_jump(labels: torch.Tensor, neigh_min: torch.Tensor, out: torch.Tensor) -> None:
    """K21 wrapper: ``out`` [n] := the first pointer jump of WCC's full step,
    new = min(labels, neigh_min) and min(new, new[new]); K20's status entry
    in its jump mode takes the second. All int32 [n], ids in [0, n), ``out``
    aliasing neither input. One launch, nothing read back."""
    ts = (labels, neigh_min, out)
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in ts):
        raise TypeError("wcc_jump: labels, neigh_min and out must be 1-D int32")
    if any(t.shape != labels.shape or t.device != labels.device or not t.is_contiguous()
           for t in ts):
        raise ValueError("wcc_jump: contiguous tensors of one length, on one device")
    if not kernels.use_kernel(labels):
        out.copy_(wcc_jump_plain(labels, neigh_min))
        return
    kernels.launch("wcc_jump", labels.device, labels.data_ptr(), neigh_min.data_ptr(),
                   out.data_ptr(), labels.shape[0])


class DeviceState(NamedTuple):
    """wcc-impl=device's loop state, allocated once (per graph on a card)."""

    labels: torch.Tensor  # [n] int32
    jumped: torch.Tensor  # [n] int32: K21's first pointer jump
    mask: torch.Tensor    # [n] bool: the step's changed vertices (K20's)
    iota: torch.Tensor    # [n] int32: the identity labels the loop starts from
    wctl: torch.Tensor    # [A.ctl_words(1)] int32: K20's status words, its ch
    fp: fixed_point.Control


def _device_state(prep: WccPrep, n: int, handles: bool) -> DeviceState:
    dev = prep.deg_pad.device
    i32 = dict(dtype=torch.int32, device=dev)
    return DeviceState(torch.zeros(n, **i32), torch.zeros(n, **i32),
                       torch.zeros(n, dtype=torch.bool, device=dev), torch.arange(n, **i32),
                       torch.zeros(A.ctl_words(1), **i32), fixed_point.control(dev, handles))


def _device_steps(prep: WccPrep, st: DeviceState):
    """(name, step) of the full-step loop: init (the identity labels, a
    copy) and a full step over the edge stream: each vertex's minimum
    neighbour label (K7 ``min_i32``), K21's first jump, K20's jump mode (the
    second jump, the changed mask, labels := new), whose ch K25 reads."""

    def init():
        st.labels.copy_(st.iota)
        fixed_point.fixed_point_route(st.fp, fixed_point.STAGE_INIT)

    def step():
        neigh_min = csr_pull_reduce("min_i32", st.labels, prep.pull.src, prep.pull.indptr)
        wcc_jump(st.labels, neigh_min, st.jumped)
        A.cdlp_status(st.labels, st.jumped, prep.deg_pad, st.mask, st.wctl, 0, 0, jump=True)
        fixed_point.fixed_point_route(st.fp, fixed_point.STAGE_STEP, flag=st.wctl[A.CTL_CH])

    return [("init", init), ("step", step)]


def _launch_device(sym: Graph, prep: WccPrep):
    """The full-step loop's run up to its last step (``fixed_point.launch``):
    (labels, ctl, the graph or None, the host loop's reads)."""
    n = sym.n
    return fixed_point.launch(
        prep.deg_pad, sym.memo, ("wcc_device_loop", str(prep.deg_pad.device)),
        lambda handles: _device_state(prep, n, handles), lambda st: _device_steps(prep, st),
        lambda st: st.labels, min(n, INT32_INF), ranges={"step": "wcc.full_step"},
        range_name="wcc.graph")


def wcc_device_run(graph: Graph, cfg: PlatformConfig):
    """wcc-impl=device: full edge-stream steps to the fixed point (the JAX
    kernel's ``while changed and it < n``), (labels on cfg.device, steps).
    On a card one CUDA graph memoized on the symmetrized graph and one read
    of the control words; on the CPU and inside ``kernels.plain_torch()`` the
    host loop of the same nest (``last_run`` says which ran)."""
    sym = graph.symmetrized()
    prep = wcc_prep(sym, cfg.device)
    n = sym.n
    if n == 0:
        return prep.deg_pad[:0].clone(), 0
    labels, ctl_t, loop, reads = _launch_device(sym, prep)
    ctl = ctl_t.tolist()  # the run's one read
    if loop is not None:
        loop.account(fixed_point.runs(ctl))
    last_run.clear()
    last_run.update(driver="host loop" if loop is None else "graph", condition_reads=reads)
    return labels, ctl[fixed_point.FCTL_IT]


class LoopState(NamedTuple):
    """The WCC device loop's state, allocated once (per graph on a card);
    the control words, route and tiers are CDLP auto's (ops/active.py)."""

    labels_buf: torch.Tensor  # [n+1] int32: the labels, then K19's plain spare slot
    mask: torch.Tensor        # [n] bool: the last full step's changed vertices
    jumped: torch.Tensor      # [n] int32: K21's first pointer jump
    iota: torch.Tensor        # [n] int32: the identity labels iteration 0 starts from
    rest: Optional[torch.Tensor]  # [rest rows] int32 INT32_INF: the slab plan's edgeless rows
    ids: torch.Tensor         # [k] int32: the active set, ascending, padded with n
    rowflag: torch.Tensor     # [k] bool: the rows an active step changed
    starts: torch.Tensor      # [k+2] int32: an active expansion's row starts, then e_cap
    ctl: torch.Tensor         # [ctl_words(1)] int32 control words (A.CTL_*)
    tiers: torch.Tensor       # [1, 2] int32: the frontier capacities, on the device
    itermax: torch.Tensor     # [1] int32 on the host, pinned on a card: n
    handles: Optional[torch.Tensor]  # [4] int64 conditional handles, or None
    budgets: tuple            # ((k_cap, e_cap),)

    @property
    def labels(self) -> torch.Tensor:
        return self.labels_buf[:self.mask.shape[0]]


def _loop_state(prep: WccPrep, plan: Optional[SlabPlan], n: int, budgets: tuple,
                handles: bool) -> LoopState:
    dev = prep.deg_pad.device
    (k, e), = budgets
    i32 = dict(dtype=torch.int32, device=dev)
    rest = None
    if plan is not None and plan.rest_rows is not None:
        rest = torch.full((plan.rest_rows.shape[0],), INT32_INF, **i32)
    starts = torch.full((k + 2,), e, **i32)  # the last slot closes K7's pad segment
    return LoopState(
        torch.zeros(n + 1, **i32), torch.zeros(n, dtype=torch.bool, device=dev),
        torch.zeros(n, **i32), torch.arange(n, **i32), rest, torch.full((k,), n, **i32),
        torch.zeros(k, dtype=torch.bool, device=dev), starts,
        torch.zeros(A.ctl_words(1), **i32), torch.tensor(budgets, **i32),
        torch.zeros(1, dtype=torch.int32, pin_memory=dev.type == "cuda"),
        torch.zeros(A.COND_TIER + 1, dtype=torch.int64, device=dev) if handles else None,
        budgets,
    )


def _neigh_min_slab(plan: SlabPlan, st: LoopState, labels: Optional[torch.Tensor]):
    """Each vertex's minimum neighbour label on the slab plan: K6 over the
    buckets, K7 over the heavy rows, the edgeless rows' INT32_INF, placed by
    one K1 gather; ``labels`` None takes the stored ids (iteration 0)."""
    n = st.mask.shape[0]
    buf = result_buffer(plan, torch.int32)
    slab_spmv_min_buckets(plan, labels, n, buf)
    heavy = None
    if plan.heavy_rows is not None:
        heavy = csr_pull_reduce("min_i32", labels, plan.heavy_neigh, plan.heavy_indptr)
    return assemble(plan, buf, heavy, st.rest)


def _neigh_min_edges(prep: WccPrep, st: LoopState, labels: Optional[torch.Tensor]):
    """Each vertex's minimum neighbour label over the edge stream, on K7;
    ``labels`` None takes the stored ids (iteration 0)."""
    return csr_pull_reduce("min_i32", labels, prep.pull.src, prep.pull.indptr)


# The step functions: hand-kernel launches, memsets and copies only, no host
# read. Each ends with K20's route, which leaves every loop condition in ctl.

def _route(st: LoopState, stage: int) -> None:
    A.cdlp_route(st.ctl, st.tiers, stage, st.itermax, st.handles)


def _finish_step(prep: WccPrep, st: LoopState, neigh_min: torch.Tensor) -> None:
    """The full step after the neighbours' minimum: K21's first jump, then
    K20's status in its jump mode (the second jump, the changed mask, the
    labels and the routing's status)."""
    k, e = st.budgets[-1]
    wcc_jump(st.labels, neigh_min, st.jumped)
    A.cdlp_status(st.labels, st.jumped, prep.deg_pad, st.mask, st.ctl, k, e, jump=True)


def _step_init(prep: WccPrep, st: LoopState, neigh_min) -> None:
    """Iteration 0 from the identity labels (a copy), gather-free: the
    neighbours' minimum of the stored ids. it = nf = 1."""
    st.labels.copy_(st.iota)
    _finish_step(prep, st, neigh_min(None))
    _route(st, A.STAGE_INIT)


def _step_full(prep: WccPrep, st: LoopState, neigh_min) -> None:
    """A full step over every vertex."""
    _finish_step(prep, st, neigh_min(st.labels))
    _route(st, A.STAGE_FULL)


def _step_derive(prep: WccPrep, st: LoopState) -> None:
    """The active set, the union of the last full step's changed vertices'
    neighbours, with its count and degree sum: the JAX kernel's derive."""
    k, e = st.budgets[-1]
    ids, _ = compact(st.mask, k)
    exp = expand(ids, prep.deg_pad, prep.pull.indptr, prep.pull.src, e, with_row_ids=False)
    compact_stream_into(exp.neigh, exp.valid, st.mask.shape[0], prep.deg_pad, st.ids,
                        st.ctl[A.CTL_ACNT:A.CTL_AE + 1])
    _route(st, A.STAGE_DERIVE)


def _step_boundary(prep: WccPrep, st: LoopState) -> None:
    """The phase boundary: an active set past the capacities goes back to
    full steps."""
    _route(st, A.STAGE_BOUNDARY)


def _step_active(prep: WccPrep, st: LoopState) -> None:
    """An active step of pure min-propagation over the active ids: each
    row's minimum neighbour label on K7 (the valid slots are those before
    starts[k], which fit e_cap here; segment k, closed at e_cap, holds the
    pad slots and is dropped), K19's min mode, and the next active set (the
    neighbours of the rows that changed, from this step's own expansion)
    with its count and degree sum on K14's row-flag mode."""
    k, e = st.budgets[-1]
    n = st.mask.shape[0]
    exp = expand(st.ids, prep.deg_pad, prep.pull.indptr, prep.pull.src, e, with_row_ids=False,
                 starts=st.starts[:k + 1])
    mins = csr_pull_reduce("min_i32", st.labels, exp.neigh, st.starts)
    A.cdlp_tier_apply(st.labels_buf, st.ids, mins[:k], st.rowflag, st.ctl[A.CTL_CH], mode="min")
    compact_rows_into(exp, st.rowflag, n, prep.deg_pad, st.ids, st.ctl[A.CTL_ACNT:A.CTL_AE + 1])
    _route(st, A.STAGE_TIER)


def _steps(prep: WccPrep, plan: Optional[SlabPlan], st: LoopState):
    """(name, step) of every step kind, in the graph's order (the names of
    ``A.loop_nest(1)``); full steps on the slab plan, or the edge stream
    where ``plan`` is None."""
    neigh_min = (functools.partial(_neigh_min_slab, plan, st) if plan is not None
                 else functools.partial(_neigh_min_edges, prep, st))
    return [("init", functools.partial(_step_init, prep, st, neigh_min)),
            ("full", functools.partial(_step_full, prep, st, neigh_min)),
            ("derive", functools.partial(_step_derive, prep, st)),
            ("boundary", functools.partial(_step_boundary, prep, st)),
            ("tier0", functools.partial(_step_active, prep, st))]


RANGES = {"init": "wcc.full_step", "full": "wcc.full_step", "derive": "wcc.derive",
          "tier0": "wcc.active_step"}


class _LoopGraph(device_loop.LoopGraph):
    """The WCC device loop as one CUDA graph, for one prep, full-step kind
    and capacities: CDLP auto's nest with one tier."""

    def __init__(self, prep: WccPrep, plan: Optional[SlabPlan], n: int, budgets: tuple):
        self.st = _loop_state(prep, plan, n, budgets, handles=True)
        self.st.itermax[0] = 1
        eager = [step for _, step in _steps(prep, plan, self.st._replace(handles=None))]
        super().__init__(prep.deg_pad.device, _steps(prep, plan, self.st), eager,
                         A.loop_nest(1), self.st.handles, self.st.labels)


def _launch_loop(sym: Graph, prep: WccPrep, plan: Optional[SlabPlan], budgets: tuple):
    """The device loop's run up to its last step, nothing read back on a
    card: (labels, ctl, the graph or None, the host loop's reads of ctl).
    On a card one graph launch (the graph memoized on ``sym``); on the CPU,
    or inside ``kernels.plain_torch()``, the host loop."""
    n = sym.n
    itermax = min(n, INT32_INF)
    if kernels.use_kernel(prep.deg_pad):
        key = ("wcc_loop", str(prep.deg_pad.device), plan is not None, budgets)
        loop = sym.memo.get(key)
        if loop is None:
            loop = sym.memo[key] = _LoopGraph(prep, plan, n, budgets)
        loop.st.itermax[0] = itermax
        return loop.launch("wcc.graph"), loop.st.ctl, loop, 0
    st = _loop_state(prep, plan, n, budgets, handles=False)
    st.itermax[0] = itermax
    reads = device_loop.run_host(A.loop_nest(1), dict(_steps(prep, plan, st)),
                                 lambda j: bool(st.ctl[A.CTL_COND + j]), RANGES)
    return st.labels, st.ctl, None, reads


# how the last wcc_adaptive_run went: its derives, outer iterations, driver
# ("graph" or "host loop") and the host loop's reads of a condition in ctl
last_run: dict = {}


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
    the edge-stream impl), read from the control words in one read after
    the run; ``last_run`` says how it went."""
    sym = graph.symmetrized()
    prep = wcc_prep(sym, cfg.device)
    k_cap = int(cfg.wcc_frontier_rows or 1 << 16)
    e_cap = int(cfg.wcc_frontier_edges or 1 << 18)
    plan = plan_gathers = None
    if cfg.wcc_impl in ("auto", "slab"):
        plan = wcc_slab_plan(sym, cfg.device)
        plan_gathers = plan_gather_count(plan)
    loop, reads = None, 0
    if sym.n == 0:  # iteration 0 changes nothing
        labels, ctl = prep.deg_pad[:0].clone(), [0] * A.ctl_words(1)
        ctl[A.CTL_IT] = ctl[A.CTL_NF] = 1
    else:
        labels, ctl_t, loop, reads = _launch_loop(sym, prep, plan, ((k_cap, e_cap),))
        ctl = ctl_t.tolist()  # the run's one read
        if loop is not None:
            loop.account(A.loop_runs(ctl, 1))
    niter, nfull = ctl[A.CTL_IT], ctl[A.CTL_NF]
    last_run.clear()
    last_run.update(derives=ctl[A.CTL_DERIVES], outer_iterations=ctl[A.CTL_OUTERS],
                    driver="host loop" if loop is None else "graph", condition_reads=reads)
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
        labels, niter = wcc_device_run(graph, cfg)
    else:
        labels, niter = wcc_adaptive_run(graph, cfg)
    comp = graph.mapping[labels.cpu().numpy()]
    return AlgorithmResult("wcc", comp, iterations=int(niter))
