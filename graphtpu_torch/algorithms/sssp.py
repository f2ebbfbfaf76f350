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
  frontier engine (kernels K18, K5) and K8's in-place mode, which lowers
  dist and marks the vertices it lowered. Heavier rounds relax every edge
  (kernel K7 in min-plus mode) and K22 (``sssp_apply``) takes the minimum
  and the changed mask. Every round ends with K22, which counts the changed
  vertices and their out-degrees and routes the next round (the JAX
  kernel's ``chosen``, conditions and counters), then K14 compacts the
  changed mask into the next ids. JAX runs the phases as nested
  while_loops in one program (``_sssp_adaptive_kernel``); here the state
  lives in preallocated buffers and a control vector, and the rounds are
  step functions of hand-kernel launches that read nothing back: on a card
  one CUDA graph with while nodes (ops/device_loop.py) and one read of the
  control words after it, on the CPU and inside ``kernels.plain_torch()``
  the host loop of the same nest. The counts of full and tier rounds are
  the JAX kernel's.
* "device": full rounds only (``_sssp_kernel``).
* "delta": bucketed delta-stepping, the reference's own method
  (LAGr_SingleSourceShortestPath with Delta = 2.5, sssp.cpp:70-78), on the
  same kernels (``sssp_delta_run``).
* "hybrid": rounds whose changed vertices' out-edges are at most
  ``sssp_active_threshold`` of the edges relax on the host over the push
  CSR (numpy, ``np.minimum.at``); heavier rounds run dense sweeps on K7
  (``sssp_hybrid_run``).

Every candidate is the same addition dist[u] + w in both packages and min
is exact in any order, so the distances equal the JAX package's bit for
bit in the same dtype.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from graphtpu_torch.algorithms.common import AlgorithmResult, float_dtype, register
from graphtpu_torch.core.graph import Graph, frontier_edge_positions
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import device_loop, kernels
from graphtpu_torch.ops.frontier import compact, expand, mask_status, relax_min, relax_min_into
from graphtpu_torch.ops.spmv import PullCSR, csr_pull_reduce, int32_tensor, pull_csr
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig

# "dense" is the JAX package's name of the dense kernel on one device:
# it runs as "device"
IMPLS = ("auto", "adaptive", "device", "dense", "hybrid", "delta")


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


# The control words of the device loop (int32, csrc/sssp_loop.cu SCTL_*): the
# changed vertices' count and out-degree sum (acnt, ae), the rounds run and
# their limit (n); from SCTL_COND the conditions (outer, one a tier, full),
# then the rounds run by phase (one a tier, full).
SCTL_ACNT, SCTL_AE, SCTL_IT, SCTL_ITERMAX, SCTL_COND = range(5)
# K22's stages: iteration 0's derive, after a full round, after a round of
# tier i (STAGE_TIER + i)
STAGE_INIT, STAGE_FULL, STAGE_TIER = range(3)


def ctl_words(t: int) -> int:
    """Words of ``ctl`` for t tiers."""
    return SCTL_COND + (t + 2) + (t + 1)


def loop_nest(t: int) -> tuple:
    """The JAX kernel's nested loops over the steps of ``_steps`` (t tiers),
    conditions indexed from SCTL_COND: init, then WHILE outer { WHILE tier 0
    {tier0}; ... WHILE full {full} }."""
    return ("init", ("while", 0, (*(("while", 1 + i, (f"tier{i}",)) for i in range(t)),
                                  ("while", t + 1, ("full",)))))


def loop_runs(ctl: list, t: int) -> dict:
    """Each step's executions in a run, from the run's control words."""
    counts = ctl[SCTL_COND + t + 2:]
    return {"init": 1, "full": counts[t], **{f"tier{i}": counts[i] for i in range(t)}}


def sssp_apply_plain(dist, relaxed, mask, deg_pad, source, ctl, tiers, stage: int,
                     itermax: int) -> None:
    """K22's plain PyTorch version, the JAX kernel's formulation: the stage's
    dist and mask (fmask0; minimum(dist, relaxed) and new < dist; the mask as
    it is), ``mask_status``, then ``chosen`` and the phase loops'
    conditions and counters."""
    n, t = dist.shape[0], tiers.shape[0]
    if stage == STAGE_INIT:
        src = source.to(dist.device).long()
        dist.fill_(float("inf")).index_fill_(0, src, 0.0)
        mask.zero_().index_fill_(0, src, True)
    elif stage == STAGE_FULL:
        new = torch.minimum(dist, relaxed)
        torch.lt(new, dist, out=mask)
        dist.copy_(new)
    acnt = mask.sum().clamp(max=INT32_INF)
    ae = torch.where(mask, deg_pad[:n], 0).sum().clamp(max=INT32_INF)
    ctl[SCTL_ACNT], ctl[SCTL_AE] = acnt, ae
    cond, counts = ctl[SCTL_COND:SCTL_COND + t + 2], ctl[SCTL_COND + t + 2:]
    if stage == STAGE_INIT:
        ctl[SCTL_IT], ctl[SCTL_ITERMAX] = 0, itermax
        counts.zero_()
    else:
        ctl[SCTL_IT] += 1
        counts[t if stage == STAGE_FULL else stage - STAGE_TIER] += 1
    live = (acnt > 0) & (ctl[SCTL_IT] < ctl[SCTL_ITERMAX])
    fits = (acnt <= tiers[:, 0]) & (ae <= tiers[:, 1])
    chosen = torch.where(fits, torch.arange(t, device=ctl.device), t).min()
    cond[0] = live
    cond[1:] = live & (chosen == torch.arange(t + 1, device=ctl.device))


def sssp_apply(dist, relaxed, mask, deg_pad, source, ctl, tiers, stage: int, itermax: int,
               handles=None) -> None:
    """K22 wrapper, every round's status and routing: at STAGE_INIT dist :=
    +inf but 0 at the source (``source``, an int32 [1] host tensor, pinned on
    a card, which the kernel reads) and ``mask`` the source alone; at
    STAGE_FULL dist := min(dist, relaxed) and ``mask`` := relaxed < dist;
    after a tier round ``mask`` as K8's in-place mode left it. Then in
    ``ctl`` the marked count and out-degree sum (``deg_pad`` [n+1] int32;
    clamped to int32), the rounds run (it; by phase), and every condition:
    live = acnt > 0 and it < itermax; outer; tier i when i is the smallest
    tier whose (rows, edges) budgets (``tiers`` [T, 2] int32 on the device)
    hold (acnt, ae); full when none does; and, given the graph's ``handles``
    (int64 [T + 2] on the device), into the graph's conditional nodes. One
    launch, nothing read back."""
    n, t = dist.shape[0], tiers.shape[0]
    if dist.dtype not in (torch.float32, torch.float64) or mask.dtype != torch.bool or \
            any(x.dtype != torch.int32 for x in (deg_pad, ctl, tiers, source)):
        raise TypeError("sssp_apply: float dist, bool mask, int32 deg_pad, ctl, tiers, source")
    if (relaxed is None) != (stage != STAGE_FULL) or \
            (relaxed is not None and (relaxed.dtype != dist.dtype or relaxed.shape != dist.shape)):
        raise ValueError("sssp_apply: relaxed, of dist's dtype and length, at STAGE_FULL only")
    if mask.shape != dist.shape or deg_pad.shape[0] < n or ctl.shape != (ctl_words(t),) or \
            not STAGE_INIT <= stage < STAGE_TIER + t or source.device.type != "cpu":
        raise ValueError(f"sssp_apply: shapes, stage {stage} for {t} tiers, or source not on "
                         "the host")
    ts = [x for x in (dist, relaxed, mask, deg_pad, ctl, tiers) if x is not None]
    if any(x.device != dist.device for x in ts) or not all(x.is_contiguous() for x in ts):
        raise ValueError("sssp_apply: inputs must be contiguous, on one device")
    if not kernels.use_kernel(dist):
        sssp_apply_plain(dist, relaxed, mask, deg_pad, source, ctl, tiers, stage, itermax)
        return
    if not source.is_pinned():
        raise ValueError("sssp_apply: on a card source must be pinned, the kernel reads it")
    acc = torch.empty(3, dtype=torch.int64, device=dist.device)
    kernels.launch("sssp_apply", dist.device, dist.data_ptr(),
                   None if relaxed is None else relaxed.data_ptr(), mask.data_ptr(), n,
                   deg_pad.data_ptr(), source.data_ptr(), acc.data_ptr(), ctl.data_ptr(),
                   tiers.data_ptr(), t, stage, itermax, 1 if dist.dtype == torch.float64 else 0,
                   None if handles is None else handles.data_ptr(),
                   8 * kernels.sm_count(dist.device))


class LoopState(NamedTuple):
    """The SSSP device loop's state, allocated once (per graph, dtype and
    ladder on a card)."""

    dist: torch.Tensor        # [n] float32 or float64
    mask: torch.Tensor        # [n] bool: the last round's changed vertices
    ids: torch.Tensor         # [k_max] int32: the changed vertices, ascending, padded with n
    ctl: torch.Tensor         # [ctl_words(T)] int32 control words (SCTL_*)
    tiers: torch.Tensor       # [T, 2] int32 (rows, edges) budgets, on the device
    source: torch.Tensor      # [1] int32 on the host, pinned on a card
    handles: Optional[torch.Tensor]  # [T + 2] int64 conditional handles, or None
    budgets: tuple            # the tiers as Python ints


def _loop_state(prep: SsspPrep, n: int, budgets: tuple, handles: bool) -> LoopState:
    dev = prep.deg_pad.device
    i32 = dict(dtype=torch.int32, device=dev)
    t = len(budgets)
    return LoopState(
        torch.zeros(n, dtype=prep.push_w.dtype, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev), torch.full((budgets[-1][0],), n, **i32),
        torch.zeros(ctl_words(t), **i32), torch.tensor(budgets, **i32),
        torch.zeros(1, dtype=torch.int32, pin_memory=dev.type == "cuda"),
        torch.zeros(t + 2, dtype=torch.int64, device=dev) if handles else None, budgets,
    )


# The step functions: hand-kernel launches and memsets only, no host read.
# K22 routes each round; K14 then compacts its changed mask into the ids.

def _apply(prep: SsspPrep, st: LoopState, stage: int, relaxed=None) -> None:
    sssp_apply(st.dist, relaxed, st.mask, prep.deg_pad, st.source, st.ctl, st.tiers, stage,
               min(st.dist.shape[0], INT32_INF), st.handles)
    compact(st.mask, st.budgets[-1][0], out=st.ids)


def _step_init(prep: SsspPrep, st: LoopState) -> None:
    """The source's distance and its derive: acnt = 1, it = 0."""
    _apply(prep, st, STAGE_INIT)


def _step_full(prep: SsspPrep, st: LoopState) -> None:
    """A full round: every edge relaxed on K7 (min_plus), then K22."""
    relaxed = csr_pull_reduce("min_plus", st.dist, prep.pull.src, prep.pull.indptr, prep.pull_w)
    _apply(prep, st, STAGE_FULL, relaxed)


def _step_tier(prep: SsspPrep, st: LoopState, i: int) -> None:
    """A round of tier i: the changed vertices' out-edges expanded in e_i
    slots and relaxed in place (K8), marking the vertices lowered, then K22."""
    k_i, e_i = st.budgets[i]
    ids = st.ids[:k_i]
    exp = expand(ids, prep.deg_pad, prep.push_indptr, prep.push_dst, e_i, with_row_ids=False)
    relax_min_into(st.dist, ids, exp, prep.push_w, st.mask)
    _apply(prep, st, STAGE_TIER + i)


def _steps(prep: SsspPrep, st: LoopState):
    """(name, step) of every step kind, in the graph's order."""
    return ([("init", functools.partial(_step_init, prep, st)),
             ("full", functools.partial(_step_full, prep, st))]
            + [(f"tier{i}", functools.partial(_step_tier, prep, st, i))
               for i in range(len(st.budgets))])


class _LoopGraph(device_loop.LoopGraph):
    """The SSSP device loop as one CUDA graph, for one prep (graph, dtype)
    and ladder: init -> WHILE outer { WHILE tier 0 {tier0}; ...; WHILE full
    {full} } -> copy of dist. A run writes the source into pinned host
    memory (init's K22 reads it) and launches the graph."""

    def __init__(self, prep: SsspPrep, n: int, budgets: tuple):
        self.st = _loop_state(prep, n, budgets, handles=True)
        eager = [step for _, step in _steps(prep, self.st._replace(handles=None))]
        super().__init__(prep.deg_pad.device, _steps(prep, self.st), eager,
                         loop_nest(len(budgets)), self.st.handles, self.st.dist)


def _launch_loop(graph: Graph, prep: SsspPrep, source: int, budgets: tuple):
    """The device loop's run up to its last step, nothing read back on a
    card: (dist, ctl, the graph or None, the host loop's reads of ctl). On
    a card one graph launch (the graph memoized on ``graph``); on the CPU,
    or inside ``kernels.plain_torch()``, the host loop."""
    if kernels.use_kernel(prep.deg_pad):
        key = ("sssp_loop", str(prep.push_w.dtype), str(prep.deg_pad.device), budgets)
        loop = graph.memo.get(key)
        if loop is None:
            loop = graph.memo[key] = _LoopGraph(prep, graph.n, budgets)
        loop.st.source[0] = source
        return loop.launch("sssp.graph"), loop.st.ctl, loop, 0
    st = _loop_state(prep, graph.n, budgets, handles=False)
    st.source[0] = source
    t = len(budgets)
    ranges = {"full": "sssp.full_step", **{f"tier{i}": "sssp.tier_step" for i in range(t)}}
    reads = device_loop.run_host(loop_nest(t), dict(_steps(prep, st)),
                                 lambda j: bool(st.ctl[SCTL_COND + j]), ranges)
    return st.dist, st.ctl, None, reads


# how the last sssp_adaptive_run went: its driver ("graph" or "host loop")
# and the host loop's reads of a condition in ctl
last_run: dict = {}


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
    full_steps, active_steps, tier_steps, tiers, e_cap and k_cap, read from
    the control words in one read after the run; ``last_run`` says how it
    went."""
    prep = sssp_prep(graph, dtype, cfg.device)
    k_cap = int(cfg.sssp_frontier_rows or 1 << 16)
    e_cap = int(cfg.sssp_frontier_edges or 1 << 18)
    tiers = tuple((int(k), int(e)) for k, e in sssp_tiers(k_cap, e_cap, cfg))
    dist, ctl_t, loop, reads = _launch_loop(graph, prep, src_dense, tiers)
    ctl = ctl_t.tolist()  # the run's one read
    if loop is not None:
        loop.account(loop_runs(ctl, len(tiers)))
    niter, c = ctl[SCTL_IT], ctl[SCTL_COND + len(tiers) + 2:]
    last_run.clear()
    last_run.update(driver="host loop" if loop is None else "graph", condition_reads=reads)
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


def sssp_hybrid_run(graph: Graph, src_dense: int, cfg: PlatformConfig, dtype=torch.float32):
    """Changed-set Bellman-Ford: rounds whose changed vertices' out-edges
    are at most ``sssp_active_threshold`` of the edges relax on the host
    over the push CSR; heavier rounds run dense sweeps on cfg.device.
    Returns (numpy distances in ``dtype``, rounds), as the JAX package's
    does."""
    n, m = graph.n, graph.nnz
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    indptr_h, dst_h = graph.indptr, graph.dst
    w_h = graph.w.astype(np_dtype)
    tau = cfg.sssp_active_threshold * max(m, 1)  # 0 runs every round with an edge dense

    dist = np.full(n, np.inf, dtype=np_dtype)
    dist[src_dense] = 0.0
    changed = np.array([src_dense], dtype=np.int64)
    rounds = 0
    while changed.size:
        fe = int((indptr_h[changed + 1] - indptr_h[changed]).sum())
        if fe <= tau:
            with record_function("sssp.host_step"):
                # synchronous reads: every candidate before any update
                pos, rows_rep = frontier_edge_positions(indptr_h, changed)
                cand = dst_h[pos]
                newd = dist[rows_rep] + w_h[pos]
                improved = newd < dist[cand]
                cand, newd = cand[improved], newd[improved]
                np.minimum.at(dist, cand, newd)
                mask = np.zeros(n, dtype=bool)
                mask[cand] = True
                changed = np.nonzero(mask)[0]
            rounds += 1
            continue
        prep = sssp_prep(graph, dtype, cfg.device)
        dist_d = torch.from_numpy(dist).to(cfg.device)
        while True:
            with record_function("sssp.full_step"):
                dist_d, changed_d = _sssp_dense_step(dist_d, prep.pull, prep.pull_w)
                changed = np.nonzero(changed_d.cpu().numpy())[0]
            rounds += 1
            if changed.size == 0:
                break
            fe = int((indptr_h[changed + 1] - indptr_h[changed]).sum())
            if fe <= tau:
                break
        dist = dist_d.cpu().numpy()
    return dist, rounds


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
    dtype = float_dtype(cfg)
    src_dense = graph.dense_source(params.source_vertex)
    if impl == "hybrid":
        dist, niter = sssp_hybrid_run(graph, src_dense, cfg, dtype)
        return AlgorithmResult("sssp", dist.astype(np.float64), iterations=int(niter))
    if impl in ("device", "dense"):
        dist, niter = _sssp_kernel(sssp_prep(graph, dtype, cfg.device), src_dense, graph.n,
                                   dtype)
    elif impl == "delta":
        dist, niter = sssp_delta_run(graph, src_dense, cfg, dtype)
    else:
        dist, niter = sssp_adaptive_run(graph, src_dense, cfg, dtype)
    return AlgorithmResult("sssp", dist.cpu().numpy().astype(np.float64), iterations=int(niter))
