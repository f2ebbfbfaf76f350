"""Degree-bucketed min-mode label selection, the CDLP hot path
(counterpart of graphtpu/ops/minmode.py).

Kernel K2 (``slab_minmode``) picks each slab row's smallest label among
its most frequent neighbour labels (LAGraph_cdlp.c:40-45), gathering the
labels itself. It takes all buckets of a plan at once
(``slab_minmode_buckets``): one launch for the buckets up to SMALL_WIDTH
wide (a sort in registers) and one for the wider ones (counting in
shared-memory hash tables), writing straight into the step's result
buffer. Rows heavier than the largest bucket go through kernel K12
(``stream_minmode``, kernel ``segment_minmode``): a warp per short segment,
a warp or a block with a shared-memory table per medium one, and a long
one's chunks counted into (label, count) pairs, then hash bins of the
pairs, a block each, with no host read; its plain version is a pair sort,
a run-length pass and a per-segment max in torch ops. One K1 gather by the
inverse permutation assembles the result.

Iteration 0 needs no label gather, since labels are the vertex ids: on
duplicate-free incidence (undirected graphs) the mode is the minimum
neighbour id (K2 "min", and K7 ``min_i32`` over the heavy rows); otherwise
K2 and K12 run on the stored ids ("identity"). The iterations stop at a
fixed point (LAGraph_cdlp.c:328-332) or at itermax: iteration 0 and the
WHILE of ``cdlp_step``, the JAX package's ``_cdlp_slab_kernel``, as one
fixed-point device loop (ops/fixed_point.py, K25 comparing the labels), on
a card one CUDA graph; under iteration timing the host steps each
iteration, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import fixed_point, kernels
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.spmv import csr_pull_reduce
from graphtpu_torch.ops.slab import (
    BucketTable, SlabPlan, assemble, build_slab_plan, check_result_buffer, fill_buckets,
    result_buffer,
)

_M31 = (1 << 31) - 1
MODES = {"gather": 0, "identity": 1, "min": 2}
MAX_SLAB_WIDTH = 4096  # K2's widest row: a 6144-entry table in 48 KB of shared memory
SMALL_WIDTH = 32       # GT_SMALL_W of csrc/slab_minmode.cu: up to here K2 sorts in registers
# K12's classes by segment length (csrc/segment_minmode.cu): up to
# K12_WARP_LEN a warp in registers; up to K12_MED_LEN a warp with a shared
# table of its own (at most 512); up to K12_SMEM_LEN a 256-thread block's
# shared table (at most 4,096); longer ones in chunks of 4,096 entries,
# each counted into (label, count) pairs, the pairs then counted by hash
# bins of at most 4,096 pairs, a block each. K12_MED_LEN and K12_SMEM_LEN
# were set from the chip's times of each class alone (tools/minmode_times.py
# --classes; PERF.md §6): on an H100 80GB HBM3 at 700 W, over 2^24 entries
# a length, a warp's table beat a block's at every length up to 512 (0.489
# against 0.597 ms at 512), a block's beat bins at every length up to 4,096
# (0.534 against 1.201 ms at 4,096). K12 takes the two bounds as launch
# arguments only so that that tool can time one class under each unit;
# every call in the package passes these values.
K12_WARP_LEN = 32
K12_MED_LEN = 512
K12_SMEM_LEN = 4096


def _rowwise_minmode_plain(lab: torch.Tensor) -> torch.Tensor:
    """Min-mode along axis 0 of a [W, R] label matrix; INT32_INF = pad."""
    s = torch.sort(lab, dim=0).values
    col = torch.arange(s.shape[0], device=s.device).unsqueeze(1)
    ones = torch.ones((1, s.shape[1]), dtype=torch.bool, device=s.device)
    diff = s[1:] != s[:-1]
    is_start = torch.cat([ones, diff])
    is_last = torch.cat([diff, ones])
    run_start = torch.cummax(torch.where(is_start, col, -1), dim=0).values
    valid_run = is_last & (s != INT32_INF)
    counts = torch.where(valid_run, col - run_start + 1, 0)
    max_count = counts.max(dim=0, keepdim=True).values
    cand = torch.where(valid_run & (counts == max_count), s, INT32_INF)
    return cand.min(dim=0).values


def slab_minmode_plain(slab: torch.Tensor, mode: str, bound: int,
                       labels: torch.Tensor | None = None) -> torch.Tensor:
    """K2's plain PyTorch version."""
    valid = (slab >= 0) & (slab < bound)
    if mode == "gather":
        lab = labels.index_select(0, torch.where(valid, slab, 0).reshape(-1)).reshape(slab.shape)
        lab = torch.where(valid, lab, INT32_INF)
    else:
        lab = torch.where(valid, slab, INT32_INF)
    if mode == "min":
        return lab.min(dim=0).values
    return _rowwise_minmode_plain(lab)


def _check_minmode(mode: str, bound: int, labels, device) -> None:
    if mode not in MODES:
        raise ValueError(f"slab_minmode: unknown mode {mode!r}")
    if mode == "gather":
        if labels is None or labels.dtype != torch.int32 or labels.dim() != 1:
            raise TypeError("slab_minmode: gather mode needs 1-D int32 labels")
        if labels.device != device or not labels.is_contiguous():
            raise ValueError("slab_minmode: labels must be contiguous, on the slab's device")
        if bound != labels.shape[0]:
            raise ValueError("slab_minmode: gather mode needs bound == len(labels)")


def _check_slab(slab: torch.Tensor) -> None:
    if slab.dtype != torch.int32 or slab.dim() != 2 or not slab.is_contiguous():
        raise TypeError("slab_minmode: slab must be a contiguous 2-D int32 tensor")
    if not 1 <= slab.shape[0] <= MAX_SLAB_WIDTH:
        raise ValueError(
            f"slab_minmode: width {slab.shape[0]} outside [1, {MAX_SLAB_WIDTH}]"
        )


def _launch_minmode(table: BucketTable, mode: str, bound: int, labels, out) -> None:
    """K2 over a table's buckets into ``out``: the narrow buckets in one
    launch, the wide ones, from their row-major copies, in another (each
    at most MAX_TABLE_BUCKETS)."""
    lab_ptr = labels.data_ptr() if mode == "gather" else None
    for lo, hi, row_major in ((1, SMALL_WIDTH, False), (SMALL_WIDTH + 1, None, True)):
        for desc, count in table.launches(lo, hi, row_major):
            kernels.launch("slab_minmode", out.device, desc, count, lab_ptr,
                           out.data_ptr(), bound, MODES[mode])


def slab_minmode(slab: torch.Tensor, mode: str, bound: int,
                 labels: torch.Tensor | None = None) -> torch.Tensor:
    """K2 wrapper: per column of an int32 [W, R] slab (-1 = pad, ids
    outside [0, bound) count as pad), the smallest most frequent label:
    of ``labels[slab]`` ("gather", bound = len(labels)), of the ids
    themselves ("identity"), or just the minimum id ("min"). INT32_INF
    for a column without entries. W must lie in [1, 4096]."""
    _check_minmode(mode, bound, labels, slab.device)
    _check_slab(slab)
    if not kernels.use_kernel(slab):
        return slab_minmode_plain(slab, mode, bound, labels)
    out = torch.empty(slab.shape[1], dtype=torch.int32, device=slab.device)
    _launch_minmode(BucketTable([slab]), mode, bound, labels, out)
    return out


def slab_minmode_buckets(plan: SlabPlan, mode: str, bound: int,
                         labels: torch.Tensor | None, out: torch.Tensor) -> None:
    """K2 over every bucket of ``plan``: bucket k's results go to
    ``out[offsets[k] : offsets[k] + R_k]`` (``plan.table``), at most two
    launches in all. ``out`` is a contiguous int32 result buffer on the
    plan's device."""
    _check_minmode(mode, bound, labels, out.device)
    check_result_buffer("slab_minmode_buckets", out, torch.int32, plan)
    for bucket in plan.slabs:
        _check_slab(bucket.slab)
    if not kernels.use_kernel(out):
        fill_buckets(plan, out, lambda b: slab_minmode_plain(b.slab, mode, bound, labels))
        return
    _launch_minmode(plan.table, mode, bound, labels, out)


def _rowwise_minmode(lab: torch.Tensor) -> torch.Tensor:
    """Min-mode along axis 0 of a [W, R] matrix of non-negative labels,
    INT32_INF = pad (K2 on the labels as ids)."""
    return slab_minmode(
        torch.where(lab == INT32_INF, -1, lab).contiguous(), "identity", INT32_INF
    )


def _slab_minmode(labels: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """Per-row smallest-most-frequent label over a transposed slab [W, R]."""
    return slab_minmode(slab, "gather", labels.shape[0], labels)


def stream_minmode_plain(labels, centers, neigh, indptr, identity=False):
    """K12's plain PyTorch version: min-mode per segment of a center-sorted
    incidence stream.

    ``centers`` are ascending local segment ids [m] in [0, H] (H: the
    entry joins no segment), ``neigh`` global vertex ids [m], ``indptr``
    [H+1] the segment starts. Returns the winner label per segment [H]
    (INT32_INF for an empty one).
    ``identity=True`` takes the labels to be the ids (iteration 0). An id
    outside [0, len(labels)) in gather mode, and a label that is negative
    or INT32_INF, is a pad: it joins no segment's count.

    One sort of the (center << 31 | label) int64 keys makes each run of
    equal (center, label) contiguous; the runs and their lengths come from
    one run-length pass, and each segment keeps the run with the largest
    (count << 31 | INT32_MAX - label), i.e. the longest run and, among
    equals, the smallest label. Counts stay below 2^32, so the key is
    exact for every graph size: one method, no fast path."""
    h = indptr.shape[0] - 1
    if identity:
        lab = neigh
        ok = (lab >= 0) & (lab != INT32_INF)
    else:
        ok = (neigh >= 0) & (neigh < labels.shape[0])
        lab = labels.index_select(0, torch.where(ok, neigh, 0))
        ok &= (lab >= 0) & (lab != INT32_INF)
    # the pads form segment H, which is dropped
    seg = torch.where(ok, centers, h).to(torch.int64)
    key = torch.sort((seg << 31) | torch.where(ok, lab, 0).to(torch.int64)).values
    runs, counts = torch.unique_consecutive(key, return_counts=True)
    win = (counts << 31) | (_M31 - (runs & _M31))
    best = torch.zeros(h + 1, dtype=torch.int64, device=key.device)
    best.scatter_reduce_(0, runs >> 31, win, "amax")
    return (_M31 - (best[:h] & _M31)).to(torch.int32)


def _check_stream(labels, centers, neigh, indptr, identity) -> None:
    for name, t in (("centers", centers), ("neigh", neigh), ("indptr", indptr)):
        if t is not None and (t.dtype != torch.int32 or t.dim() != 1):
            raise TypeError(f"stream_minmode: {name} must be a 1-D int32 tensor")
    if (centers is not None and centers.shape != neigh.shape) or indptr.shape[0] < 1:
        raise ValueError("stream_minmode: need centers and neigh of one length and H+1 >= 1 "
                         "indptr entries")
    if not identity and (labels is None or labels.dtype != torch.int32 or labels.dim() != 1):
        raise TypeError("stream_minmode: gather mode needs 1-D int32 labels")
    on = [neigh, indptr] + ([] if identity else [labels])
    if any(t.device != neigh.device for t in on + ([] if centers is None else [centers])):
        raise ValueError("stream_minmode: inputs must lie on one device")
    if kernels.use_kernel(neigh):
        if not all(t.is_contiguous() for t in on):
            raise ValueError("stream_minmode: neigh, indptr and labels must be contiguous")
        m = neigh.shape[0]
        if m + m // 2 >= 1 << 31:
            raise ValueError(f"stream_minmode: a stream of {m} entries is too long for K12")


def k12_launches(h: int, m: int) -> int:
    """K12's launches in one call on a stream of H segments over m entries:
    the warp kernel, and the grid kernel where a segment can be longer than
    a warp's."""
    return 0 if h == 0 else 1 + (m > K12_WARP_LEN)


# K12's work items, as its scratch header counts them (k12_work)
K12_WORK = ("medium", "block", "long", "bins", "long_chunks", "fallback_chunks",
            "fallback_bins")


def _k12_launch(labels, neigh, indptr, identity):
    """(result, scratch) of K12's launches on a CUDA stream."""
    dev, h, m = neigh.device, indptr.shape[0] - 1, neigh.shape[0]
    out = torch.empty(h, dtype=torch.int32, device=dev)
    ints = kernels.query("segment_minmode_scratch_ints", h, m, K12_SMEM_LEN)
    scratch = torch.empty(ints, dtype=torch.int32, device=dev)
    args = (None if identity else labels.data_ptr(), neigh.data_ptr(), indptr.data_ptr(), h,
            m, 0 if identity else labels.shape[0], out.data_ptr(), scratch.data_ptr(), ints,
            K12_MED_LEN, K12_SMEM_LEN)
    for name in ("warp", "grid")[:k12_launches(h, m)]:
        kernels.launch(f"segment_minmode_{name}", dev, *args, counter="segment_minmode")
    return out, scratch


def k12_work(scratch) -> dict:
    """The work items of the K12 call that left ``scratch`` (``K12_WORK``),
    read back to the host: for measuring scripts."""
    return dict(zip(K12_WORK, scratch[:len(K12_WORK)].tolist()))


def stream_minmode(labels, centers, neigh, indptr, identity=False):
    """K12 wrapper: min-mode per segment s of ``indptr`` [H+1] (int32
    starts over ``neigh`` [m], ascending in [0, m]) of ``labels[neigh]``, or
    of the ids themselves with ``identity=True``; INT32_INF for an empty
    segment, [H] int32. Entries past ``indptr[-1]`` join no segment.
    ``centers`` [m], the segment id of each entry, is what only the plain
    version reads: in every caller it is ``repeat_interleave(arange(H),
    diff(indptr))`` followed by H for each entry past ``indptr[-1]``, so
    the kernel, which takes the segments from ``indptr``, computes the same
    function; None makes the plain version build them so from ``indptr``
    (CDLP auto's tier step passes None). Pads as in
    ``stream_minmode_plain``. On a CUDA tensor no value is read back to the
    host; a stream of m entries with m + m/2 >= 2^31 raises there (K12's
    indices are int32)."""
    _check_stream(labels, centers, neigh, indptr, identity)
    if not kernels.use_kernel(neigh):
        if centers is None:
            centers = _centers_of(indptr, neigh.shape[0])
        return stream_minmode_plain(labels, centers, neigh, indptr, identity)
    return _k12_launch(labels, neigh, indptr, identity)[0]


def _centers_of(indptr, m: int):
    """The segment id of each of m entries under the starts ``indptr``
    [H+1], H for an entry outside [indptr[0], indptr[-1])."""
    h = indptr.shape[0] - 1
    pos = torch.arange(m, dtype=indptr.dtype, device=indptr.device)
    seg = torch.searchsorted(indptr, pos, right=True, out_int32=True) - 1
    return torch.where((seg < 0) | (pos >= indptr[-1]), h, seg)


def _heavy_minmode(labels, plan: SlabPlan):
    return stream_minmode(labels, plan.heavy_centers, plan.heavy_neigh, plan.heavy_indptr)


def _rest(plan: SlabPlan, labels):
    return table_gather(labels, plan.rest_rows) if plan.rest_rows is not None else None


def _iter0_minmode(plan: SlabPlan, labels0: torch.Tensor) -> torch.Tensor:
    """Iteration 0 on duplicate-free incidence: every neighbour label is
    distinct, so the min-mode is the minimum neighbour id."""
    buf = result_buffer(plan, torch.int32)
    slab_minmode_buckets(plan, "min", labels0.shape[0], None, buf)
    heavy = None
    if plan.heavy_rows is not None:  # each heavy row's minimum id, on K7
        heavy = csr_pull_reduce("min_i32", None, plan.heavy_neigh, plan.heavy_indptr)
    return assemble(plan, buf, heavy, _rest(plan, labels0))


def _iter0_mode(plan: SlabPlan, labels0: torch.Tensor) -> torch.Tensor:
    """Iteration 0 on incidence with duplicates (directed graphs count a
    bidirectional neighbour twice, LAGraph_cdlp.c:47-50): labels are the
    ids, so the full min-mode runs on the stored ids, without a gather."""
    buf = result_buffer(plan, torch.int32)
    slab_minmode_buckets(plan, "identity", labels0.shape[0], None, buf)
    heavy = None
    if plan.heavy_rows is not None:
        heavy = stream_minmode(
            None, plan.heavy_centers, plan.heavy_neigh, plan.heavy_indptr, identity=True
        )
    return assemble(plan, buf, heavy, _rest(plan, labels0))


def cdlp_step(labels: torch.Tensor, plan: SlabPlan) -> torch.Tensor:
    """One synchronous CDLP iteration: new labels for every vertex."""
    buf = result_buffer(plan, torch.int32)
    slab_minmode_buckets(plan, "gather", labels.shape[0], labels, buf)
    heavy = _heavy_minmode(labels, plan) if plan.heavy_rows is not None else None
    return assemble(plan, buf, heavy, _rest(plan, labels))


def memoized_cdlp_plan(graph, centers, neigh, deg, buckets, device) -> SlabPlan:
    """Slab plan of the CDLP incidence on ``device``, memoized on the Graph
    and keyed by the bucket choice and the device."""
    key = ("cdlp_slab_plan", None if buckets is None else tuple(buckets), str(device))
    plan = graph.memo.get(key)
    if plan is None:
        plan = build_slab_plan(
            centers, neigh, np.asarray(deg, np.int64), graph.n, buckets, device=device
        )
        graph.memo[key] = plan
    return plan


class SlabState(NamedTuple):
    """Slab CDLP's loop state, allocated once (per plan on a card)."""

    labels: torch.Tensor  # [n] int32
    iota: torch.Tensor    # [n] int32: the identity labels iteration 0 reads
    fp: fixed_point.Control


def _slab_steps(plan: SlabPlan, directed: bool, st: SlabState):
    """(name, step) of slab CDLP's loop: init (iteration 0, gather-free: the
    stored-id mode on directed incidence, the minimum id otherwise, copied
    into the labels; it = 1) and a step (``cdlp_step``, then K25 compares the
    new labels with the old and takes them)."""

    def init():
        st.labels.copy_(_iter0_mode(plan, st.iota) if directed else _iter0_minmode(plan, st.iota))
        fixed_point.fixed_point_route(st.fp, fixed_point.STAGE_INIT, start=1)

    def step():
        new = cdlp_step(st.labels, plan)
        fixed_point.fixed_point_route(st.fp, fixed_point.STAGE_STEP, old=st.labels, new=new)

    return [("init", init), ("step", step)]


# how the last cdlp_slab_run went: its driver ("graph", "host loop" or
# "iteration timing") and the host loop's reads of the condition
last_run: dict = {}


def _launch_slab(graph, plan: SlabPlan, buckets, itermax: int):
    """Slab CDLP's loop run up to its last step (``fixed_point.launch``), the
    graph memoized on ``graph`` by buckets, device and directedness:
    (labels, ctl, the graph or None, the host loop's reads)."""
    n, device, directed = graph.n, plan.inv_perm.device, bool(graph.directed)

    def make_state(handles):
        i32 = dict(dtype=torch.int32, device=device)
        return SlabState(torch.zeros(n, **i32), torch.arange(n, **i32),
                         fixed_point.control(device, handles))

    return fixed_point.launch(
        plan.inv_perm, graph.memo, ("cdlp_slab_loop", buckets, str(device), directed),
        make_state, lambda st: _slab_steps(plan, directed, st), lambda st: st.labels,
        int(itermax), ranges={"step": "cdlp.slab_step"}, range_name="cdlp.graph")


def cdlp_slab_run(graph, centers, neigh, deg, itermax, cfg):
    """Run CDLP on the slab plan; returns (labels on cfg.device, iterations).

    Iteration 0 runs gather-free (min on undirected graphs, whose
    incidence has no duplicates; the stored-id mode otherwise) and is
    taken as a change, as in the JAX kernel; later iterations stop at a
    fixed point or at ``itermax``. One device loop (on a card one CUDA
    graph, memoized on the Graph, and one read of the control words), or
    under iteration timing the host stepping each iteration."""
    device = torch.device(cfg.device)
    buckets = tuple(cfg.slab_buckets) if cfg.slab_buckets else None
    plan = memoized_cdlp_plan(graph, centers, neigh, deg, buckets, device)
    last_run.clear()
    if cfg.iteration_timing:
        last_run.update(driver="iteration timing", condition_reads=0)
        return _cdlp_slab_timed(graph, plan, itermax)
    if itermax < 1:
        return torch.arange(graph.n, dtype=torch.int32, device=device), 0
    labels, ctl_t, loop, reads = _launch_slab(graph, plan, buckets, itermax)
    ctl = ctl_t.tolist()  # the run's one read
    if loop is not None:
        loop.account(fixed_point.runs(ctl, start=1))
    last_run.update(driver="host loop" if loop is None else "graph", condition_reads=reads)
    return labels, ctl[fixed_point.FCTL_IT]


def _cdlp_slab_timed(graph, plan: SlabPlan, itermax):
    """Slab CDLP stepped from the host with a timer per iteration (which
    synchronizes the device): one read per iteration, as the JAX package's
    iteration-timing loop."""
    from graphtpu_torch.utils.timers import IterationTimer

    labels = torch.arange(graph.n, dtype=torch.int32, device=plan.inv_perm.device)
    timer = IterationTimer()
    it = 0
    while it < itermax:
        timer.start()
        if it == 0:
            new = _iter0_mode(plan, labels) if graph.directed else _iter0_minmode(plan, labels)
            changed = True
        else:
            new = cdlp_step(labels, plan)
            changed = bool((new != labels).any())
        timer.stop(f"cdlp iteration {it}", new)
        labels, it = new, it + 1
        if not changed:
            break
    return labels, it
