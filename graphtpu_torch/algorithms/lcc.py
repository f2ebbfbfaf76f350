"""Local clustering coefficient, Graphalytics semantics (counterpart of
graphtpu/algorithms/lcc.py).

Semantics match LAGraph_lcc as the reference invokes it (lcc.cpp:61-70):
the neighbourhood N(v) is over the symmetrized structure (union of in- and
out-neighbours, self-loops excluded); the numerator counts directed edges
between distinct neighbours (each stored direction counts once); the
denominator is |N(v)|(|N(v)| - 1); vertices with |N(v)| < 2 get 0.0
(lcc.cpp:45-55 writes 0.0 for missing entries).

``lcc_impl``:

* "auto" / "oriented": degree-oriented wedge enumeration with one hash-row
  membership test per wedge (ops/triangles.py, kernel K10). ``auto`` falls
  back to the sweep when the oriented out-degree exceeds the largest wedge
  bucket (``WedgeCapacityError``), and only then.
* "sweep": the membership sweep, the oracle. For every directed A-edge
  (u, w) it enumerates the S-neighbours x of the endpoint of lower degree and
  tests (other, x) in S by a branchless binary search over the CSR columns;
  each hit adds 1 to numerator[x]. Work is the sum over A-edges of
  min(d(u), d(w)). The JAX package scans fixed chunks of A-edges padded to a
  static width per degree bucket. The port sweeps a plan of c-rows instead
  (``sweep_plan``): the A-edges grouped by their enumerated endpoint c, each
  with a weight. An undirected graph stores both directions of each pair,
  and both make the same searches with the same hits, so its plan keeps one
  direction with weight 2: half the searches. On the card a bucket of c-rows
  is one launch of kernel K15 (``lcc_sweep_member``, csrc/lcc_sweep.cu); its
  plain version is the JAX function's chunks over the plan's entries, each
  hit times the weight, as a host loop of torch ops.

Numerators are integers summed in any order, so both paths and both
packages agree bit for bit; the coefficients divide the same int64
numerators in numpy float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphtpu_torch.algorithms.common import AlgorithmResult, register
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.ops import kernels
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.spmv import int32_tensor
from graphtpu_torch.ops.triangles import WedgeCapacityError, coefficients, lcc_oriented
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
from graphtpu_torch.utils.logging import get_logger

IMPLS = ("auto", "oriented", "sweep")

# A-edges per step of the sweep, and the [chunk, pad] elements a step may
# hold: wide buckets take shorter chunks, so a step's tensors stay bounded
_CHUNK = 1 << 15
_CHUNK_ELEMS = 1 << 24


def _bucket_bounds(max_deg: int):
    """Static pad widths; each A-edge lands in the smallest bucket holding
    the neighbour list of its endpoint of lower degree."""
    bounds = []
    b = 16
    while b < max_deg:
        bounds.append(b)
        b *= 8
    bounds.append(max(b, 16))
    return bounds


def _row_member(indptr, col, rows, x, search_iters):
    """Branchless binary search: is x[i, j] in col[indptr[r]:indptr[r+1]]
    for r = rows[i]? ``col`` must be sorted within each row (push order)."""
    nnz = col.shape[0]
    lo = table_gather(indptr, rows)[:, None].expand(x.shape)
    hi = table_gather(indptr, rows + 1)[:, None].expand(x.shape)
    hi_fixed = hi
    for _ in range(search_iters):
        active = lo < hi
        mid = (lo + hi) // 2
        v = table_gather(col, mid.clamp(0, nnz - 1))
        go_right = v < x
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return (lo < hi_fixed) & (table_gather(col, lo.clamp(0, nnz - 1)) == x)


def _lcc_bucket_sweep_plain(numerator, indptr, col, c, o, pad, search_iters, weight=1):
    """K15's plain PyTorch version, the JAX function's chunks: a gather of
    each chunk's [chunk, pad] neighbours, the branchless search, an
    index_add_ of the hits, each times ``weight``."""
    nnz = col.shape[0]
    offs = torch.arange(pad, dtype=torch.int32, device=col.device)[None, :]
    chunk = max(1, min(_CHUNK, _CHUNK_ELEMS // pad))
    for a in range(0, c.shape[0], chunk):
        ce, oe = c[a:a + chunk], o[a:a + chunk]
        base = table_gather(indptr, ce)
        deg = table_gather(indptr, ce + 1) - base
        x = table_gather(col, (base[:, None] + offs).clamp(0, nnz - 1))   # [chunk, pad]
        valid = offs < deg[:, None]
        found = _row_member(indptr, col, oe, x, search_iters)
        hits = (found & valid).to(numerator.dtype) * weight
        numerator.index_add_(0, x.reshape(-1).long(), hits.reshape(-1))
    return numerator


# K15's threads per work item: a warp. Only tools/lcc_sweep_times.py passes
# another unit (64, 128 or 256 threads, whose warps split an item's o's)
K15_UNIT = 32
# K15's searches a lane runs in step: 1 below pad K15_ILP_FROM_PAD, K15_ILP
# from it on (the faster per bucket on the bench graph,
# tools/lcc_sweep_times.py)
K15_ILP, K15_ILP_FROM_PAD = 4, 1024
# the x's a K15 item holds: a warp's tile
K15_TILE = 32
# the most searches a lane of a K15 item makes: an item holds at most
# (32 / g) * K15_STEPS o's of one c-row, g lanes searching each
K15_STEPS = 128


def k15_ilp(pad: int) -> int:
    """The searches a lane of K15 runs in step on the path, for a bucket."""
    return K15_ILP if pad >= K15_ILP_FROM_PAD else 1


def sweep_items(c: np.ndarray, s_deg: np.ndarray) -> np.ndarray:
    """K15's work items over plan entries ``c`` (int32, in runs of equal c:
    the c-rows), as int32 [items, 3] rows (e0, e1, xoff): the entries [e0,
    e1) of one run and the tile of c's neighbours x from position xoff, at
    most K15_TILE of them. A tile of xr neighbours takes g = the power of
    two at or above xr lanes a search, so a warp searches 32 / g o's at
    once, and its item holds at most (32 / g) * K15_STEPS entries."""
    p = c.shape[0]
    if p >= 1 << 31:
        raise ValueError(f"lcc_sweep_member: {p} plan entries exceed int32 positions")
    if p == 0:
        return np.zeros((0, 3), dtype=np.int32)
    starts = np.flatnonzero(np.concatenate([[True], c[1:] != c[:-1]]))
    ends = np.append(starts[1:], p)
    tiles = (s_deg[c[starts]].astype(np.int64) + K15_TILE - 1) // K15_TILE
    run = np.repeat(np.arange(starts.shape[0]), tiles)
    first = np.cumsum(tiles) - tiles
    t = np.arange(run.shape[0], dtype=np.int64) - first[run]
    xr = np.minimum(K15_TILE, s_deg[c[starts]][run] - K15_TILE * t)
    g = np.left_shift(1, np.ceil(np.log2(np.maximum(xr, 1))).astype(np.int64))
    och = (32 // g) * K15_STEPS
    nch = -(-(ends - starts)[run] // och)
    tile_of = np.repeat(np.arange(run.shape[0]), nch)
    j = np.arange(tile_of.shape[0], dtype=np.int64) - (np.cumsum(nch) - nch)[tile_of]
    e0 = starts[run][tile_of] + j * och[tile_of]
    e1 = np.minimum(e0 + och[tile_of], ends[run][tile_of])
    return np.stack([e0, e1, K15_TILE * t[tile_of]], axis=1).astype(np.int32)


def _lcc_bucket_sweep(numerator, indptr, col, c, o, pad, search_iters, weight=1, items=None,
                      unit=K15_UNIT, ilp=None):
    """K15 wrapper: add to ``numerator`` (int64 [n], in place) ``weight``
    times the common-neighbour hits of the entries (c, o) whose enumerated
    endpoint ``c`` has degree <= pad; ``o`` is the other endpoint.
    ``indptr`` [n+1], ``col`` (S's CSR, each row sorted), ``c`` and ``o``
    are int32. On the card one launch over ``items`` (``sweep_items`` of
    the host's c, int32 [items, 3] on the device), ``unit`` threads an
    item, ``ilp`` searches a lane in step (1 or 4; where not given, the
    path's count for the pad; ``search_iters`` is the plain version's)."""
    ts = (indptr, col, c, o)
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in ts) or numerator.dtype != torch.int64:
        raise TypeError("lcc_sweep_member: int32 indptr, col, c and o; int64 numerator")
    if c.shape != o.shape or indptr.shape[0] != numerator.shape[0] + 1 or pad < 1:
        raise ValueError("lcc_sweep_member: c and o of one length, n + 1 indptr entries, "
                         "pad >= 1")
    if weight not in (1, 2):
        raise ValueError(f"lcc_sweep_member: weight {weight} is not 1 or 2")
    ts += (numerator,)
    if any(t.device != numerator.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("lcc_sweep_member: inputs must be contiguous, on one device")
    if not kernels.use_kernel(numerator):
        return _lcc_bucket_sweep_plain(numerator, indptr, col, c, o, pad, search_iters, weight)
    if (items is None or items.dtype != torch.int32 or items.dim() != 2 or items.shape[1] != 3
            or items.device != numerator.device or not items.is_contiguous()):
        raise ValueError("lcc_sweep_member: items must be contiguous int32 [items, 3] on the "
                         "numerator's device")
    if items.shape[0]:
        kernels.launch("lcc_sweep_member", numerator.device, indptr.data_ptr(), col.data_ptr(),
                       c.data_ptr(), o.data_ptr(), items.data_ptr(), items.shape[0], weight,
                       unit, k15_ilp(pad) if ilp is None else ilp, numerator.data_ptr())
    return numerator


def _sym_csr(graph: Graph):
    """S, the symmetrized structure without self-loops, in CSR (push)
    order: (indptr int32 [n+1], columns int32, degrees int64 [n])."""
    sym = graph.symmetrized()
    s_keep = sym.src != sym.dst
    s_src, s_dst = sym.src[s_keep], sym.dst[s_keep]
    s_deg = np.bincount(s_src, minlength=graph.n).astype(np.int64)
    s_indptr = np.zeros(graph.n + 1, dtype=np.int32)
    np.cumsum(s_deg, out=s_indptr[1:])
    return s_indptr, s_dst.astype(np.int32), s_deg


def prepare_lcc(graph: Graph):
    """Host prep of the sweep: the symmetrized CSR structure S (self-loops
    dropped) and the A-edge list with the endpoint of lower S-degree
    enumerated."""
    s_indptr, s_dst, s_deg = _sym_csr(graph)

    # A: the original directed edge set (for undirected graphs, both stored
    # directions), self-loops excluded
    a_keep = graph.src != graph.dst
    a_u, a_w = graph.src[a_keep], graph.dst[a_keep]

    du, dw = s_deg[a_u], s_deg[a_w]
    c = np.where(du <= dw, a_u, a_w).astype(np.int32)
    o = np.where(du <= dw, a_w, a_u).astype(np.int32)
    dc = np.minimum(du, dw)
    return s_indptr, s_dst, s_deg, c, o, dc


class SweepPlan(NamedTuple):
    """The sweep's c-rows: entries (c, o) grouped in runs of equal c, in
    ascending c, each standing for ``weight`` A-edges that make the same
    searches."""
    s_indptr: np.ndarray   # [n+1] int32: S's row pointers
    s_dst: np.ndarray      # int32: S's columns, sorted within each row
    s_deg: np.ndarray      # [n] int64: S-degrees
    c: np.ndarray          # [p] int32: the enumerated endpoint of each entry
    o: np.ndarray          # [p] int32: the other endpoint
    weight: int            # A-edges an entry stands for: 2 undirected, 1 directed


# a prime: the symmetry check's hash values and products stay exact in int64
_SYM_P = (1 << 31) - 1


def is_symmetric(src: np.ndarray, dst: np.ndarray, n: int, device="cpu") -> bool:
    """Whether the edges (src, dst) are a symmetric multiset: their
    multiplicity matrix A over n vertices gives x^T A y = y^T A x modulo the
    prime p = 2^31 - 1 for random vectors x and y (an A that is not
    symmetric passes with a chance of at most 2 / p). Four gathers and two
    sums over the edges, on ``device``."""
    gen = torch.Generator().manual_seed(0x5EED)
    x, y = (torch.randint(0, _SYM_P, (n,), generator=gen, dtype=torch.int64).to(device)
            for _ in range(2))
    u, w = (int32_tensor(a, device).long() for a in (src, dst))
    diff = (x[u] * y[w]).remainder_(_SYM_P).sum() - (x[w] * y[u]).remainder_(_SYM_P).sum()
    return int(diff) % _SYM_P == 0


def sweep_plan(graph: Graph, device="cpu") -> SweepPlan:
    """The sweep's A-edges as c-rows, with no sort. Undirected: one entry
    per unordered pair, the direction whose source is the lower (S-degree,
    id) endpoint, weight 2, where the stored edges are symmetric (checked);
    the push order groups them by c. Otherwise every A-edge, weight 1, c
    the endpoint of lower S-degree (the source on a tie, as
    ``prepare_lcc``). Directed: from the push order where c is the source,
    from the pull order where it is the destination, placed by counts into
    runs of equal c. An undirected graph stored one way only
    (``Graph.from_arrays`` of one direction): grouped by a sort. The
    symmetry check runs on ``device``; the plan is host arrays."""
    n = graph.n
    s_indptr, s_dst, s_deg = _sym_csr(graph)
    keep = graph.src != graph.dst
    u, w = graph.src[keep], graph.dst[keep]
    if not graph.directed:
        du, dw = s_deg[u], s_deg[w]
        if is_symmetric(u, w, n, device):
            first = (du < dw) | ((du == dw) & (u < w))
            return SweepPlan(s_indptr, s_dst, s_deg, u[first].astype(np.int32),
                             w[first].astype(np.int32), 2)
        c, o = np.where(du <= dw, u, w), np.where(du <= dw, w, u)
        order = np.argsort(c, kind="stable")
        return SweepPlan(s_indptr, s_dst, s_deg, c[order].astype(np.int32),
                         o[order].astype(np.int32), 1)
    push = s_deg[u] <= s_deg[w]
    cp, op = u[push], w[push]                     # grouped by c = source
    ps, pd, _ = graph.pull_arrays()
    pk = ps != pd
    ps, pd = ps[pk], pd[pk]
    pull = s_deg[ps] > s_deg[pd]
    cq, oq = pd[pull], ps[pull]                   # grouped by c = destination
    cnt_p = np.bincount(cp, minlength=n)
    cnt_q = np.bincount(cq, minlength=n)
    row = np.cumsum(cnt_p + cnt_q) - (cnt_p + cnt_q)
    first_p, first_q = np.cumsum(cnt_p) - cnt_p, np.cumsum(cnt_q) - cnt_q
    o = np.empty(cp.shape[0] + cq.shape[0], dtype=np.int32)
    o[row[cp] + np.arange(cp.shape[0]) - first_p[cp]] = op
    o[row[cq] + cnt_p[cq] + np.arange(cq.shape[0]) - first_q[cq]] = oq
    c = np.repeat(np.arange(n, dtype=np.int32), cnt_p + cnt_q)
    return SweepPlan(s_indptr, s_dst, s_deg, c, o, 1)


def search_iters_of(s_deg: np.ndarray) -> int:
    """The plain version's search steps: enough for the longest S-row."""
    max_deg = int(s_deg.max()) if s_deg.shape[0] else 0
    return max(1, int(np.ceil(np.log2(max(max_deg, 2) + 1))))


def plan_buckets(plan: SweepPlan):
    """(pad, entry mask) of each nonempty degree bucket of the plan: an
    entry lands in the smallest pad at or above d(c)."""
    dc = plan.s_deg[plan.c]
    out = []
    for pad in _bucket_bounds(int(plan.s_deg.max()) if plan.s_deg.shape[0] else 0):
        sel = (dc > (0 if pad == 16 else pad // 8)) & (dc <= pad)
        if sel.any():
            out.append((pad, sel))
    return out


def sweep_bucket(numerator, indptr, col, plan: SweepPlan, c, o, pad, search_iters):
    """One bucket of the plan (host entries ``c``, ``o``) into ``numerator``
    on its device: K15's items are built on the host where it launches."""
    dev = numerator.device
    items = (torch.from_numpy(sweep_items(c, plan.s_deg)).to(dev)
             if kernels.use_kernel(numerator) else None)
    return _lcc_bucket_sweep(numerator, indptr, col, int32_tensor(c, dev), int32_tensor(o, dev),
                             pad, search_iters, plan.weight, items)


def lcc_sweep_numerator(graph: Graph, device) -> tuple:
    """(numerator int64 [n] on the host, symmetrized degrees) by the sweep
    over the c-row plan, one K15 launch a nonempty bucket."""
    plan = sweep_plan(graph, device)
    iters = search_iters_of(plan.s_deg)
    indptr_d = int32_tensor(plan.s_indptr, device)
    col_d = int32_tensor(plan.s_dst, device)
    numerator = torch.zeros(graph.n, dtype=torch.int64, device=device)
    for pad, sel in plan_buckets(plan):
        sweep_bucket(numerator, indptr_d, col_d, plan, plan.c[sel], plan.o[sel], pad, iters)
    return numerator.cpu().numpy(), plan.s_deg


def _lcc_sweep(graph: Graph, cfg: PlatformConfig) -> AlgorithmResult:
    """The membership sweep (``lcc-impl=sweep``): the oracle."""
    return AlgorithmResult("lcc", coefficients(*lcc_sweep_numerator(graph, cfg.device)))


@register("lcc")
def lcc(graph: Graph, params: AlgorithmParams, cfg: PlatformConfig) -> AlgorithmResult:
    impl = cfg.lcc_impl
    if impl not in IMPLS:
        raise ValueError(f"unknown lcc-impl {impl!r}; expected {'|'.join(IMPLS)}")
    if impl in ("auto", "oriented"):
        try:
            return AlgorithmResult(
                "lcc", lcc_oriented(graph, cache_dir=cfg.intermediate_dir, device=cfg.device)
            )
        except WedgeCapacityError:
            if impl == "oriented":
                raise
            # the oriented out-degree exceeds the largest wedge bucket (very
            # high degeneracy): the sweep has no degree limit
            get_logger("lcc").warning(
                "wedge-plan capacity exceeded; falling back to membership sweep"
            )
    return _lcc_sweep(graph, cfg)
