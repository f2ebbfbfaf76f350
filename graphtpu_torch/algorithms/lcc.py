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
  static width per degree bucket; on the card a bucket is one launch of
  kernel K15 (``lcc_sweep_member``), and its plain version is those chunks
  as a host loop of torch ops.

Numerators are integers summed in any order, so both paths and both
packages agree bit for bit; the coefficients divide the same int64
numerators in numpy float64.
"""

from __future__ import annotations

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


def _lcc_bucket_sweep_plain(numerator, indptr, col, c, o, pad, search_iters):
    """K15's plain PyTorch version, the JAX function's chunks: a gather of
    each chunk's [chunk, pad] neighbours, the branchless search, an
    index_add_ of the hits."""
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
        hits = (found & valid).to(numerator.dtype)
        numerator.index_add_(0, x.reshape(-1).long(), hits.reshape(-1))
    return numerator


# K15's threads per A-edge, every bucket: a warp. Only
# tools/lcc_sweep_times.py passes another unit (64, 128 or 256): over the
# bench graph's whole sweep a warp is within 3 % of the best unit per bucket
K15_UNIT = 32


def _lcc_bucket_sweep(numerator, indptr, col, c, o, pad, search_iters, unit=K15_UNIT):
    """K15 wrapper: add to ``numerator`` (int64 [n], in place) the
    common-neighbour hits of the A-edges whose enumerated endpoint ``c`` has
    degree <= pad; ``o`` is the other endpoint. ``indptr`` [n+1], ``col``
    (S's CSR, each row sorted), ``c`` and ``o`` are int32. One launch a
    bucket on the card, ``unit`` threads an A-edge (``search_iters`` is the
    plain version's)."""
    ts = (indptr, col, c, o)
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in ts) or numerator.dtype != torch.int64:
        raise TypeError("lcc_sweep_member: int32 indptr, col, c and o; int64 numerator")
    if c.shape != o.shape or indptr.shape[0] != numerator.shape[0] + 1 or pad < 1:
        raise ValueError("lcc_sweep_member: c and o of one length, n + 1 indptr entries, "
                         "pad >= 1")
    ts += (numerator,)
    if any(t.device != numerator.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("lcc_sweep_member: inputs must be contiguous, on one device")
    if not kernels.use_kernel(numerator):
        return _lcc_bucket_sweep_plain(numerator, indptr, col, c, o, pad, search_iters)
    if c.shape[0]:
        kernels.launch("lcc_sweep_member", numerator.device, indptr.data_ptr(), col.data_ptr(),
                       c.data_ptr(), o.data_ptr(), c.shape[0], unit, numerator.data_ptr())
    return numerator


def prepare_lcc(graph: Graph):
    """Host prep of the sweep: the symmetrized CSR structure S (self-loops
    dropped) and the A-edge list with the endpoint of lower S-degree
    enumerated."""
    n = graph.n
    sym = graph.symmetrized()

    # S: symmetrized structure without self-loops, CSR (push) order
    s_keep = sym.src != sym.dst
    s_src, s_dst = sym.src[s_keep], sym.dst[s_keep]
    s_deg = np.bincount(s_src, minlength=n).astype(np.int64)
    s_indptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(s_deg, out=s_indptr[1:])

    # A: the original directed edge set (for undirected graphs, both stored
    # directions), self-loops excluded
    a_keep = graph.src != graph.dst
    a_u, a_w = graph.src[a_keep], graph.dst[a_keep]

    du, dw = s_deg[a_u], s_deg[a_w]
    c = np.where(du <= dw, a_u, a_w).astype(np.int32)
    o = np.where(du <= dw, a_w, a_u).astype(np.int32)
    dc = np.minimum(du, dw)
    return s_indptr, s_dst.astype(np.int32), s_deg, c, o, dc


def lcc_sweep_numerator(graph: Graph, device) -> tuple:
    """(numerator int64 [n] on the host, symmetrized degrees) by the sweep."""
    n = graph.n
    s_indptr, s_dst, s_deg, c, o, dc = prepare_lcc(graph)

    max_deg = int(s_deg.max()) if n else 0
    search_iters = max(1, int(np.ceil(np.log2(max(max_deg, 2) + 1))))

    indptr_d = int32_tensor(s_indptr, device)
    col_d = int32_tensor(s_dst, device)
    numerator = torch.zeros(n, dtype=torch.int64, device=device)

    for pad in _bucket_bounds(max_deg):
        lo_bound = 0 if pad == 16 else pad // 8
        sel = (dc > lo_bound) & (dc <= pad) if pad > 16 else dc <= pad
        if not sel.any():
            continue
        _lcc_bucket_sweep(
            numerator, indptr_d, col_d, int32_tensor(c[sel], device),
            int32_tensor(o[sel], device), pad, search_iters,
        )
    return numerator.cpu().numpy(), s_deg


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
