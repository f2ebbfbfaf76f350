"""Community detection by label propagation (counterpart of
graphtpu/algorithms/cdlp.py), with LAGraph_cdlp.c's semantics:
synchronous updates; each vertex adopts the smallest among the most
frequent labels of its neighbours (LAGraph_cdlp.c:40-45); on directed
graphs in- and out-neighbours both count, so a bidirectional neighbour
counts twice (:47-50, 276-284); vertices without neighbours keep their
label; the loop stops early at a fixed point (:328-332). Labels are dense
ids during compute and original ids at output.

``cdlp_impl``: "auto" and "adaptive" run full slab steps while many
labels change, then active-set steps on the frontier engine
(ops/active.py, kernels K2 and K5); under ``iteration_timing`` they run
host-stepped, as "adaptive-host". "slab" is the degree-bucketed path on
kernel K2 alone (ops/minmode.py); "sort" takes each vertex's min-mode over
its whole incidence row on kernel K12 (``stream_minmode``), the function
the reference computes by a global sort and run-length scan
(LAGraph_cdlp.c:286-323), which ``_cdlp_sort_kernel`` keeps in torch ops as
the oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtpu_torch.algorithms.common import AlgorithmResult, register
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig

IMPLS = ("auto", "adaptive", "adaptive-host", "slab", "sort")
_M31 = (1 << 31) - 1


def build_incidence(graph: Graph):
    """(centers, neighbours) sorted by center; directed graphs count both
    directions (in + out multiset union). Memoized on the Graph."""
    cached = graph.memo.get("incidence")
    if cached is not None:
        return cached
    if graph.directed:
        centers = np.concatenate([graph.dst, graph.src])
        neigh = np.concatenate([graph.src, graph.dst])
        perm = np.argsort(centers, kind="stable")
        centers, neigh = centers[perm], neigh[perm]
    else:
        s, d, _ = graph.pull_arrays()
        centers, neigh = d, s
    out = (centers.astype(np.int32), neigh.astype(np.int32))
    graph.memo["incidence"] = out
    return out


def _cdlp_sort_kernel(centers, neigh, deg, n, itermax, skip_checks=0):
    """The oracle: per iteration, sort (center, label) pairs, take run
    lengths, then per center the max count and the smallest label with
    it. Torch ops only, independent of the slab path and its kernels.
    The first ``skip_checks`` iterations count as not converged, without
    the equality test and its blocking host read (the reference's
    optimized_skip_checkequal, cdlp_kernel.cu:1254-1271)."""
    device = centers.device
    labels = torch.arange(n, dtype=torch.int32, device=device)
    has_neighbors = deg > 0
    c64 = centers.to(torch.int64)
    neigh64 = neigh.to(torch.int64)
    m = centers.shape[0]
    idx = torch.arange(m, device=device)
    it, changed = 0, True
    while changed and it < itermax:
        key = torch.sort((c64 << 31) | labels[neigh64].to(torch.int64)).values
        c_s, l_s = key >> 31, key & _M31
        is_start = torch.ones(m, dtype=torch.bool, device=device)
        is_start[1:] = key[1:] != key[:-1]
        is_end = torch.ones_like(is_start)
        is_end[:-1] = is_start[1:]
        run_start = torch.cummax(torch.where(is_start, idx, -1), 0).values
        run_end = torch.flip(
            torch.cummin(torch.flip(torch.where(is_end, idx, m), [0]), 0).values, [0]
        )
        counts = run_end - run_start + 1
        max_count = torch.zeros(n, dtype=torch.int64, device=device).scatter_reduce(
            0, c_s, counts, "amax"
        )
        best = torch.full((n,), INT32_INF, dtype=torch.int64, device=device).scatter_reduce(
            0, c_s, torch.where(counts == max_count[c_s], l_s, INT32_INF), "amin"
        )
        new = torch.where(has_neighbors, best.to(torch.int32), labels)
        changed = it < skip_checks or bool((new != labels).any())
        labels, it = new, it + 1
    return labels, it


def incidence_csr(graph: Graph, centers, neigh, deg, device):
    """(centers, neigh, indptr, deg) of the incidence on ``device``: int32,
    indptr the prefix of the incidence degrees. Memoized on the Graph,
    keyed by the device."""
    key = ("cdlp_incidence_csr", str(device))
    csr = graph.memo.get(key)
    if csr is None:
        indptr = np.zeros(graph.n + 1, dtype=np.int64)
        np.cumsum(deg, out=indptr[1:])
        csr = tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
                    for a in (centers, neigh, indptr, deg))
        graph.memo[key] = csr
    return csr


def cdlp_sort_run(graph: Graph, centers, neigh, deg, itermax: int, skip_checks: int, device):
    """cdlp-impl=sort: per iteration, each vertex's min-mode over its
    incidence row on K12 (its plain version on the CPU and under
    ``kernels.plain_torch()``); vertices without neighbours keep their
    label. The first ``skip_checks`` iterations count as changed, without
    the read (as ``_cdlp_sort_kernel``); after them, one device read an
    iteration. Returns (labels on ``device``, iterations)."""
    from graphtpu_torch.ops.minmode import stream_minmode

    c, nb, indptr, d = incidence_csr(graph, centers, neigh, deg, device)
    has_neighbors = d > 0
    labels = torch.arange(graph.n, dtype=torch.int32, device=device)
    it, changed = 0, True
    while changed and it < itermax:
        new = torch.where(has_neighbors, stream_minmode(labels, c, nb, indptr), labels)
        changed = it < skip_checks or bool((new != labels).any())
        labels, it = new, it + 1
    return labels, it


def _resolve_impl(cfg: PlatformConfig) -> str:
    impl = cfg.cdlp_impl
    if impl not in IMPLS:
        raise ValueError(f"unknown cdlp-impl {impl!r}; expected {'|'.join(IMPLS)}")
    if impl in ("auto", "adaptive"):
        # per-iteration timing needs a host-stepped loop
        return "adaptive-host" if cfg.iteration_timing else "adaptive"
    return impl


@register("cdlp")
def cdlp(graph: Graph, params: AlgorithmParams, cfg: PlatformConfig) -> AlgorithmResult:
    if params.max_iterations is None:
        raise ValueError("cdlp requires max-iterations")
    impl = _resolve_impl(cfg)
    centers, neigh = build_incidence(graph)
    deg = graph.memo.get("incidence_deg")
    if deg is None:  # one host pass over every incidence entry: once per graph
        deg = np.bincount(centers, minlength=graph.n).astype(np.int32)
        graph.memo["incidence_deg"] = deg
    if centers.shape[0] == 0:
        # edgeless graph: every vertex keeps its own label
        return AlgorithmResult("cdlp", graph.mapping.copy(), iterations=0)
    itermax = int(params.max_iterations)
    if impl == "adaptive":
        from graphtpu_torch.ops.active import cdlp_adaptive_device_run

        labels, it = cdlp_adaptive_device_run(graph, centers, neigh, deg, itermax, cfg)
    elif impl == "adaptive-host":
        from graphtpu_torch.ops.active import cdlp_adaptive_run

        labels, it = cdlp_adaptive_run(graph, centers, neigh, deg, itermax, cfg)
    elif impl == "slab":
        from graphtpu_torch.ops.minmode import cdlp_slab_run

        labels, it = cdlp_slab_run(graph, centers, neigh, deg, itermax, cfg)
    else:
        labels, it = cdlp_sort_run(graph, centers, neigh, deg, itermax,
                                   int(cfg.skip_convergence_checks), torch.device(cfg.device))
    communities = graph.mapping[labels.cpu().numpy()]
    return AlgorithmResult("cdlp", communities, iterations=int(it))
