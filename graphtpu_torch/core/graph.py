"""Host graph container (counterpart of graphtpu/core/graph.py).

Dense int32 vertex ids with the sparse original ids kept in ``mapping``
(the reference's graph.vtx/.vtb design). Edges are stored deduplicated in
push order, sorted by (src, dst); undirected inputs are stored in both
directions. ``pull_arrays`` gives the (dst, src) order that per-vertex
reductions over in-edges key on, and ``device_push``/``device_pull`` give
torch views of either order on a device the caller names.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from graphtpu_torch.core.types import INDEX_DTYPE, ORIGINAL_ID_DTYPE
from graphtpu_torch.ingest import native


class COO(NamedTuple):
    """A device edge stream. ``w`` is all-ones for unweighted graphs."""

    src: torch.Tensor  # int32 [nnz]
    dst: torch.Tensor  # int32 [nnz]
    w: torch.Tensor    # float [nnz]


# Minimum edge count for the native counting sort: below it numpy's argsort
# is as fast and the n-sized counter arrays are large beside the stream.
NATIVE_SORT_MIN = 1 << 16


def _ids_fit(src: np.ndarray, dst: np.ndarray, bound: int) -> bool:
    return (src.min() >= 0 and dst.min() >= 0
            and max(int(src.max()), int(dst.max())) < bound)


def _native_sort_edges(src, dst, w, n: int, primary: str, dedup: bool):
    """Sort (and optionally keep-first-dedup) an edge stream by the native
    O(m + n) stable counting sort (gtio_sort_edges). Returns host (src,
    dst, w), or None when it does not apply: a small stream, n >= 2^31,
    the library off, or the native call declining (ids outside [0, n),
    an allocation failure)."""
    m = src.shape[0]
    if not m or m < NATIVE_SORT_MIN or n >= (1 << 31) or not native.available():
        return None
    if primary == "src":
        out = native.sort_edges(src, dst, w, n, dedup)
    else:
        out = native.sort_edges(dst, src, w, n, dedup)
        if out is not None:
            out = (out[1], out[0], out[2])
    return out


# Minimum edge count for the sort on a CUDA card.
DEVICE_SORT_MIN = 1 << 22
# seconds of the last device sort: host-to-device, sort, device-to-host
last_device_sort: dict = {}


def _device_sort_edges(src, dst, w, primary: str, dedup: bool):
    """Sort (and optionally keep-first-dedup) an edge stream on the CUDA
    card: the stable sort of the same packed (primary << 32) | secondary
    key as _lexsort_edges, so the result equals the host sorts'. Returns
    host (src, dst, w), or None when it does not apply (a stream under
    DEVICE_SORT_MIN, no CUDA card, ids that do not fit 31 bits). A failure
    on the card raises. The float64 weights are not co-sorted: an int32
    position rides with the keys and the host applies it to ``w``."""
    m = src.shape[0]
    if (not m or m < DEVICE_SORT_MIN or not torch.cuda.is_available()
            or not _ids_fit(src, dst, 1 << 31)):
        return None
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    s_d = torch.from_numpy(np.ascontiguousarray(src, dtype=INDEX_DTYPE)).to(dev)
    d_d = torch.from_numpy(np.ascontiguousarray(dst, dtype=INDEX_DTYPE)).to(dev)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    s_s, d_s, pos, keep = _device_sort_kernel(s_d, d_d, primary == "src", dedup,
                                              w is not None, dev)
    if dedup:
        s_s, d_s = s_s[keep], d_s[keep]
        pos = None if pos is None else pos[keep]
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    host = [_pinned_copy(t) for t in (s_s, d_s) + (() if pos is None else (pos,))]
    torch.cuda.synchronize(dev)
    t3 = time.perf_counter()
    last_device_sort.update(h2d_s=t1 - t0, sort_s=t2 - t1, d2h_s=t3 - t2)
    s_h, d_h = host[0].numpy(), host[1].numpy()
    w_h = None if w is None else np.asarray(w, dtype=np.float64)[host[2].numpy()]
    return s_h, d_h, w_h


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _device_sort_kernel(src, dst, prim_src: bool, dedup: bool, with_pos: bool, device):
    """Stable sort of int32 ``src``, ``dst`` by (primary, secondary) on
    ``device``: (src, dst, int32 positions in the input or None, keep-first
    mask). ``keep`` is all True without ``dedup``."""
    src = torch.as_tensor(src).to(device)
    dst = torch.as_tensor(dst).to(device)
    hi, lo = (src, dst) if prim_src else (dst, src)
    key = (hi.to(torch.int64) << 32) | lo.to(torch.int64)
    key_s, order = torch.sort(key, stable=True)
    hi_s = (key_s >> 32).to(torch.int32)
    lo_s = (key_s & 0xFFFFFFFF).to(torch.int32)
    src_s, dst_s = (hi_s, lo_s) if prim_src else (lo_s, hi_s)
    pos = order.to(torch.int32) if with_pos else None
    keep = torch.ones(key_s.shape, dtype=torch.bool, device=key_s.device)
    if dedup and key_s.numel() > 1:
        keep[1:] = key_s[1:] != key_s[:-1]
    return src_s, dst_s, pos, keep


def _sort_edges(src, dst, w, n: int, primary: str, dedup: bool):
    """(src, dst, w) sorted by (primary, secondary), stable, keep-first
    deduplicated if ``dedup``: on the CUDA card where one is visible, else
    by the native counting sort, else numpy's lexsort. All three give the
    same arrays; on an H100 the card's sort of a 60.7M-edge stream, copies
    included, takes about 1/50 of the native sort's time (PERF.md §5)."""
    out = _device_sort_edges(src, dst, w, primary, dedup)
    if out is None:
        out = _native_sort_edges(src, dst, w, n, primary, dedup)
    if out is not None:
        return out
    perm = _lexsort_edges(src, dst, primary)
    src, dst = src[perm], dst[perm]
    w = None if w is None else w[perm]
    if dedup and src.size:
        keep = np.empty(src.shape[0], dtype=bool)
        keep[0] = True
        np.logical_or(src[1:] != src[:-1], dst[1:] != dst[:-1], out=keep[1:])
        if not keep.all():
            src, dst = src[keep], dst[keep]
            w = None if w is None else w[keep]
    return src, dst, w


def _lexsort_edges(src: np.ndarray, dst: np.ndarray, primary: str) -> np.ndarray:
    """Permutation sorting edges by (primary, secondary). When both id
    ranges fit 31 bits the two keys pack into one int64 and a STABLE
    argsort keeps the keep-first dedupe semantics for duplicate edges."""
    a, b = (src, dst) if primary == "dst" else (dst, src)
    # a = secondary, b = primary
    if src.size and _ids_fit(src, dst, 1 << 31):
        key = (b.astype(np.int64) << 32) | a.astype(np.int64)
        return np.argsort(key, kind="stable")
    return np.lexsort((a, b))


class Graph:
    """Host-side graph: dense-id COO + original-id mapping + cached views.

    ``presorted=True`` takes the edges as a built Graph holds them: sorted
    by (src, dst) and deduplicated (``from_arrays``)."""

    def __init__(
        self,
        n: int,
        src: np.ndarray,
        dst: np.ndarray,
        w: Optional[np.ndarray],
        mapping: np.ndarray,
        directed: bool,
        weighted: bool,
        *,
        presorted: bool = False,
    ):
        self.n = int(n)
        self.directed = bool(directed)
        self.weighted = bool(weighted)
        # dataset name when loaded through the ingest cache
        self.name: Optional[str] = None
        self.mapping = np.asarray(mapping, dtype=ORIGINAL_ID_DTYPE)

        src = np.asarray(src, dtype=INDEX_DTYPE)
        dst = np.asarray(dst, dtype=INDEX_DTYPE)
        # unweighted graphs keep w as None: no constant ones are co-sorted
        if w is not None:
            w = np.asarray(w, dtype=np.float64)
        if not presorted and src.size:
            src, dst, w = _sort_edges(src, dst, w, self.n, "src", True)
        self.src = src
        self.dst = dst
        self._w_arr = w
        self.nnz = int(src.shape[0])

        self._out_deg: Optional[np.ndarray] = None
        self._in_deg: Optional[np.ndarray] = None
        self._indptr: Optional[np.ndarray] = None
        self._pull_indptr: Optional[np.ndarray] = None
        self._pull_cache = None
        self._device_views: dict = {}
        # derived artifacts the algorithms memoize on the graph (incidence
        # stream, slab plans), released with it
        self.memo: dict = {}

    @classmethod
    def from_arrays(cls, n, src, dst, w, mapping, directed, weighted) -> "Graph":
        """Wrap the host arrays of a built graph (push-sorted, deduplicated),
        e.g. those of a graphtpu Graph."""
        return cls(n, src, dst, w, mapping, directed, weighted, presorted=True)

    @property
    def w(self) -> np.ndarray:
        """Edge weights in push order (all-ones for unweighted graphs,
        materialized on first touch)."""
        if self._w_arr is None:
            self._w_arr = np.ones(self.nnz, dtype=np.float64)
        return self._w_arr

    @classmethod
    def from_original_ids(
        cls,
        vertex_ids: np.ndarray,
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        edge_w: Optional[np.ndarray],
        directed: bool,
        weighted: bool,
    ) -> "Graph":
        """Relabel sparse original ids to dense [0, n) ids: the dense id is
        the position in the vertex file, and ``mapping`` is the inverse."""
        vertex_ids = np.asarray(vertex_ids, dtype=ORIGINAL_ID_DTYPE)
        n = vertex_ids.shape[0]
        # the fused native relabel (hash join, undirected doubling, radix
        # sort and keep-first dedup in one pass) raises the numpy path's
        # errors itself and returns None only when it declines
        if np.asarray(edge_src).shape[0] >= NATIVE_SORT_MIN and native.available():
            out = native.relabel_edges(
                vertex_ids, edge_src, edge_dst,
                None if edge_w is None else np.asarray(edge_w, dtype=np.float64), directed,
            )
            if out is not None:
                s, d, w = out
                return cls(n, s, d, w, vertex_ids, directed, weighted, presorted=True)

        order = np.argsort(vertex_ids, kind="stable")
        sorted_ids = vertex_ids[order]
        if np.any(sorted_ids[1:] == sorted_ids[:-1]):
            raise ValueError("duplicate vertex ids in vertex file")

        def to_dense(ids):
            ids = np.asarray(ids, dtype=ORIGINAL_ID_DTYPE)
            if ids.size == 0:  # an empty edge list is valid for any n
                return ids.astype(INDEX_DTYPE)
            pos = np.searchsorted(sorted_ids, ids)
            pos = np.clip(pos, 0, max(n - 1, 0))
            if n == 0 or not np.array_equal(sorted_ids[pos], ids):
                raise ValueError("edge references unknown vertex id")
            return order[pos].astype(INDEX_DTYPE)

        s = to_dense(edge_src)
        d = to_dense(edge_dst)
        w = None if edge_w is None else np.asarray(edge_w, dtype=np.float64)

        if not directed:
            # store both directions, self-loops once; an unordered pair
            # listed twice with conflicting weights would store asymmetric
            # weights under keep-first dedupe, so it is refused
            if w is not None and s.size:
                lo = np.minimum(s, d).astype(np.int64)
                hi = np.maximum(s, d).astype(np.int64)
                bits = max(int(n).bit_length(), 1)
                key = (lo << bits) | hi
                o = np.argsort(key, kind="stable")
                ks, ws = key[o], w[o]
                dup = ks[1:] == ks[:-1]
                if np.any(dup & (ws[1:] != ws[:-1])):
                    raise ValueError(
                        "undirected input lists an edge twice with conflicting weights"
                    )
            non_loop = s != d
            s2 = np.concatenate([s, d[non_loop]])
            d2 = np.concatenate([d, s[non_loop]])
            if w is not None:
                w = np.concatenate([w, w[non_loop]])
            s, d = s2, d2

        return cls(n, s, d, w, vertex_ids, directed, weighted)

    # ------------------------------------------------------------- host views

    @property
    def out_degree(self) -> np.ndarray:
        if self._out_deg is None:
            self._out_deg = np.bincount(self.src, minlength=self.n).astype(np.int64)
        return self._out_deg

    @property
    def in_degree(self) -> np.ndarray:
        if self._in_deg is None:
            self._in_deg = np.bincount(self.dst, minlength=self.n).astype(np.int64)
        return self._in_deg

    @property
    def indptr(self) -> np.ndarray:
        """CSR row pointers over the push-ordered edges."""
        if self._indptr is None:
            self._indptr = np.zeros(self.n + 1, dtype=np.int64)
            np.cumsum(self.out_degree, out=self._indptr[1:])
        return self._indptr

    @property
    def pull_indptr(self) -> np.ndarray:
        """Row pointers over the pull-ordered edges (segments of equal dst)."""
        if self._pull_indptr is None:
            self._pull_indptr = np.zeros(self.n + 1, dtype=np.int64)
            np.cumsum(self.in_degree, out=self._pull_indptr[1:])
        return self._pull_indptr

    def pull_arrays(self):
        """(src, dst, w) sorted by (dst, src). An undirected graph stores a
        symmetric edge set, so its pull order is the push order with the
        endpoint roles swapped."""
        if not self.directed:
            return self.dst, self.src, self.w
        if self._pull_cache is None:
            # the raw weight slot: an unweighted graph co-sorts no ones
            self._pull_cache = _sort_edges(self.src, self.dst, self._w_arr, self.n, "dst",
                                           False)
        s, d, w = self._pull_cache
        return s, d, (self.w if w is None else w)

    def symmetrized(self) -> "Graph":
        """Structure of A | A^T with unit weights (wcc.cpp:53-55), memoized;
        an undirected graph is its own."""
        if not self.directed:
            return self
        sym = self.memo.get("symmetrized")
        if sym is None:
            sym = Graph(self.n, np.concatenate([self.src, self.dst]),
                        np.concatenate([self.dst, self.src]), None, self.mapping,
                        directed=False, weighted=False)
            self.memo["symmetrized"] = sym
        return sym

    # ----------------------------------------------------------- device views

    def _device_view(self, kind: str, device, wdtype) -> COO:
        key = (kind, str(torch.device(device)), wdtype)
        view = self._device_views.get(key)
        if view is None:
            s, d, w = (self.src, self.dst, self.w) if kind == "push" else self.pull_arrays()
            view = COO(
                torch.from_numpy(s).to(device),
                torch.from_numpy(d).to(device),
                torch.from_numpy(w).to(device=device, dtype=wdtype),
            )
            self._device_views[key] = view
        return view

    def device_push(self, device, wdtype=torch.float32) -> COO:
        """Edges sorted by (src, dst) as tensors on ``device``."""
        return self._device_view("push", device, wdtype)

    def device_pull(self, device, wdtype=torch.float32) -> COO:
        """Edges sorted by (dst, src) as tensors on ``device``."""
        return self._device_view("pull", device, wdtype)

    # ------------------------------------------------------------------ misc

    def dense_source(self, original_source: int) -> int:
        """The dense id of an original source-vertex id (bfs.cpp:94-103)."""
        hits = np.nonzero(self.mapping == original_source)[0]
        if hits.size != 1:
            raise ValueError(f"source vertex {original_source} not in graph")
        return int(hits[0])

    def __repr__(self) -> str:
        kind = "directed" if self.directed else "undirected"
        return f"Graph(n={self.n}, nnz={self.nnz}, {kind}, weighted={self.weighted})"


def frontier_edge_positions(indptr: np.ndarray, frontier: np.ndarray):
    """Flat CSR positions of every edge leaving the ``frontier`` rows, and
    the row of each position: the host frontier expansion of the hybrid
    BFS and SSSP (one cumsum and two repeats, no loop over rows)."""
    lens = indptr[frontier + 1] - indptr[frontier]
    fe = int(lens.sum())
    offs = np.zeros(frontier.shape[0], dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    rows_rep = np.repeat(frontier, lens)
    pos = (np.arange(fe, dtype=np.int64) - np.repeat(offs, lens)
           + np.repeat(indptr[frontier], lens))
    return pos, rows_rep
