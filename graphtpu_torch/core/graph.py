"""Host graph container (counterpart of graphtpu/core/graph.py).

Dense int32 vertex ids with the sparse original ids kept in ``mapping``
(the reference's graph.vtx/.vtb design). Edges are stored deduplicated in
push order, sorted by (src, dst); undirected inputs are stored in both
directions. ``pull_arrays`` gives the (dst, src) order that per-vertex
reductions over in-edges key on, and ``device_push``/``device_pull`` give
torch views of either order on a device the caller names.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from graphtpu_torch.core.types import INDEX_DTYPE, ORIGINAL_ID_DTYPE


class COO(NamedTuple):
    """A device edge stream. ``w`` is all-ones for unweighted graphs."""

    src: torch.Tensor  # int32 [nnz]
    dst: torch.Tensor  # int32 [nnz]
    w: torch.Tensor    # float [nnz]


def _lexsort_edges(src: np.ndarray, dst: np.ndarray, primary: str) -> np.ndarray:
    """Permutation sorting edges by (primary, secondary). When both id
    ranges fit 31 bits the two keys pack into one int64 and a STABLE
    argsort keeps the keep-first dedupe semantics for duplicate edges."""
    a, b = (src, dst) if primary == "dst" else (dst, src)
    # a = secondary, b = primary
    if (
        src.size
        and src.min() >= 0
        and dst.min() >= 0
        and max(int(src.max()), int(dst.max())) < (1 << 31)
    ):
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
            perm = _lexsort_edges(src, dst, "src")
            src, dst = src[perm], dst[perm]
            if w is not None:
                w = w[perm]
            keep = np.empty(src.shape[0], dtype=bool)
            keep[0] = True
            np.logical_or(src[1:] != src[:-1], dst[1:] != dst[:-1], out=keep[1:])
            if not keep.all():
                src, dst = src[keep], dst[keep]
                if w is not None:
                    w = w[keep]
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
            p = _lexsort_edges(self.src, self.dst, "dst")
            w_raw = self._w_arr
            self._pull_cache = (
                self.src[p], self.dst[p], None if w_raw is None else w_raw[p]
            )
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
