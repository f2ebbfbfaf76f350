"""Edge/vertex list parsing and dense-id relabeling (counterpart of
graphtpu/ingest/relabel.py).

A .v file holds one original vertex id per line; a .e file holds
``src dst [weight]`` lines. Dense ids follow the vertex-file order and the
mapping keeps the inverse (bin/py/relabel.py:37-61).

Parsers, fastest first: the native C++ parser (``ingest/native.py``),
then numpy's. A file the native parser refuses is parsed by numpy, with a
warning, so both arms give the same arrays for any file numpy takes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import ORIGINAL_ID_DTYPE
from graphtpu_torch.ingest import native
from graphtpu_torch.utils.logging import get_logger

log = get_logger("ingest")


def _parse_vertices_numpy(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=ORIGINAL_ID_DTYPE, ndmin=1)


def _parse_edges_numpy(path: str, weighted: bool):
    # ids parse as int64 directly: a float64 round-trip corrupts ids above 2^53
    ids = np.loadtxt(path, dtype=ORIGINAL_ID_DTYPE, usecols=(0, 1), ndmin=2)
    if ids.size == 0:
        return (
            np.empty(0, ORIGINAL_ID_DTYPE),
            np.empty(0, ORIGINAL_ID_DTYPE),
            np.empty(0, np.float64) if weighted else None,
        )
    src = np.ascontiguousarray(ids[:, 0])
    dst = np.ascontiguousarray(ids[:, 1])
    w = np.loadtxt(path, dtype=np.float64, usecols=(2,), ndmin=1) if weighted else None
    return src, dst, w


def parse_vertex_file(path: str) -> np.ndarray:
    if native.available():
        try:
            return native.parse_vertices(path)
        except native.NativeRefused as e:
            log.warning("%s; parsing it with numpy", e)
    return _parse_vertices_numpy(path)


def parse_edge_file(path: str, weighted: bool):
    if native.available():
        try:
            return native.parse_edges(path, weighted)
        except native.NativeRefused as e:
            log.warning("%s; parsing it with numpy", e)
    return _parse_edges_numpy(path, weighted)


def relabel(vertex_path: str, edge_path: str, directed: bool, weighted: bool) -> Graph:
    """Parse .v/.e files and build a dense-id Graph."""
    vertex_path, edge_path = str(vertex_path), str(edge_path)
    for p in (vertex_path, edge_path):
        if not Path(p).exists():
            raise FileNotFoundError(p)
    vids = parse_vertex_file(vertex_path)
    src, dst, w = parse_edge_file(edge_path, weighted)
    log.info(
        "relabel: %d vertices, %d edges (%s, %s)",
        vids.shape[0], src.shape[0],
        "directed" if directed else "undirected",
        "weighted" if weighted else "unweighted",
    )
    return Graph.from_original_ids(vids, src, dst, w, directed, weighted)
