"""MatrixMarket interop (counterpart of graphtpu/ingest/mm.py): format
parity with the reference's intermediate artifacts.

The reference's ingest writes graph.mtx (MatrixMarket coordinate, 1-based,
with a %%GraphBLAS type comment) + graph.vtx (dense→original id bijection,
one id per line) — bin/py/relabel.py:52-79 — and reads them back via
LAGraph_MMRead (src/main/c/src/graphio.cpp:10-29). The port's own cache
is .npz, but these readers/writers keep the artifact formats exchangeable
with GraphBLAS tooling.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import ORIGINAL_ID_DTYPE


def write_vtx(graph: Graph, path: str | Path) -> None:
    """graph.vtx: one original id per line, ordered by dense id
    (relabel.py:52-61)."""
    with open(path, "w") as f:
        for v in graph.mapping:
            f.write(f"{v}\n")


def read_vtx(path: str | Path) -> np.ndarray:
    return np.loadtxt(path, dtype=ORIGINAL_ID_DTYPE, ndmin=1)


def write_mtx(graph: Graph, path: str | Path) -> None:
    """graph.mtx: MatrixMarket coordinate file over dense 1-based ids with
    the %%GraphBLAS type comment (relabel.py:63-79). Directed graphs are
    written `general`; undirected graphs `symmetric` with each edge once
    (canonical lower-triangle-free form: src <= dst)."""
    weighted = graph.weighted
    field = "real" if weighted else "integer"
    symmetry = "general" if graph.directed else "symmetric"
    grb_type = "GrB_FP64" if weighted else "GrB_BOOL"
    src, dst, w = graph.src, graph.dst, graph.w
    if not graph.directed:
        keep = src <= dst
        src, dst, w = src[keep], dst[keep], w[keep]
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write(f"%%GraphBLAS {grb_type}\n")
        f.write(f"{graph.n} {graph.n} {src.shape[0]}\n")
        if weighted:
            for s, d, x in zip(src, dst, w):
                f.write(f"{s + 1} {d + 1} {x}\n")
        else:
            for s, d in zip(src, dst):
                f.write(f"{s + 1} {d + 1} 1\n")


def read_mtx(path: str | Path, mapping: Optional[np.ndarray] = None) -> Graph:
    """Parse a MatrixMarket coordinate file into a Graph (LAGraph_MMRead
    analogue for the coordinate real/integer/pattern cases the platform
    produces)."""
    header = None
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("%"):
                if header is None and line.lower().startswith("%%matrixmarket"):
                    header = line.lower().split()
                continue
            rows.append(line)
    if header is None:
        raise ValueError(f"{path}: missing MatrixMarket banner")
    if header[1:3] != ["matrix", "coordinate"]:
        raise ValueError(f"{path}: only coordinate matrices supported")
    field = header[3]
    symmetry = header[4]

    n_rows, n_cols, nnz = (int(t) for t in rows[0].split())
    if n_rows != n_cols:
        raise ValueError(f"{path}: adjacency matrices must be square")
    data = rows[1:]
    if len(data) != nnz:
        raise ValueError(f"{path}: expected {nnz} entries, found {len(data)}")

    s0 = np.empty(nnz, dtype=np.int64)
    d0 = np.empty(nnz, dtype=np.int64)
    w = np.ones(nnz, dtype=np.float64)
    has_value = field in ("real", "integer")
    for i, line in enumerate(data):
        parts = line.split()
        s0[i] = int(parts[0]) - 1
        d0[i] = int(parts[1]) - 1
        if has_value and len(parts) > 2:
            w[i] = float(parts[2])

    directed = symmetry == "general"
    weighted = field == "real"
    if mapping is None:
        mapping = np.arange(1, n_rows + 1, dtype=ORIGINAL_ID_DTYPE)
    if directed:
        src, dst = s0, d0
    else:
        non_loop = s0 != d0
        src = np.concatenate([s0, d0[non_loop]])
        dst = np.concatenate([d0, s0[non_loop]])
        w = np.concatenate([w, w[non_loop]])
    return Graph(n_rows, src, dst, w if weighted else None, mapping, directed, weighted)
