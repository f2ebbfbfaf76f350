"""SuiteSparse/LAGraph ``.grb`` + ``.vtb`` binary graph files (counterpart of
graphtpu/ingest/grb.py, the same byte layout, so either package reads the
other's files).

The reference platform's converter caches each ingested graph as
``graph.grb`` (a serialized GraphBLAS matrix, include/graphio.h
binwrite/binread) and ``graph.vtb`` (the dense-id -> original-id mapping as
little-endian uint64 records, src/graphio.cpp:40-49). Layout of a ``.grb``:

    512-byte informational ASCII header (ignored by readers)
    fmt       int32   GxB_BY_ROW=0 (CSR) | GxB_BY_COL=1 (CSC)
    kind      int32   1=hypersparse, 0/2=sparse, 4=bitmap, 8=full;
                      +100 when the value array is iso (one entry)
    hyper     f64     hyper-switch (ignored on read)
    nrows     u64
    ncols     u64
    nonempty  i64     informational (-1 = unknown)
    nvec      u64     stored rows (CSR) / columns (CSC)
    nvals     u64
    typecode  int32   0=BOOL 1=INT8 2=INT16 3=INT32 4=INT64 5=UINT8
                      6=UINT16 7=UINT32 8=UINT64 9=FP32 10=FP64
    typesize  u64     bytes of one value
    [sparse]      Ap[nvec+1] u64, Ai[nvals] u64, Ax[nvals | 1 if iso]
    [hypersparse] Ap[nvec+1] u64, Ah[nvec] u64, Ai[nvals] u64, Ax[...]

Only the sparse and hypersparse kinds are read (the converter writes no
other); bitmap and full raise. Everything is numpy on the host.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HEADER_LEN = 512
# each scalar is written on its own, so the stream is packed: 68 bytes
_SCALARS = struct.Struct("<iidQQqQQiQ")

_TYPECODES = {
    0: np.dtype(np.bool_), 1: np.dtype(np.int8), 2: np.dtype(np.int16),
    3: np.dtype(np.int32), 4: np.dtype(np.int64), 5: np.dtype(np.uint8),
    6: np.dtype(np.uint16), 7: np.dtype(np.uint32), 8: np.dtype(np.uint64),
    9: np.dtype(np.float32), 10: np.dtype(np.float64),
}
_CODE_OF = {v: k for k, v in _TYPECODES.items()}
_TYPENAMES = {
    0: "GrB_BOOL  ", 3: "GrB_INT32 ", 4: "GrB_INT64 ", 9: "GrB_FP32  ", 10: "GrB_FP64  ",
}


def read_vtb(path) -> np.ndarray:
    """graph.vtb -> original vertex ids in dense-id order, uint64."""
    return np.fromfile(path, dtype="<u8")


def write_vtb(path, mapping: np.ndarray) -> None:
    np.asarray(mapping, dtype="<u8").tofile(path)


def read_grb(path) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], int, int, bool]:
    """A ``.grb`` matrix -> (indptr [major + 1] int64, indices int64, values
    or None for a bool/pattern matrix, nrows, ncols, by_row). A hypersparse
    matrix is expanded to a dense-major indptr."""
    raw = Path(path).read_bytes()
    if len(raw) < _HEADER_LEN + _SCALARS.size:
        raise ValueError(f"{path}: truncated .grb (len {len(raw)})")
    off = _HEADER_LEN
    (fmt, kind, _hyper, nrows, ncols, _nonempty, nvec, nvals,
     typecode, typesize) = _SCALARS.unpack_from(raw, off)
    off += _SCALARS.size

    iso = kind >= 100  # the converter's unweighted pattern form
    if iso:
        kind -= 100
    is_hyper = kind == 1
    if not (is_hyper or kind in (0, 2)):
        raise ValueError(f"{path}: kind {kind} (bitmap/full) is not written by the reference "
                         f"converter and not supported")
    if typecode not in _TYPECODES:
        raise ValueError(f"{path}: unknown typecode {typecode}")
    dtype = _TYPECODES[typecode]
    if dtype.itemsize != typesize:
        raise ValueError(f"{path}: typesize {typesize} != {dtype} itemsize")

    def take(count, dt):
        nonlocal off
        arr = np.frombuffer(raw, dtype=dt, count=count, offset=off)
        off += count * np.dtype(dt).itemsize
        return arr

    ap = take(nvec + 1, "<u8")
    ah = take(nvec, "<u8") if is_hyper else None
    ai = take(nvals, "<u8")
    ax = take(1 if iso else nvals, dtype.newbyteorder("<"))
    if iso and nvals:
        ax = np.broadcast_to(ax, (nvals,))

    n_major = nrows if fmt == 0 else ncols
    if is_hyper:
        # rows absent from Ah are empty
        counts = np.zeros(n_major, dtype=np.int64)
        counts[ah.astype(np.int64)] = np.diff(ap.astype(np.int64))
        indptr = np.zeros(n_major + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
    else:
        if nvec != n_major:
            raise ValueError(f"{path}: sparse nvec {nvec} != {n_major}")
        indptr = ap.astype(np.int64)
    values = None if typecode == 0 else np.array(ax)
    return indptr, ai.astype(np.int64), values, int(nrows), int(ncols), fmt == 0


def write_grb(path, indptr: np.ndarray, indices: np.ndarray, values: Optional[np.ndarray],
              nrows: int, ncols: int, *, by_row: bool = True,
              comments: str = "graphtpu converter") -> None:
    """Write a sparse CSR (or CSC) matrix in the reference's byte layout;
    ``values=None`` writes an iso GrB_BOOL pattern matrix (the converter's
    form for unweighted graphs)."""
    nvals = int(indices.shape[0])
    nvec = int(indptr.shape[0]) - 1
    if values is None:
        typecode, ax, iso = 0, np.array([True]), True
    else:
        values = np.asarray(values)
        typecode, ax, iso = _CODE_OF[values.dtype], values, False
    dtype = _TYPECODES[typecode]
    header = (
        "SuiteSparse:GraphBLAS matrix\nv%-25s\n"
        "nrows:  %-18d\nncols:  %-18d\nnvec:   %-18d\nnvals:  %-18d\n"
        "format: %-8s\nsize:   %-18d\ntype:   %-72s\niso:    %1d\n"
        "%-210s\n\n"
    ) % ("graphtpu (LAGraph-compatible)", nrows, ncols, nvec, nvals,
         "CSR" if by_row else "CSC", dtype.itemsize,
         _TYPENAMES.get(typecode, f"typecode {typecode}"), int(iso), comments[:210])
    hb = header.encode("ascii", "replace")[: _HEADER_LEN - 1]
    hb = hb + b" " * (_HEADER_LEN - 1 - len(hb)) + b"\0"

    with open(path, "wb") as f:
        f.write(hb)
        f.write(_SCALARS.pack(
            0 if by_row else 1,          # fmt
            (2 + 100) if iso else 2,     # kind: GxB_SPARSE (+100 iso)
            0.0625,                      # hyper switch (informational)
            nrows, ncols,
            -1,                          # nonempty: unknown
            nvec, nvals, typecode, dtype.itemsize,
        ))
        np.asarray(indptr, dtype="<u8").tofile(f)
        np.asarray(indices, dtype="<u8").tofile(f)
        np.asarray(ax, dtype=dtype.newbyteorder("<")).tofile(f)


def load_graph_grb(input_dir, directed: bool, weighted: bool):
    """The port's Graph from a directory holding graph.grb + graph.vtb (the
    reference's ReadMatrixBinary + ReadMapping, src/graphio.cpp:24-56)."""
    from graphtpu_torch.core.graph import Graph

    d = Path(input_dir)
    indptr, indices, values, nrows, ncols, by_row = read_grb(d / "graph.grb")
    mapping = read_vtb(d / "graph.vtb")
    if nrows != ncols:
        raise ValueError(f"adjacency must be square, got {nrows}x{ncols}")
    major = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(indptr))
    src, dst = (major, indices) if by_row else (indices, major)
    w = None
    if weighted:
        if values is None:
            raise ValueError("weighted graph but the .grb holds a pattern matrix")
        w = values.astype(np.float64)
    # an undirected matrix stores both orientations; Graph dedupes pairs
    return Graph(nrows, src, dst, w, mapping, directed=directed, weighted=weighted)


def save_graph_grb(graph, out_dir) -> None:
    """Write a Graph as graph.grb + graph.vtb, readable by the reference
    platform's binary path."""
    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    values = graph.w.astype(np.float64) if graph.weighted else None
    write_grb(d / "graph.grb", graph.indptr.astype(np.uint64), graph.dst, values,
              graph.n, graph.n, by_row=True)
    write_vtb(d / "graph.vtb", graph.mapping)
