"""ctypes binding of the native C++ ingest library (counterpart of
graphtpu/ingest/native.py).

The library is the repository's one source, ``native/graphtpu_io.cpp``:
mmap'd, multi-threaded parsing of .v/.e text, an O(m + n) stable counting
sort of edge streams, and the fused relabel (hash join, undirected
doubling, radix sort, keep-first dedup). It is compiled at first use by
the host C++ compiler (``c++``, else ``g++``) with the flags of
``native/Makefile`` into ``build/graphtpu_torch/`` at the root of the
checkout, never into ``native/``. The file name carries a hash of the
source and the flags; the build runs under an exclusive file lock and the
library appears by an atomic rename, so concurrent first use builds once
and no process loads a half-written file.

``GRAPHTPU_NATIVE_LIB`` names a built library to load instead, or
``/dev/null`` to turn the library off. Off (that setting, or no C++
compiler on the machine), the numpy parsers and sorts serve, after one
logged warning. A compiler that fails to build the source, or a library
that fails to load, raises with the reason.

``call_counts`` counts the calls into the library per exported function.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from graphtpu_torch.utils.logging import get_logger

log = get_logger("native")

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "graphtpu_io.cpp"
BUILD_DIR = ROOT / "build" / "graphtpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
FUNCTIONS = ("gtio_count_lines", "gtio_parse_vertices", "gtio_parse_edges",
             "gtio_sort_edges", "gtio_relabel_edges")

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64, _I32 = ctypes.c_int64, ctypes.c_int32
_SIGNATURES = {  # the argtypes of graphtpu/ingest/native.py
    "gtio_count_lines": (ctypes.c_char_p,),
    # path, out, cap
    "gtio_parse_vertices": (ctypes.c_char_p, _I64P, _I64),
    # path, weighted, src, dst, w, cap
    "gtio_parse_edges": (ctypes.c_char_p, _I32, _I64P, _I64P, _F64P, _I64),
    # m, n, src, dst, w (may be null), has_w, dedup
    "gtio_sort_edges": (_I64, _I64, _I32P, _I32P, _F64P, _I32, _I32),
    # n, vids, m, esrc, edst, w (may be null), has_w, directed, out_src, out_dst, out_w, cap
    "gtio_relabel_edges": (_I64, _I64P, _I64, _I64P, _I64P, _F64P, _I32, _I32,
                           _I32P, _I32P, _F64P, _I64),
}

call_counts = dict.fromkeys(FUNCTIONS, 0)
build_seconds = None  # seconds the last compile took; None = not compiled here
_libs: dict = {}  # GRAPHTPU_NATIVE_LIB's value -> CDLL, or None when off
_lock = threading.Lock()


class NativeRefused(ValueError):
    """The native parser refused a file (malformed for it, or too large)."""


def reset_call_counts() -> None:
    for k in call_counts:
        call_counts[k] = 0


def _compiler() -> Optional[str]:
    return shutil.which("c++") or shutil.which("g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgraphtpu_io_{h.hexdigest()[:16]}.so"


def build(cxx: str) -> Path:
    """Compile the native source with ``cxx`` unless this build exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native ingest build failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
        build_seconds = time.perf_counter() - t0
    return out


def _open(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int64
    return lib


def _load() -> Optional[ctypes.CDLL]:
    env = os.environ.get("GRAPHTPU_NATIVE_LIB")
    with _lock:
        if env in _libs:
            return _libs[env]
        if env == os.devnull:
            log.warning("GRAPHTPU_NATIVE_LIB=%s: the native ingest library is off; "
                        "numpy parses and sorts", env)
            lib = None
        elif env:
            lib = _open(env)
        else:
            cxx = _compiler()
            if cxx is None:
                log.warning("no C++ compiler (c++, g++) on PATH: the native ingest "
                            "library is off; numpy parses and sorts")
                lib = None
            else:
                lib = _open(str(build(cxx)))
        _libs[env] = lib
        return lib


def available() -> bool:
    return _load() is not None


def _call(name: str, *args) -> int:
    rc = getattr(_load(), name)(*args)
    call_counts[name] += 1
    return rc


def _count_lines(path: str) -> int:
    n = _call("gtio_count_lines", path.encode())
    if n < 0:
        raise OSError(f"native parser failed to open {path}")
    return n


def parse_vertices(path: str) -> np.ndarray:
    """One int64 id per non-empty line; raises NativeRefused on content the
    native parser does not take."""
    n = _count_lines(path)
    out = np.empty(n, dtype=np.int64)
    got = _call("gtio_parse_vertices", path.encode(), out.ctypes.data_as(_I64P), n)
    if got < 0:
        raise NativeRefused(f"native parser refused {path} ({got})")
    return out[:got]


def parse_edges(path: str, weighted: bool) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """``src dst [weight]`` lines as int64 ids and float64 weights (None
    when unweighted); raises NativeRefused on content the native parser
    does not take."""
    n = _count_lines(path)
    src = np.empty(n, dtype=np.int64)
    dst = np.empty(n, dtype=np.int64)
    w = np.empty(n if weighted else 0, dtype=np.float64)
    got = _call("gtio_parse_edges", path.encode(), 1 if weighted else 0,
                src.ctypes.data_as(_I64P), dst.ctypes.data_as(_I64P),
                w.ctypes.data_as(_F64P), n)
    if got < 0:
        raise NativeRefused(f"native parser refused {path} ({got})")
    return src[:got], dst[:got], (w[:got] if weighted else None)


def sort_edges(src: np.ndarray, dst: np.ndarray, w: Optional[np.ndarray], n: int,
               dedup: bool):
    """Sort by (src, dst), stable, with optional keep-first dedup, by the
    native counting sort: the semantics of the numpy lexsort in
    core/graph.py. The native call sorts in place, so the inputs are
    copied. Returns (src int32, dst int32, w float64 | None) at the
    post-dedup length, or None when the native sort declines: ids outside
    [0, n) (-1), or an allocation failure (-5). The numpy sort takes any
    input."""
    src = np.array(src, dtype=np.int32, copy=True)
    dst = np.array(dst, dtype=np.int32, copy=True)
    if w is not None:
        w = np.array(w, dtype=np.float64, copy=True)
    k = _call("gtio_sort_edges", src.shape[0], int(n), src.ctypes.data_as(_I32P),
              dst.ctypes.data_as(_I32P), _F64P() if w is None else w.ctypes.data_as(_F64P),
              0 if w is None else 1, 1 if dedup else 0)
    if k < 0:
        log.info("native sort declined (%d); numpy sorts", k)
        return None
    return src[:k], dst[:k], (None if w is None else w[:k])


def relabel_edges(vertex_ids: np.ndarray, esrc: np.ndarray, edst: np.ndarray,
                  w: Optional[np.ndarray], directed: bool):
    """Original-id edges -> dense-id COO sorted by (src, dst), keep-first
    deduplicated, undirected inputs doubled: Graph.from_original_ids's
    result and its errors. Returns (src int32, dst int32, w float64 | None),
    or None when the native path declines (allocation failure, or a vertex
    id equal to the hash sentinel INT64_MIN): the numpy path takes any
    input."""
    vertex_ids = np.ascontiguousarray(vertex_ids, dtype=np.int64)
    esrc = np.ascontiguousarray(esrc, dtype=np.int64)
    edst = np.ascontiguousarray(edst, dtype=np.int64)
    if w is not None:
        w = np.ascontiguousarray(w, dtype=np.float64)
    m = esrc.shape[0]
    cap = m if directed else 2 * m
    out_src = np.empty(cap, dtype=np.int32)
    out_dst = np.empty(cap, dtype=np.int32)
    out_w = np.empty(cap if w is not None else 0, dtype=np.float64)
    k = _call("gtio_relabel_edges", vertex_ids.shape[0], vertex_ids.ctypes.data_as(_I64P), m,
              esrc.ctypes.data_as(_I64P), edst.ctypes.data_as(_I64P),
              _F64P() if w is None else w.ctypes.data_as(_F64P), 0 if w is None else 1,
              1 if directed else 0, out_src.ctypes.data_as(_I32P),
              out_dst.ctypes.data_as(_I32P), out_w.ctypes.data_as(_F64P), cap)
    if k == -4:
        raise ValueError("duplicate vertex ids in vertex file")
    if k == -2:
        raise ValueError("edge references unknown vertex id")
    if k == -3:
        raise ValueError("undirected input lists an edge twice with conflicting weights")
    if k in (-5, -6):
        log.info("native relabel declined (%d); numpy relabels", k)
        return None
    if k < 0:
        raise ValueError(f"native relabel failed ({k})")
    return out_src[:k], out_dst[:k], (out_w[:k] if w is not None else None)
