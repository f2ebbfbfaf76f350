"""Binary graph cache with a skip-if-exists contract (counterpart of
graphtpu/ingest/cache.py, same file format, so either package reads the
other's cache).

One ``intermediate/<graph>/graph.npz`` holds the dense-id push-ordered
edges and the mapping: everything needed to rebuild a Graph without
parsing text (load-graph.sh:50-67).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from graphtpu_torch.core.graph import Graph
from graphtpu_torch.utils.logging import get_logger

log = get_logger("cache")

CACHE_VERSION = 2


def cache_path(intermediate_dir: str | os.PathLike, graph_name: str) -> Path:
    return Path(intermediate_dir) / graph_name / "graph.npz"


def save(graph: Graph, intermediate_dir: str | os.PathLike, graph_name: str) -> Path:
    path = cache_path(intermediate_dir, graph_name)
    path.parent.mkdir(parents=True, exist_ok=True)
    # written under a per-process name and renamed: a reader never sees a
    # half-written file
    tmp = path.with_name(f"graph.{os.getpid()}.tmp.npz")
    arrays = dict(
        version=np.int64(CACHE_VERSION),
        n=np.int64(graph.n),
        directed=np.bool_(graph.directed),
        weighted=np.bool_(graph.weighted),
        src=graph.src,
        dst=graph.dst,
        mapping=graph.mapping,
    )
    if graph.weighted:
        arrays["w"] = graph.w
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    meta = {
        "version": CACHE_VERSION,
        "n": graph.n,
        "nnz": graph.nnz,
        "directed": graph.directed,
        "weighted": graph.weighted,
    }
    (path.parent / "graph.json").write_text(json.dumps(meta, indent=2))
    log.info("cached %s -> %s (%d vertices, %d stored edges)", graph_name, path, graph.n, graph.nnz)
    return path


def exists(intermediate_dir: str | os.PathLike, graph_name: str) -> bool:
    return cache_path(intermediate_dir, graph_name).exists()


def load(intermediate_dir: str | os.PathLike, graph_name: str) -> Graph:
    path = cache_path(intermediate_dir, graph_name)
    with np.load(path) as z:
        if int(z["version"]) != CACHE_VERSION:
            raise ValueError(f"{path}: cache version mismatch")
        g = Graph.from_arrays(
            int(z["n"]), z["src"], z["dst"], z["w"] if "w" in z.files else None,
            z["mapping"], directed=bool(z["directed"]), weighted=bool(z["weighted"]),
        )
    g.name = graph_name
    log.info("loaded cache %s (%s)", path, g)
    return g
