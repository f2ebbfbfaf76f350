"""Graph loading: text -> relabel -> cache -> Graph (counterpart of
graphtpu/ingest/loader.py); idempotent, with the skip-if-exists cache of
GraphblasLoader.java:39-65. A dataset directory that holds no vertex file
but the reference converter's graph.grb + graph.vtb loads from those."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from graphtpu_torch.core.graph import Graph
from graphtpu_torch.ingest import cache as cache_mod
from graphtpu_torch.ingest.grb import load_graph_grb
from graphtpu_torch.ingest.relabel import relabel
from graphtpu_torch.utils.config import GraphSpec
from graphtpu_torch.utils.logging import get_logger
from graphtpu_torch.utils.timers import ComputationTimer

log = get_logger("loader")


def load_graph(
    vertex_path: str,
    edge_path: str,
    directed: bool,
    weighted: bool,
    *,
    graph_name: Optional[str] = None,
    intermediate_dir: Optional[str] = None,
    use_cache: bool = True,
) -> Graph:
    """Load a graph, through the binary cache when possible."""
    cacheable = use_cache and graph_name is not None and intermediate_dir is not None
    if cacheable and cache_mod.exists(intermediate_dir, graph_name):
        try:
            with ComputationTimer("Loading the graph from binary cache"):
                return cache_mod.load(intermediate_dir, graph_name)
        except ValueError as e:  # stale cache version: rebuild
            log.warning("cache rejected (%s); re-ingesting", e)
    ds_dir = Path(vertex_path).parent
    if (not Path(vertex_path).exists() and (ds_dir / "graph.grb").exists()
            and (ds_dir / "graph.vtb").exists()):
        # the reference platform's binary files (converter.cpp:30-52)
        with ComputationTimer("Loading the graph from binary cache"):
            g = load_graph_grb(ds_dir, directed, weighted)
    else:
        with ComputationTimer("Loading the graph"):
            g = relabel(vertex_path, edge_path, directed, weighted)
    g.name = graph_name
    if cacheable:
        cache_mod.save(g, intermediate_dir, graph_name)
    return g


def load_graph_from_spec(
    spec: GraphSpec, intermediate_dir: Optional[str] = None, use_cache: bool = True
) -> Graph:
    return load_graph(
        spec.vertex_path,
        spec.edge_path,
        spec.directed,
        spec.weighted,
        graph_name=spec.name,
        intermediate_dir=intermediate_dir,
        use_cache=use_cache,
    )
