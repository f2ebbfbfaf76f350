"""Route algorithm requests to the distributed loops (counterpart of
graphtpu/parallel/dispatch.py).

``run_algorithm`` calls ``try_run_distributed`` when ``num-devices`` > 1.
It runs every algorithm over the ranks under every impl name the
one-device path takes, routed as the JAX package routes it
(``parallel/algorithms.py``): the JAX defaults run the slab, adaptive and
wedge loops, and ``segment``/``scan``, ``dense``/``device``, ``sort`` and
``sweep`` the naive ones. An impl name the port does not know raises
ValueError, as on one device. With ``shard-checkpoints`` on (the default), a
named graph's sharded views persist under ``intermediate-dir``
(``ShardedGraph.ckpt``, ``checkpoint.py``).
"""

from __future__ import annotations

import importlib
from typing import Optional

import numpy as np

from graphtpu_torch.algorithms.common import AlgorithmResult
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF, UNREACHABLE
from graphtpu_torch.parallel import algorithms as dist
from graphtpu_torch.parallel.mesh import close_mesh, make_mesh
from graphtpu_torch.parallel.partition import ShardedGraph
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
from graphtpu_torch.utils.logging import get_logger

log = get_logger("dispatch")

# algorithm -> the config attribute of its impl; graphtpu_torch.algorithms.<name>.IMPLS
# lists the names the port takes
IMPL_ATTRS = {name: f"{name}_impl" for name in ("pr", "cdlp", "bfs", "sssp", "wcc", "lcc")}

_sharded_cache: dict = {}


def purge_sharded(graph: Graph) -> None:
    """Release the sharded views of ``graph`` on every rank; with the last
    one gone, the mesh's workers stop too. Called from
    ``GraphTorchPlatform.delete_graph``."""
    for key in [k for k in _sharded_cache if k[0] == id(graph)]:
        _sharded_cache.pop(key).release()
    if not _sharded_cache:
        close_mesh()


def _sharded(graph: Graph, cfg: PlatformConfig, wdtype) -> ShardedGraph:
    mesh = make_mesh(cfg.num_devices, cfg.device)
    key = (id(graph), cfg.num_devices, np.dtype(wdtype).name)
    sg = _sharded_cache.get(key)
    if sg is None or sg.mesh is not mesh:  # a new mesh holds none of the old blocks
        sg = _sharded_cache[key] = ShardedGraph(graph, mesh, wdtype=wdtype)
        if cfg.shard_checkpoints and getattr(graph, "name", None):
            sg.ckpt = (cfg.intermediate_dir, graph.name)
    return sg


def _source(name: str, graph: Graph, params: AlgorithmParams) -> int:
    if params.source_vertex is None:
        raise ValueError(f"{name} requires source-vertex")
    return graph.dense_source(params.source_vertex)


def try_run_distributed(name: str, graph: Graph, params: AlgorithmParams,
                        cfg: PlatformConfig) -> Optional[AlgorithmResult]:
    """Run ``name`` over ``cfg.num_devices`` ranks; None for an algorithm
    without a distributed loop (the caller runs the one-device path)."""
    if name not in IMPL_ATTRS:
        log.info("no distributed implementation of %s: the one-device path runs", name)
        return None
    attr = IMPL_ATTRS[name]
    impls = importlib.import_module(f"graphtpu_torch.algorithms.{name}").IMPLS
    impl = getattr(cfg, attr)
    if impl not in impls:
        raise ValueError(f"unknown {attr.replace('_', '-')} {impl!r}; expected {'|'.join(impls)}")
    wdtype = np.float64 if cfg.precision == "float64" else np.float32
    sg = _sharded(graph, cfg, wdtype)
    if name == "pr":
        if params.damping_factor is None or params.num_iterations is None:
            raise ValueError("pr requires damping-factor and num-iterations")
        ranks = dist.pr_dist(sg, params.damping_factor, params.num_iterations, dtype=wdtype,
                             cfg=cfg)
        return AlgorithmResult("pr", ranks.astype(np.float64), iterations=params.num_iterations)
    if name == "bfs":
        levels, it = dist.bfs_dist(sg, _source("bfs", graph, params), cfg)
        levels = levels.astype(np.int64)
        levels[levels == INT32_INF] = UNREACHABLE
        return AlgorithmResult("bfs", levels, iterations=it)
    if name == "sssp":
        if params.weight_property not in (None, "weight"):
            raise ValueError(f"unsupported sssp weight-property {params.weight_property!r}; "
                             "only 'weight' exists in the ingested graph")
        d, it = dist.sssp_dist(sg, _source("sssp", graph, params), cfg)
        return AlgorithmResult("sssp", d, iterations=it)
    if name == "wcc":
        labels, it = dist.wcc_dist(sg, cfg)
        return AlgorithmResult("wcc", graph.mapping[labels], iterations=it)
    if name == "cdlp":
        if params.max_iterations is None:
            raise ValueError("cdlp requires max-iterations")
        labels, it = dist.cdlp_dist(sg, params.max_iterations, cfg)
        return AlgorithmResult("cdlp", graph.mapping[labels], iterations=it)
    return AlgorithmResult("lcc", dist.lcc_dist(sg, cfg))
