"""Algorithm registry, results and serialization (counterpart of
graphtpu/algorithms/common.py).

``run_algorithm`` is the skeleton every reference binary shares: run the
kernel, hand back per-vertex results in dense-id order. The serializer
writes ``original_id value`` lines in the C++ serializers' exact formats
(int64-max for unreachable BFS, literal "infinity" for SSSP, %.15e for
floats — bfs.cpp:47-64, sssp.cpp:37-47, pr.cpp:27-44), with numpy only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import UNREACHABLE
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
from graphtpu_torch.utils.timers import ComputationTimer


@dataclasses.dataclass
class AlgorithmResult:
    """Per-vertex results in dense-id order plus metadata."""

    algorithm: str
    values: np.ndarray            # dense-id order, one value per vertex
    iterations: Optional[int] = None

    def _columns(self, graph: Graph):
        """(ids, values) with the per-algorithm output coercions applied
        (int64-max unreachable for BFS, bfs.cpp:61)."""
        vals = np.asarray(self.values)
        if self.algorithm == "bfs":
            v = vals.astype(np.int64, copy=False)
            vals = np.where((v < 0) | (v >= UNREACHABLE), UNREACHABLE, v)
        elif self.algorithm in ("wcc", "cdlp"):
            vals = vals.astype(np.uint64, copy=False)
        else:
            vals = vals.astype(np.float64, copy=False)
        return graph.mapping, vals

    def write(self, graph: Graph, path: str) -> None:
        """Serialize ``original_id value`` per line, in chunks."""
        ids, vals = self._columns(graph)
        line = "%d %.15e\n" if vals.dtype.kind == "f" else "%d %d\n"
        chunk = 1 << 20
        with open(path, "w") as f:
            for a in range(0, graph.n, chunk):
                i, v = ids[a : a + chunk], vals[a : a + chunk]
                pairs = np.empty(2 * i.shape[0], dtype=object)
                pairs[0::2] = i.tolist()
                pairs[1::2] = v.tolist()
                s = (line * i.shape[0]) % tuple(pairs)
                if self.algorithm == "sssp":
                    # %.15e renders inf as "inf"; the contract is the
                    # literal "infinity" (sssp.cpp:45)
                    s = s.replace(" inf\n", " infinity\n")
                f.write(s)


# name -> fn(graph, params, cfg), filled by each algorithm module at import
ALGORITHMS: Dict[str, Callable[[Graph, AlgorithmParams, PlatformConfig], AlgorithmResult]] = {}


def register(name: str):
    def deco(fn):
        ALGORITHMS[name] = fn
        return fn

    return deco


def run_algorithm(
    name: str,
    graph: Graph,
    params: Optional[AlgorithmParams] = None,
    cfg: Optional[PlatformConfig] = None,
) -> AlgorithmResult:
    """Run one algorithm (no processing markers: the harness owns the
    processing-time window, bfs.cpp:105-107)."""
    import graphtpu_torch.algorithms.bfs  # noqa: F401  (registers)
    import graphtpu_torch.algorithms.cdlp  # noqa: F401  (registers)
    import graphtpu_torch.algorithms.lcc  # noqa: F401  (registers)
    import graphtpu_torch.algorithms.pr  # noqa: F401  (registers)
    import graphtpu_torch.algorithms.sssp  # noqa: F401  (registers)
    import graphtpu_torch.algorithms.wcc  # noqa: F401  (registers)

    name = name.lower()
    if name not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {name!r}; graphtpu_torch has {sorted(ALGORITHMS)}")
    params = params or AlgorithmParams()
    cfg = cfg or PlatformConfig()
    if cfg.fault_injection == f"hang:{name}":
        # platform.graphtpu.fault-injection: a job that never returns, as a
        # wedged kernel would, so that the timeout and kill paths run
        while True:
            time.sleep(3600)
    with ComputationTimer(f"Processing ({name})"):
        if cfg.num_devices > 1:
            from graphtpu_torch.parallel.dispatch import try_run_distributed

            result = try_run_distributed(name, graph, params, cfg)
            if result is not None:
                return result
        return ALGORITHMS[name](graph, params, cfg)


def float_dtype(cfg: PlatformConfig) -> torch.dtype:
    return torch.float64 if cfg.precision == "float64" else torch.float32
