"""Platform lifecycle (counterpart of graphtpu/harness/platform.py): the
in-process analogue of the reference's Java ``Platform``
(GraphblasPlatform.java:27-165), with the same metric contract
(Processing starts/ends markers around the kernel) and cache layout
(./intermediate/<graph>/).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional

import torch

from graphtpu_torch.algorithms.common import AlgorithmResult, run_algorithm
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.harness.collector import Collector
from graphtpu_torch.ingest import cache as cache_mod
from graphtpu_torch.ingest.loader import load_graph_from_spec
from graphtpu_torch.utils.config import GraphSpec, PlatformConfig
from graphtpu_torch.utils.logging import get_logger
from graphtpu_torch.utils.timers import proc_time_end, proc_time_start

log = get_logger("platform")

PLATFORM_NAME = "graphtpu_torch"


@dataclasses.dataclass
class BenchmarkMetrics:
    """Processing time in seconds (3-decimal ceiling), the one
    first-class metric (GraphblasCollector.java:87-91)."""

    processing_time_seconds: float = -1.0
    makespan_seconds: float = -1.0
    iterations: Optional[int] = None


class GraphTorchPlatform:
    """verify_setup / load_graph / prepare / startup / run / finalize /
    delete_graph / terminate. Every tensor lives on ``config.device``."""

    def __init__(self, config: Optional[PlatformConfig] = None):
        self.config = config or PlatformConfig()
        self.graphs: Dict[str, Graph] = {}
        self.collector = Collector()
        self._prepared: set = set()
        self._traces = 0  # processing windows traced under profile_dir

    def verify_setup(self) -> None:
        """Log the configured device; raise if it is a CUDA device that
        this process cannot use. A tensor is made on it, so a card that
        refuses this process a context fails here, not inside a job."""
        device = torch.device(self.config.device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device} configured, but CUDA is not available")
            idx = device.index if device.index is not None else torch.cuda.current_device()
            torch.zeros(1, device=device)
            log.info(
                "platform %s: device %s (%s), %d CUDA device(s)",
                PLATFORM_NAME, device, torch.cuda.get_device_name(idx),
                torch.cuda.device_count(),
            )
        else:
            log.info("platform %s: device %s", PLATFORM_NAME, device)

    def load_graph(self, spec: GraphSpec) -> Graph:
        """One-time per-graph ingest into the intermediate dir, idempotent."""
        g = load_graph_from_spec(spec, intermediate_dir=self.config.intermediate_dir)
        self.graphs[spec.name] = g
        return g

    def delete_graph(self, graph_name: str) -> None:
        """Release the graph and its device state; cached files stay, like
        unload-graph.sh:32-38."""
        graph = self.graphs.pop(graph_name, None)
        if graph is not None and self.config.num_devices > 1:
            from graphtpu_torch.parallel.dispatch import purge_sharded

            purge_sharded(graph)
        cache_mod.unload(self.config.intermediate_dir, graph_name)

    def prepare(self, spec: GraphSpec, algorithm: str) -> None:
        """Warm-up outside the processing window: one run builds the CUDA
        kernels and the slab plan and copies it to the device, all
        memoized, so the timed run pays neither. Under num-devices > 1 the
        same run starts the mesh's worker processes and installs the
        graph's blocks on the ranks, both kept for the timed run (under
        subprocess isolation each job's child pays them in its makespan)."""
        key = (spec.name, algorithm)
        if key in self._prepared:
            return
        graph = self.graphs.get(spec.name) or self.load_graph(spec)
        run_algorithm(algorithm, graph, spec.params.get(algorithm), self.config)
        self._prepared.add(key)

    def startup(self, log_dir: Optional[str] = None) -> None:
        self.collector.start_logging(log_dir)

    def run(self, spec: GraphSpec, algorithm: str) -> AlgorithmResult:
        """One algorithm job, the processing markers around the kernel
        (bfs.cpp:105-107). The result is on the host, so the window
        covers the device work. Under ``profile_dir`` a torch.profiler
        trace (device activity too on a CUDA device) covers the window; it
        starts before the first marker and is written after the second,
        so the window holds none of its set-up or export."""
        graph = self.graphs.get(spec.name) or self.load_graph(spec)
        prof = None
        if self.config.profile_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.device(self.config.device).type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.__enter__()
        try:
            proc_time_start(self.collector.stream)
            result = run_algorithm(algorithm, graph, spec.params.get(algorithm), self.config)
            proc_time_end(self.collector.stream)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                self._write_trace(prof, spec.name, algorithm)
        return result

    def _write_trace(self, prof, graph_name: str, algorithm: str) -> Path:
        """One Chrome trace per window: <profile_dir>/<graph>-<algo>-<pid>-<k>.json."""
        out = Path(self.config.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        self._traces += 1
        path = out / f"{graph_name}-{algorithm}-{os.getpid()}-{self._traces}.json"
        prof.export_chrome_trace(str(path))
        log.info("profile of the processing window written to %s", path)
        return path

    def finalize(self) -> BenchmarkMetrics:
        metrics = BenchmarkMetrics()
        metrics.processing_time_seconds = self.collector.collect_processing_time()
        self.collector.stop_logging()
        return metrics

    def terminate(self) -> None:
        self.collector.stop_logging()
