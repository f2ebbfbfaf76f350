"""Typed configuration and Java-properties parsing (counterpart of
graphtpu/utils/config.py).

The dataset descriptors (``graph.<name>.*``) parse exactly as in the JAX
package, and so does the benchmark tier (``BenchmarkConfig``,
``benchmark.custom.*``). ``PlatformConfig`` carries the platform keys the
port implements, under the same ``platform.graphtpu.*`` names, plus
``device``: the torch device every tensor of a run lives on.
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path
from typing import Dict, List, Optional

from graphtpu_torch.utils.logging import get_logger


def parse_properties(path: str | os.PathLike) -> Dict[str, str]:
    """Parse a Java .properties file (key = value, # comments)."""
    props: Dict[str, str] = {}
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("!"):
            continue
        m = re.match(r"([^=:]+)[=:](.*)", line)
        if not m:
            continue
        props[m.group(1).strip()] = m.group(2).strip()
    return props


@dataclasses.dataclass
class AlgorithmParams:
    """Per-algorithm parameters, keys matching the dataset descriptors
    (e.g. graph.<name>.bfs.source-vertex)."""

    source_vertex: Optional[int] = None        # bfs., sssp.
    max_iterations: Optional[int] = None       # cdlp.
    damping_factor: Optional[float] = None     # pr.
    num_iterations: Optional[int] = None       # pr.
    weight_property: Optional[str] = None      # sssp. (must name "weight")


@dataclasses.dataclass
class GraphSpec:
    """One dataset descriptor (graph.<name>.* keys)."""

    name: str
    vertex_path: str
    edge_path: str
    directed: bool
    weighted: bool
    num_vertices: Optional[int] = None
    num_edges: Optional[int] = None
    algorithms: List[str] = dataclasses.field(default_factory=list)
    params: Dict[str, AlgorithmParams] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_properties(cls, path: str | os.PathLike) -> "GraphSpec":
        path = Path(path)
        props = parse_properties(path)
        names = {k.split(".")[1] for k in props if k.startswith("graph.")}
        if len(names) != 1:
            raise ValueError(f"{path}: expected exactly one graph, found {names}")
        name = names.pop()
        p = f"graph.{name}."

        def get(key, default=None):
            return props.get(p + key, default)

        edge_prop_names = [
            s.strip() for s in get("edge-properties.names", "").split(",") if s.strip()
        ]
        weighted = "weight" in edge_prop_names
        algos = [a.strip().lower() for a in get("algorithms", "").split(",") if a.strip()]

        params: Dict[str, AlgorithmParams] = {}
        for algo in algos:
            ap = AlgorithmParams()
            if get(f"{algo}.source-vertex") is not None:
                ap.source_vertex = int(get(f"{algo}.source-vertex"))
            if get(f"{algo}.max-iterations") is not None:
                ap.max_iterations = int(get(f"{algo}.max-iterations"))
            if get(f"{algo}.damping-factor") is not None:
                ap.damping_factor = float(get(f"{algo}.damping-factor"))
            if get(f"{algo}.num-iterations") is not None:
                ap.num_iterations = int(get(f"{algo}.num-iterations"))
            if get(f"{algo}.weight-property") is not None:
                ap.weight_property = get(f"{algo}.weight-property")
            params[algo] = ap

        base = path.parent
        vertex_file = get("vertex-file", f"{name}.v")
        edge_file = get("edge-file", f"{name}.e")
        if edge_file == vertex_file:
            # tolerate descriptor typos (the reference's
            # test-sssp-undirected.properties points edge-file at the .v file)
            edge_file = f"{name}.e"
        return cls(
            name=name,
            vertex_path=str(base / vertex_file),
            edge_path=str(base / edge_file),
            directed=get("directed", "false").lower() == "true",
            weighted=weighted,
            num_vertices=int(get("meta.vertices")) if get("meta.vertices") else None,
            num_edges=int(get("meta.edges")) if get("meta.edges") else None,
            algorithms=algos,
            params=params,
        )


@dataclasses.dataclass
class PlatformConfig:
    """Platform tier: the keys of platform.properties the port implements."""

    intermediate_dir: str = "./intermediate"
    # torch device of every tensor of a run ("cuda", "cuda:0", or "cpu")
    device: str = "cuda"
    # compute precision for float-valued algorithms ("float32"|"float64")
    precision: str = "float32"
    # ranks (one device each) an algorithm runs over; above 1, run_algorithm
    # runs the distributed loops (parallel/dispatch.py), routed by the impl
    # keys as in the JAX package; 0 and 1 run on ``device`` alone
    num_devices: int = 0
    # PageRank pull sum: "auto"/"slab" = padded-ELL row sums on kernel K3;
    # "scan" (or the JAX package's name "segment") = a segment sum over the
    # pull CSR on kernel K7 (mode sum)
    pr_impl: str = "auto"
    # scan|xla|slab: the JAX package's lowering of the pull reduction. Under
    # pr-impl=scan, slab takes the slab arm and scan and xla both take K7.
    # BFS, WCC and SSSP reduce by min or max, which the two lowerings give
    # alike, so there the key changes nothing (their dense steps run K7)
    spmv_impl: str = "scan"
    # auto|adaptive|adaptive-host|slab|sort: auto/adaptive = full slab steps,
    # then active-set steps on the frontier engine (ops/active.py), run
    # host-stepped (adaptive-host) under iteration_timing; sort is the oracle
    cdlp_impl: str = "auto"
    # adaptive-host: switch to active-set steps once the rows next to a
    # changed vertex cover less than this fraction of the incidence
    cdlp_active_threshold: float = 0.10
    # auto/adaptive: frontier capacities; an active-set step runs only
    # while the next active set fits these rows and edges, else a full step
    cdlp_frontier_rows: int = 1 << 16
    cdlp_frontier_edges: int = 1 << 18
    # explicit ascending active-tier edge budgets (comma list); empty = the
    # single cdlp-frontier tier (ops/active.py cdlp_tiers)
    cdlp_tiers: str = ""
    # auto|adaptive|device|dense|hybrid: auto/adaptive = the push tier ladder,
    # truncated bottom-up and the dense pull fallback (algorithms/bfs.py);
    # device (or dense, the JAX package's name) = dense pull steps only; hybrid = host expansions of sparse
    # levels, dense pull steps on the device for the heavy ones
    bfs_impl: str = "auto"
    # hybrid: a level expands on the host while its frontier's out-edges
    # are at most this fraction of the edges (0 = dense wherever any edge leaves)
    bfs_active_threshold: float = 0.05
    # row budget of every push tier; 0 = 2^18 (each tier takes min(rows,
    # its edges, n))
    bfs_frontier_rows: int = 0
    # top push tier's edge budget; 0 = 2^22
    bfs_frontier_edges: int = 0
    # explicit ascending push-tier edge budgets (comma list); empty = 2^16,
    # 2^18, 2^20 below bfs-frontier-edges, then bfs-frontier-edges
    bfs_push_tiers: str = ""
    # in-neighbours the truncated bottom-up probes per row; 0 = BFS_TRUNC (2)
    bfs_trunc: int = 0
    # bottom-up residual budgets (rows, edges) before the level goes dense;
    # 0 = 2^15 rows, 2^18 edges
    bfs_bu_rows: int = 0
    bfs_bu_edges: int = 0
    # ""/phases run; "switch" (a TPU compile-time experiment) is not ported
    bfs_step_mode: str = ""
    # auto|slab|adaptive|device|dense: auto/slab = full steps on the slab plan
    # (kernel K6), adaptive = full steps on the edge stream (K7), both with
    # active-set steps on the frontier engine; device (or dense) = dense
    # steps only
    wcc_impl: str = "auto"
    wcc_frontier_rows: int = 1 << 16
    wcc_frontier_edges: int = 1 << 18
    # auto|adaptive|device|dense|delta|hybrid: auto/adaptive = changed-set
    # Bellman-Ford on a frontier tier ladder (kernels K5, K8) with dense
    # sweeps (K7); device (or dense) = dense sweeps only; delta = bucketed
    # delta-stepping on the same kernels; hybrid = host relaxations of
    # sparse rounds, dense sweeps on the device for the heavy ones
    sssp_impl: str = "auto"
    # hybrid: a round relaxes on the host while its changed vertices'
    # out-edges are at most this fraction of the edges
    sssp_active_threshold: float = 0.05
    # delta-stepping bucket width (sssp.cpp:70-78)
    sssp_delta: float = 2.5
    sssp_frontier_rows: int = 1 << 16
    sssp_frontier_edges: int = 1 << 18
    # explicit frontier-tier edge budgets (comma list); empty = the (e/8, e)
    # ladder (algorithms/sssp.py sssp_tiers)
    sssp_tiers: str = ""
    # auto|oriented|sweep: auto/oriented = degree-oriented wedges probed in
    # the edge hash (kernel K10); sweep = the membership-sweep oracle; auto
    # falls back to it when an oriented out-degree exceeds the widest bucket
    lcc_impl: str = "auto"
    # slab degree-bucket upper bounds; None = per-graph DP-optimal bounds
    slab_buckets: Optional[tuple] = None
    # print "[CUDA][TIMER] cdlp iteration k took Xms" per CDLP iteration
    iteration_timing: bool = False
    # cdlp-impl=sort: take the first k iterations as not converged, without
    # the equality test and its host read (cdlp_kernel.cu:1254-1271)
    skip_convergence_checks: int = 0
    # write a torch.profiler trace of each processing window here
    profile_dir: Optional[str] = None
    # failure-detection hook: "hang:<algo>" makes that algorithm's job block
    # forever, to exercise the timeout and kill paths
    fault_injection: Optional[str] = None

    @classmethod
    def from_properties(cls, path: str | os.PathLike) -> "PlatformConfig":
        props = parse_properties(path)
        cfg = cls()
        for key, (attr, cast) in _PLATFORM_PROPS.items():
            if key in props:
                setattr(cfg, attr, cast(props[key]))
        for key in sorted(_NOT_PORTED_PROPS.intersection(props)):
            get_logger("config").warning(
                "%s: key %s is not implemented in graphtpu_torch yet and is ignored "
                "(the JAX package acts on it)", path, key,
            )
        return cfg

    def to_properties(self, path: str | os.PathLike) -> None:
        """Write the keys that differ from the defaults as a
        platform.properties file (the inverse of from_properties), device
        included: how a subprocess job gets its parent's configuration."""
        defaults = PlatformConfig()
        lines = []
        for key, (attr, _cast) in _PLATFORM_PROPS.items():
            v = getattr(self, attr)
            if v is None or v == getattr(defaults, attr):
                continue
            if isinstance(v, (tuple, list)):
                v = ",".join(str(int(x)) for x in v)  # the comma list the parser reads
            lines.append(f"{key} = {v}")
        Path(path).write_text("\n".join(lines) + "\n")


_PLATFORM_PROPS = {
    "platform.graphtpu.intermediate-dir": ("intermediate_dir", str),
    "platform.graphtpu.device": ("device", str),
    "platform.graphtpu.precision": ("precision", str),
    "platform.graphtpu.num-devices": ("num_devices", int),
    "platform.graphtpu.pr-impl": ("pr_impl", str),
    "platform.graphtpu.spmv-impl": ("spmv_impl", str),
    "platform.graphtpu.cdlp-impl": ("cdlp_impl", str),
    "platform.graphtpu.cdlp-active-threshold": ("cdlp_active_threshold", float),
    "platform.graphtpu.cdlp-frontier-rows": ("cdlp_frontier_rows", int),
    "platform.graphtpu.cdlp-frontier-edges": ("cdlp_frontier_edges", int),
    "platform.graphtpu.cdlp-tiers": ("cdlp_tiers", str),
    "platform.graphtpu.bfs-impl": ("bfs_impl", str),
    "platform.graphtpu.bfs-frontier-rows": ("bfs_frontier_rows", int),
    "platform.graphtpu.bfs-frontier-edges": ("bfs_frontier_edges", int),
    "platform.graphtpu.bfs-push-tiers": ("bfs_push_tiers", str),
    "platform.graphtpu.bfs-trunc": ("bfs_trunc", int),
    "platform.graphtpu.bfs-bu-rows": ("bfs_bu_rows", int),
    "platform.graphtpu.bfs-bu-edges": ("bfs_bu_edges", int),
    "platform.graphtpu.bfs-step-mode": ("bfs_step_mode", str),
    "platform.graphtpu.bfs-active-threshold": ("bfs_active_threshold", float),
    "platform.graphtpu.wcc-impl": ("wcc_impl", str),
    "platform.graphtpu.wcc-frontier-rows": ("wcc_frontier_rows", int),
    "platform.graphtpu.wcc-frontier-edges": ("wcc_frontier_edges", int),
    "platform.graphtpu.sssp-impl": ("sssp_impl", str),
    "platform.graphtpu.sssp-frontier-rows": ("sssp_frontier_rows", int),
    "platform.graphtpu.sssp-frontier-edges": ("sssp_frontier_edges", int),
    "platform.graphtpu.sssp-tiers": ("sssp_tiers", str),
    "platform.graphtpu.sssp-delta": ("sssp_delta", float),
    "platform.graphtpu.sssp-active-threshold": ("sssp_active_threshold", float),
    "platform.graphtpu.lcc-impl": ("lcc_impl", str),
    "platform.graphtpu.slab-buckets": (
        "slab_buckets",
        lambda v: tuple(int(x) for x in str(v).split(",") if x.strip()),
    ),
    "platform.graphtpu.iteration-timing": (
        "iteration_timing",
        lambda v: str(v).strip().lower() in ("1", "true", "yes"),
    ),
    "platform.graphtpu.skip-convergence-checks": ("skip_convergence_checks", int),
    "platform.graphtpu.profile-dir": ("profile_dir", str),
    "platform.graphtpu.fault-injection": ("fault_injection", str),
}

# platform.graphtpu.* keys the JAX package acts on and the port does not yet:
# reading one logs a warning, so that the missing behaviour is not silent
_NOT_PORTED_PROPS = frozenset(
    "platform.graphtpu." + k for k in (
        "shard-checkpoints",
    )
)


@dataclasses.dataclass
class BenchmarkConfig:
    """Benchmark tier: the benchmark.custom.* keys
    (config-template/cdlp.properties:8-23)."""

    graphs: List[str] = dataclasses.field(default_factory=list)
    algorithms: List[str] = dataclasses.field(default_factory=list)
    timeout_seconds: int = 3600
    output_required: bool = True
    validation_required: bool = True
    repetitions: int = 1
    # "subprocess": each job is a child process, its pid in
    #   <log>/executable.pid, SIGKILLed at the timeout (execute-job.sh:150);
    #   the only mode whose timeout stops a kernel that never returns.
    # "inprocess": jobs run in the suite's process and reuse its graphs and
    #   device state; the timeout is a SIGALRM between host steps.
    job_isolation: str = "subprocess"
    graphs_root: str = "."
    output_dir: str = "./output"
    validation_dir: Optional[str] = None
    report_dir: str = "./report"

    @classmethod
    def from_properties(cls, path: str | os.PathLike) -> "BenchmarkConfig":
        props = parse_properties(path)
        cfg = cls()

        def split(v):
            return [s.strip() for s in v.split(",") if s.strip()]

        if "benchmark.custom.graphs" in props:
            cfg.graphs = split(props["benchmark.custom.graphs"])
        if "benchmark.custom.algorithms" in props:
            cfg.algorithms = [a.lower() for a in split(props["benchmark.custom.algorithms"])]
        if "benchmark.custom.timeout" in props:
            cfg.timeout_seconds = int(props["benchmark.custom.timeout"])
        if "benchmark.custom.output-required" in props:
            cfg.output_required = props["benchmark.custom.output-required"].lower() == "true"
        if "benchmark.custom.validation-required" in props:
            cfg.validation_required = (
                props["benchmark.custom.validation-required"].lower() == "true"
            )
        if "benchmark.custom.repetitions" in props:
            cfg.repetitions = int(props["benchmark.custom.repetitions"])
        if "benchmark.custom.job-isolation" in props:
            v = props["benchmark.custom.job-isolation"].lower()
            if v not in ("inprocess", "subprocess"):
                raise ValueError(f"benchmark.custom.job-isolation: unknown mode {v!r}")
            cfg.job_isolation = v
        # dataset paths resolve against the properties file's directory, so a
        # checked-in config names the vendored fixtures from any cwd
        base = os.path.dirname(os.path.abspath(path))
        if "graphs.root-directory" in props:
            cfg.graphs_root = os.path.normpath(os.path.join(base, props["graphs.root-directory"]))
        if "graphs.validation-directory" in props:
            cfg.validation_dir = os.path.normpath(
                os.path.join(base, props["graphs.validation-directory"])
            )
        if "benchmark.output-directory" in props:
            cfg.output_dir = props["benchmark.output-directory"]
        if "benchmark.report-directory" in props:
            cfg.report_dir = props["benchmark.report-directory"]
        return cfg
