"""graphtpu_torch's hybrid BFS and SSSP (``bfs-impl=hybrid``,
``sssp-impl=hybrid``) against the JAX package's, on the CPU.

Both packages get the same graph (the JAX package's generators, handed over
as numpy arrays). At thresholds 0 (every level or round with an edge runs
dense), 0.05 (the default: both kinds) and 1.0 (host only), levels and
iteration counts must be equal, and distances bit-identical: each is the
same float addition dist[u] + w in both, and min is exact in any order
(stricter than the validator's 1e-4). The two thresholds are read from a
properties file as in the JAX package, and the golden fixtures validate
through the port's platform and CLI under both hybrids.
"""

import numpy as np
import pytest
import torch

from graphtpu.algorithms import bfs as jbfs
from graphtpu.algorithms import sssp as jsssp
from graphtpu.algorithms.common import run_algorithm as j_run_algorithm
from graphtpu.core.graph import Graph as JGraph
from graphtpu.utils.config import AlgorithmParams as JParams
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph
from graphtpu.utils.synth import uniform_graph as j_uniform_graph

from graphtpu_torch.algorithms import bfs as tbfs
from graphtpu_torch.algorithms import sssp as tsssp
from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.cli import main as cli_main
from graphtpu_torch.core.graph import Graph, frontier_edge_positions
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.harness.platform import GraphTorchPlatform
from graphtpu_torch.harness.validator import validate_result
from graphtpu_torch.utils.config import AlgorithmParams, GraphSpec, PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

THRESHOLDS = (0.0, 0.05, 1.0)
SOURCES = (0, 1, 77)
DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}
BFS_GOLDENS = ["example-directed", "example-undirected", "test-bfs-directed",
               "test-bfs-undirected"]
SSSP_GOLDENS = ["example-directed", "example-undirected", "test-sssp-directed",
                "test-sssp-undirected"]


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w if jg.weighted else None, jg.mapping,
                             jg.directed, jg.weighted)


@pytest.fixture(scope="module", params=[True, False], ids=["directed", "undirected"])
def graphs(request):
    jg = j_rmat_graph(9, 8, directed=request.param, weighted=True, seed=5)
    return jg, _twin(jg)


def _chain():
    """0 -> 1 -> 2 -> 3, and vertex 4 unreachable."""
    src, dst = np.array([0, 1, 2]), np.array([1, 2, 3])
    w = np.array([1.5, 2.0, 0.25])
    ids = np.arange(5, dtype=np.int64)
    jg = JGraph(5, src, dst, w, ids.astype(np.uint64), directed=True, weighted=True)
    return jg, _twin(jg)


def test_frontier_edge_positions_matches_jax(graphs):
    from graphtpu.core.graph import frontier_edge_positions as j_positions

    jg, tg = graphs
    rng = np.random.default_rng(0)
    for size in (0, 1, 40, tg.n):
        frontier = np.sort(rng.choice(tg.n, size=size, replace=False)).astype(np.int64)
        for a, b in zip(frontier_edge_positions(tg.indptr, frontier),
                        j_positions(jg.indptr, frontier)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_bfs_hybrid_matches_jax(graphs, threshold):
    jg, tg = graphs
    for src in SOURCES:
        jl, jn = jbfs.bfs_hybrid_run(jg, src, JConfig(bfs_active_threshold=threshold))
        tl, tn = tbfs.bfs_hybrid_run(tg, src, PlatformConfig(device="cpu",
                                                             bfs_active_threshold=threshold))
        assert tl.dtype == np.int32
        np.testing.assert_array_equal(tl, np.asarray(jl))
        assert tn == jn
    # and the dense kernel (bfs-impl=device) from the last source
    dense, dn = tbfs._bfs_kernel(tg, src, "cpu")
    np.testing.assert_array_equal(tl, dense.numpy())
    assert tn == dn


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_sssp_hybrid_matches_jax(graphs, threshold, dtype):
    jg, tg = graphs
    jdt, tdt = DTYPES[dtype]
    for src in SOURCES:
        jd, jn = jsssp.sssp_hybrid_run(jg, src, JConfig(sssp_active_threshold=threshold), jdt)
        td, tn = tsssp.sssp_hybrid_run(tg, src, PlatformConfig(
            device="cpu", sssp_active_threshold=threshold), tdt)
        assert td.dtype == jdt
        np.testing.assert_array_equal(td, np.asarray(jd))
        assert tn == jn
        assert np.isfinite(td).sum() > 1


def test_hybrids_switch_both_ways():
    """On a graph where the default threshold sends some levels and rounds
    to the host and some to the device, each kind runs (the named ranges
    are counted by the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    jg = j_uniform_graph(500, 4000, directed=True, weighted=True, seed=2)
    tg = _twin(jg)
    cfg = PlatformConfig(device="cpu", bfs_active_threshold=0.3, sssp_active_threshold=0.3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tl, tn = tbfs.bfs_hybrid_run(tg, 3, cfg)
        td, _ = tsssp.sssp_hybrid_run(tg, 3, cfg)
    counts = {e.key: e.count for e in prof.key_averages()}
    for key in ("bfs.host_step", "bfs.dense", "sssp.host_step", "sssp.full_step"):
        assert counts.get(key, 0) > 0, (key, counts)
    jl, jn = jbfs.bfs_hybrid_run(jg, 3, JConfig(bfs_active_threshold=0.3))
    np.testing.assert_array_equal(tl, np.asarray(jl))
    assert tn == jn
    jd, _ = jsssp.sssp_hybrid_run(jg, 3, JConfig(sssp_active_threshold=0.3))
    np.testing.assert_array_equal(td, np.asarray(jd))


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_hybrids_chain_and_unreachable(threshold):
    jg, tg = _chain()
    cfg = PlatformConfig(device="cpu", bfs_active_threshold=threshold,
                         sssp_active_threshold=threshold)
    jcfg = JConfig(bfs_active_threshold=threshold, sssp_active_threshold=threshold)
    levels, it = tbfs.bfs_hybrid_run(tg, 0, cfg)
    np.testing.assert_array_equal(levels, [0, 1, 2, 3, INT32_INF])
    jl, jn = jbfs.bfs_hybrid_run(jg, 0, jcfg)
    np.testing.assert_array_equal(levels, np.asarray(jl))
    assert it == jn
    dist, rounds = tsssp.sssp_hybrid_run(tg, 0, cfg)
    np.testing.assert_array_equal(dist, np.array([0.0, 1.5, 3.5, 3.75, np.inf], np.float32))
    jd, jr = jsssp.sssp_hybrid_run(jg, 0, jcfg)
    np.testing.assert_array_equal(dist, np.asarray(jd))
    assert rounds == jr


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("precision", list(DTYPES))
def test_run_algorithm_matches_jax(graphs, threshold, precision):
    jg, tg = graphs
    jcfg = JConfig(bfs_impl="hybrid", sssp_impl="hybrid", precision=precision,
                   bfs_active_threshold=threshold, sssp_active_threshold=threshold)
    tcfg = PlatformConfig(device="cpu", bfs_impl="hybrid", sssp_impl="hybrid",
                          precision=precision, bfs_active_threshold=threshold,
                          sssp_active_threshold=threshold)
    for algo in ("bfs", "sssp"):
        want = j_run_algorithm(algo, jg, JParams(source_vertex=5), jcfg)
        got = run_algorithm(algo, tg, AlgorithmParams(source_vertex=5), tcfg)
        assert got.values.dtype == want.values.dtype
        np.testing.assert_array_equal(got.values, want.values)
        assert got.iterations == want.iterations
        # and the default impl gives the same values
        default = run_algorithm(algo, tg, AlgorithmParams(source_vertex=5),
                                PlatformConfig(device="cpu", precision=precision))
        np.testing.assert_array_equal(got.values, default.values)


def test_thresholds_from_a_properties_file(graphs, tmp_path):
    jg, tg = graphs
    props = tmp_path / "platform.properties"
    props.write_text("platform.graphtpu.bfs-impl = hybrid\n"
                     "platform.graphtpu.sssp-impl = hybrid\n"
                     "platform.graphtpu.bfs-active-threshold = 0.2\n"
                     "platform.graphtpu.sssp-active-threshold = 0.3\n")
    tcfg = PlatformConfig.from_properties(props)
    jcfg = JConfig.from_properties(props)
    assert (tcfg.bfs_active_threshold, tcfg.sssp_active_threshold) == \
        (jcfg.bfs_active_threshold, jcfg.sssp_active_threshold) == (0.2, 0.3)
    assert (PlatformConfig().bfs_active_threshold, PlatformConfig().sssp_active_threshold) == \
        (JConfig().bfs_active_threshold, JConfig().sssp_active_threshold) == (0.05, 0.05)
    tcfg.device = "cpu"
    for algo in ("bfs", "sssp"):
        want = j_run_algorithm(algo, jg, JParams(source_vertex=1), jcfg)
        got = run_algorithm(algo, tg, AlgorithmParams(source_vertex=1), tcfg)
        np.testing.assert_array_equal(got.values, want.values)
        assert got.iterations == want.iterations
    # a job's configuration travels to a child process through to_properties
    back = tmp_path / "back.properties"
    PlatformConfig(device="cpu", bfs_active_threshold=0.2).to_properties(back)
    assert PlatformConfig.from_properties(back).bfs_active_threshold == 0.2


@pytest.mark.parametrize("algo,name", [("bfs", g) for g in BFS_GOLDENS]
                         + [("sssp", g) for g in SSSP_GOLDENS])
def test_golden_through_platform(fixtures_dir, tmp_path, algo, name):
    spec = GraphSpec.from_properties(fixtures_dir / f"{name}.properties")
    plat = GraphTorchPlatform(PlatformConfig(device="cpu", intermediate_dir=str(tmp_path),
                                             bfs_impl="hybrid", sssp_impl="hybrid"))
    plat.load_graph(spec)
    plat.startup(log_dir=str(tmp_path / "logs"))
    plat.prepare(spec, algo)
    res = plat.run(spec, algo)
    assert plat.finalize().processing_time_seconds >= 0
    ok, msg = validate_result(res, plat.graphs[spec.name],
                              str(fixtures_dir / f"{name}-{algo.upper()}"))
    assert ok, msg


@pytest.mark.parametrize("algo,name", [("bfs", "test-bfs-directed"),
                                       ("sssp", "test-sssp-undirected")])
def test_golden_through_cli(fixtures_dir, tmp_path, capsys, algo, name):
    props = tmp_path / "platform.properties"
    props.write_text(f"platform.graphtpu.{algo}-impl = hybrid\n"
                     f"platform.graphtpu.{algo}-active-threshold = 0.01\n")
    rc = cli_main([
        "run", "--graph-properties", str(fixtures_dir / f"{name}.properties"),
        "--algorithm", algo, "--device", "cpu", "--intermediate-dir", str(tmp_path),
        "--platform-properties", str(props),
        "--validation-file", str(fixtures_dir / f"{name}-{algo.upper()}"),
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "validation: PASS" in out, out
