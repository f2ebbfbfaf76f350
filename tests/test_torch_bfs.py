"""graphtpu_torch's BFS against the JAX package, on the CPU.

Both packages get the same graph (the JAX package's RMAT generator, handed
over as numpy arrays). Levels, iteration counts and the adaptive run's
per-phase step counts must be equal. Small capacities force every phase:
each push tier, a tier whose new frontier overflows its rows (the level
escalates), the truncated bottom-up, and a bottom-up whose residual
overflows (the level goes dense). The golden fixtures validate through the
port's platform and CLI.
"""

import numpy as np
import pytest
import torch

from graphtpu.algorithms import bfs as jbfs
from graphtpu.algorithms.common import run_algorithm as j_run_algorithm
from graphtpu.ops import spmv as jspmv
from graphtpu.ops.gather import table_gather as j_table_gather
from graphtpu.utils.config import AlgorithmParams as JParams
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import bfs as tbfs
from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.cli import main as cli_main
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.harness.platform import GraphTorchPlatform
from graphtpu_torch.harness.validator import validate_result
from graphtpu_torch.ops.spmv import csr_pull_reduce, csr_pull_reduce_plain
from graphtpu_torch.utils.config import AlgorithmParams, GraphSpec, PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

GOLDENS = ["example-directed", "example-undirected", "test-bfs-directed", "test-bfs-undirected"]
SOURCES = (0, 1, 5, 77)
# (rows, edges) small enough for every phase on RMAT s9/ef8: rows 8 make
# tiers abort, a 4-row / 16-edge residual makes bottom-up overflow
SMALL = dict(bfs_push_tiers="16,64,256", bfs_frontier_rows=8, bfs_bu_rows=4, bfs_bu_edges=16)


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, jg.directed, False)


@pytest.fixture(scope="module", params=[True, False], ids=["directed", "undirected"])
def graphs(request):
    jg = j_rmat_graph(9, 8, directed=request.param, seed=3)
    return jg, _twin(jg)


@pytest.mark.parametrize("caps", [{}, SMALL, dict(SMALL, bfs_trunc=1)],
                         ids=["default", "small", "small-t1"])
def test_adaptive_matches_jax(graphs, caps):
    jg, tg = graphs
    totals = np.zeros(7, dtype=np.int64)  # 3 or 4 tiers, bottom-up, dense, tier aborts
    for src in SOURCES:
        jl, jn, js = jbfs.bfs_adaptive_run(jg, src, JConfig(**caps), with_stats=True)
        tl, tn, ts = tbfs.bfs_adaptive_run(tg, src, PlatformConfig(device="cpu", **caps),
                                           with_stats=True)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert (tn, ts) == (jn, js)
        steps = list(ts["tier_steps"].values()) + [ts["bu_steps"], ts["dense_steps"]]
        # each level ends in one step that completes it; a dense step
        # follows exactly one aborted bottom-up, the rest are tier aborts
        steps.append(sum(steps) - tn - ts["dense_steps"])
        totals[:len(steps)] += steps
    if caps:
        # every tier, bottom-up, dense and an escalating tier abort ran at
        # least once over the sources
        assert (totals[:6] > 0).all(), totals


def test_default_tiers_match_jax_stats_keys(graphs):
    jg, tg = graphs
    _, _, ts = tbfs.bfs_adaptive_run(tg, 0, PlatformConfig(device="cpu"), with_stats=True)
    assert ts["tiers"] == [(min(1 << 18, e, tg.n), e) for e in (1 << 16, 1 << 18, 1 << 20, 1 << 22)]
    assert tbfs.BFS_TRUNC == jbfs.BFS_TRUNC == 2
    assert (ts["t_trunc"], ts["k_bu"], ts["e_bu"]) == (2, 1 << 15, 1 << 18)


@pytest.mark.parametrize("impl", ["auto", "adaptive", "device"])
def test_run_algorithm_matches_jax(graphs, impl):
    jg, tg = graphs
    for src in (0, 77):
        want = j_run_algorithm("bfs", jg, JParams(source_vertex=src), JConfig(bfs_impl=impl))
        got = run_algorithm("bfs", tg, AlgorithmParams(source_vertex=src),
                            PlatformConfig(device="cpu", bfs_impl=impl))
        np.testing.assert_array_equal(got.values, want.values)
        assert got.iterations == want.iterations


def test_adaptive_prep_is_memoized_per_device_and_trunc(graphs):
    jg, tg = graphs
    prep = tbfs.bfs_adaptive_prep(tg, 2, "cpu")
    assert tbfs.bfs_adaptive_prep(tg, 2, "cpu") is prep
    assert tbfs.bfs_adaptive_prep(tg, 3, "cpu") is not prep
    np.testing.assert_array_equal(prep.trunc_tbl.numpy(),
                                  np.asarray(jbfs.bfs_adaptive_prep(jg, 2)[-1]))


@pytest.mark.parametrize("mode", ["max_i32", "min_i32", "min_plus"])
def test_csr_pull_reduce_plain_matches_jax(graphs, mode):
    """K7's plain version against the expression it replaces, table_gather
    then pull_reduce, over the pull CSR (rows without in-edges included)."""
    jg, tg = graphs
    rng = np.random.default_rng(len(mode))
    s, d, _ = tg.pull_arrays()
    indptr = tg.pull_indptr.astype(np.int32)
    if mode == "min_plus":
        x = np.where(rng.random(tg.n) < 0.3, np.inf, rng.random(tg.n)).astype(np.float32)
        w = (rng.random(s.shape[0]) + 0.01).astype(np.float32)
        ident, kind = np.float32(np.inf), "min"
    else:
        # negative values: the identity fills rows without in-edges only
        x = rng.integers(-tg.n, tg.n, size=tg.n).astype(np.int32)
        w = None
        ident, kind = (np.int32(0), "max") if mode == "max_i32" else (np.int32(INT32_INF), "min")
    terms = j_table_gather(x, s)
    if w is not None:
        terms = terms + w
    want = jspmv.pull_reduce(kind, terms, d, indptr, tg.n, ident)
    t = torch.from_numpy
    got = csr_pull_reduce(mode, t(x), t(s), t(indptr), None if w is None else t(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        csr_pull_reduce_plain(mode, t(x), t(s), t(indptr), None if w is None else t(w)),
        got)
    if mode != "min_plus":  # x None reads the stored ids
        want = jspmv.pull_reduce(kind, s, d, indptr, tg.n, ident)
        np.testing.assert_array_equal(
            csr_pull_reduce(mode, None, t(s), t(indptr)).numpy(), np.asarray(want))


def test_csr_pull_reduce_refuses_bad_arguments():
    s = torch.zeros(3, dtype=torch.int32)
    indptr = torch.tensor([0, 3], dtype=torch.int32)
    x = torch.zeros(1, dtype=torch.float32)
    with pytest.raises(ValueError, match="unknown mode"):
        csr_pull_reduce("prod", x, s, indptr)
    with pytest.raises(ValueError, match="both x and w"):
        csr_pull_reduce("min_plus", x, s, indptr)
    with pytest.raises(ValueError, match="takes no w"):
        csr_pull_reduce("min_i32", None, s, indptr, x)
    with pytest.raises(TypeError, match="does not take"):
        csr_pull_reduce("max_i32", x, s, indptr)


def test_errors():
    tg = _twin(j_rmat_graph(6, 4, directed=True, seed=1))
    cpu = PlatformConfig(device="cpu")
    with pytest.raises(ValueError, match="requires source-vertex"):
        run_algorithm("bfs", tg, AlgorithmParams(), cpu)
    with pytest.raises(ValueError, match="not in graph"):
        run_algorithm("bfs", tg, AlgorithmParams(source_vertex=10 ** 9), cpu)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_algorithm("bfs", tg, AlgorithmParams(source_vertex=0),
                      PlatformConfig(device="cpu", bfs_impl="hybrid"))
    with pytest.raises(ValueError, match="switch"):
        run_algorithm("bfs", tg, AlgorithmParams(source_vertex=0),
                      PlatformConfig(device="cpu", bfs_step_mode="switch"))
    with pytest.raises(ValueError, match="unknown bfs-impl"):
        run_algorithm("bfs", tg, AlgorithmParams(source_vertex=0),
                      PlatformConfig(device="cpu", bfs_impl="dense"))
    res = run_algorithm("bfs", tg, AlgorithmParams(source_vertex=0),
                        PlatformConfig(device="cpu", bfs_step_mode="phases"))
    assert res.values[0] == 0


def test_dense_source_matches_jax():
    jg = j_rmat_graph(6, 4, directed=True, seed=1)
    mapping = np.arange(jg.n, dtype=np.int64) * 7 + 3
    tg = Graph(jg.n, jg.src, jg.dst, None, mapping, True, False)
    from graphtpu.core.graph import Graph as JGraph

    jg2 = JGraph(jg.n, jg.src, jg.dst, None, mapping, directed=True, weighted=False)
    for v in (3, 10, 7 * (jg.n - 1) + 3):
        assert tg.dense_source(v) == jg2.dense_source(v)
    for v in (0, 4):
        with pytest.raises(ValueError, match="not in graph"):
            tg.dense_source(v)


@pytest.mark.parametrize("impl", ["auto", "device"])
@pytest.mark.parametrize("name", GOLDENS)
def test_golden_through_platform(fixtures_dir, tmp_path, name, impl):
    spec = GraphSpec.from_properties(fixtures_dir / f"{name}.properties")
    assert spec.params["bfs"].source_vertex is not None
    plat = GraphTorchPlatform(PlatformConfig(device="cpu", intermediate_dir=str(tmp_path),
                                             bfs_impl=impl))
    plat.load_graph(spec)
    plat.startup(log_dir=str(tmp_path / "logs"))
    plat.prepare(spec, "bfs")
    res = plat.run(spec, "bfs")
    assert plat.finalize().processing_time_seconds >= 0
    ok, msg = validate_result(res, plat.graphs[spec.name], str(fixtures_dir / f"{name}-BFS"))
    assert ok, msg


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_through_cli(fixtures_dir, tmp_path, capsys, name):
    rc = cli_main([
        "run", "--graph-properties", str(fixtures_dir / f"{name}.properties"),
        "--algorithm", "bfs", "--device", "cpu", "--intermediate-dir", str(tmp_path),
        "--output-file", str(tmp_path / "out"),
        "--validation-file", str(fixtures_dir / f"{name}-BFS"),
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "validation: PASS" in out, out


def test_platform_properties_parse_like_jax(tmp_path):
    """Every BFS/WCC/SSSP key the port reads parses as in the JAX package,
    sssp-delta (read by delta-stepping) among them."""
    props = tmp_path / "platform.properties"
    props.write_text("\n".join([
        "platform.graphtpu.bfs-impl = device", "platform.graphtpu.bfs-frontier-rows = 64",
        "platform.graphtpu.bfs-frontier-edges = 4096", "platform.graphtpu.bfs-push-tiers = 16,256",
        "platform.graphtpu.bfs-trunc = 3", "platform.graphtpu.bfs-bu-rows = 5",
        "platform.graphtpu.bfs-bu-edges = 77", "platform.graphtpu.bfs-step-mode = phases",
        "platform.graphtpu.wcc-impl = adaptive", "platform.graphtpu.wcc-frontier-rows = 12",
        "platform.graphtpu.wcc-frontier-edges = 34", "platform.graphtpu.sssp-impl = device",
        "platform.graphtpu.sssp-frontier-rows = 9", "platform.graphtpu.sssp-frontier-edges = 99",
        "platform.graphtpu.sssp-tiers = 8,64", "platform.graphtpu.sssp-delta = 0.5",
    ]) + "\n")
    got, want = PlatformConfig.from_properties(props), JConfig.from_properties(props)
    default, jdefault = PlatformConfig(), JConfig()
    for attr in ("bfs_impl", "bfs_frontier_rows", "bfs_frontier_edges", "bfs_push_tiers",
                 "bfs_trunc", "bfs_bu_rows", "bfs_bu_edges", "bfs_step_mode", "wcc_impl",
                 "wcc_frontier_rows", "wcc_frontier_edges", "sssp_impl", "sssp_frontier_rows",
                 "sssp_frontier_edges", "sssp_tiers", "sssp_delta"):
        assert getattr(got, attr) == getattr(want, attr), attr
        assert getattr(default, attr) == getattr(jdefault, attr), attr
