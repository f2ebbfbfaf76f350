"""graphtpu_torch's delta-stepping SSSP (``sssp-impl=delta``) against the
JAX package's ``sssp_delta_run``, on the CPU.

Both packages get the same weighted graph as numpy arrays. Distances must
be bit-identical in float32 and in float64 (every candidate is the same
addition dist[u] + w, min is exact in any order, and the bucket of a
distance is computed in the run's dtype with 1 / delta rounded to it, as
in JAX), and the counts of relaxation steps must be equal. Capacities of a
few rows and edges force the dense phases. Also here: ``grid_graph``, the
``sssp-delta`` key, the SSSP goldens under ``delta``, and the warning for
platform keys that the port does not implement yet.
"""

import logging

import numpy as np
import pytest
import torch

from graphtpu.algorithms import sssp as jsssp
from graphtpu.algorithms.common import run_algorithm as j_run_algorithm
from graphtpu.core.graph import Graph as JGraph
from graphtpu.utils.config import AlgorithmParams as JParams
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import grid_graph as j_grid_graph
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import sssp as tsssp
from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.cli import main as cli_main
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.harness.platform import GraphTorchPlatform
from graphtpu_torch.harness.validator import validate_result
from graphtpu_torch.utils.config import AlgorithmParams, GraphSpec, PlatformConfig
from graphtpu_torch.utils.synth import grid_graph

from torch_native_env import jax_native_on_port_build  # noqa: F401

GOLDENS = ["example-directed", "example-undirected", "test-sssp-directed", "test-sssp-undirected"]
DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}
ROOMY, TINY = (1 << 10, 1 << 14), (4, 16)


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w, jg.mapping, jg.directed, True)


def _caps(delta, caps):
    return dict(sssp_delta=delta, sssp_frontier_rows=caps[0], sssp_frontier_edges=caps[1])


@pytest.fixture(scope="module", params=[True, False], ids=["directed", "undirected"])
def graphs(request):
    jg = j_rmat_graph(9, 8, directed=request.param, weighted=True, seed=3)
    return jg, _twin(jg)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("delta,caps", [(2.5, ROOMY), (0.4, ROOMY), (2.5, TINY), (0.3, TINY),
                                        (0.05, (64, 256))])
def test_delta_matches_jax(graphs, delta, caps, dtype):
    jg, tg = graphs
    jdt, tdt = DTYPES[dtype]
    totals = {}
    for src in (0, 5):
        want, want_n = jsssp.sssp_delta_run(jg, src, JConfig(**_caps(delta, caps)), jdt)
        got, got_n, stats = tsssp.sssp_delta_run(
            tg, src, PlatformConfig(device="cpu", **_caps(delta, caps)), tdt, with_stats=True)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.numpy(), want)
        assert got_n == want_n
        steps = ("light_active", "light_dense", "heavy_active", "heavy_dense")
        assert sum(stats[k] for k in steps) == got_n
        for k in steps + ("buckets",):
            totals[k] = totals.get(k, 0) + stats[k]
    if caps == TINY:  # the dense phases ran
        assert totals["light_dense"] > 0 and totals["heavy_dense"] > 0
    if delta < 1.0:   # both weight classes hold edges, many buckets
        assert totals["buckets"] > 2 and totals["heavy_active"] + totals["heavy_dense"] > 2
    # the same fixed point as the dense sweeps
    dev = tsssp._sssp_kernel(tsssp.sssp_prep(tg, tdt, "cpu"), 5, tg.n, tdt)[0]
    np.testing.assert_array_equal(got.numpy(), dev.numpy())


@pytest.mark.parametrize("torus", [True, False])
def test_grid_graph_matches_jax_and_delta_walks_it(torus):
    """The high-diameter case delta-stepping exists for: the generator
    equals the JAX package's, and the run equals JAX's at both deltas."""
    jg, tg = j_grid_graph(12, torus=torus, seed=2), grid_graph(12, torus=torus, seed=2)
    for a in ("src", "dst", "w", "mapping"):
        np.testing.assert_array_equal(getattr(tg, a), getattr(jg, a))
    assert (tg.n, tg.directed, tg.weighted) == (144, False, True)
    assert grid_graph(5, weighted=False).weighted is False
    for delta in (2.5, 0.4):
        want, want_n = jsssp.sssp_delta_run(jg, 0, JConfig(sssp_delta=delta))
        got, got_n, stats = tsssp.sssp_delta_run(
            tg, 0, PlatformConfig(device="cpu", sssp_delta=delta), with_stats=True)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got_n == want_n and np.isfinite(want).all()
        assert stats["buckets"] > (1 if delta == 2.5 else 4)


def test_high_diameter_chain():
    """A weighted path: the bucket advance walks the whole distance range."""
    n = 300
    src = np.arange(n - 1, dtype=np.int64)
    w = 0.05 + np.random.default_rng(5).random(n - 1)
    jg = JGraph(n, src, src + 1, w, np.arange(n, dtype=np.uint64), directed=True, weighted=True)
    tg = _twin(jg)
    expect = np.concatenate([[0.0], np.cumsum(w)]).astype(np.float32)
    for delta in (2.5, 0.4):
        want, want_n = jsssp.sssp_delta_run(jg, 0, JConfig(sssp_delta=delta))
        got, got_n = tsssp.sssp_delta_run(tg, 0, PlatformConfig(device="cpu", sssp_delta=delta))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got_n == want_n
        np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5)  # sums in path order


@pytest.mark.parametrize("precision", list(DTYPES))
def test_unreachable_vertices_and_the_registry_route(precision):
    src = np.array([0, 1, 2], dtype=np.int64)
    dst = np.array([1, 2, 3], dtype=np.int64)
    jg = JGraph(5, src, dst, np.array([1.5, 2.0, 0.25]), np.arange(5, dtype=np.uint64),
                directed=True, weighted=True)
    want = j_run_algorithm("sssp", jg, JParams(source_vertex=0),
                           JConfig(sssp_impl="delta", precision=precision))
    got = run_algorithm("sssp", _twin(jg), AlgorithmParams(source_vertex=0),
                        PlatformConfig(device="cpu", sssp_impl="delta", precision=precision))
    assert got.values.dtype == np.float64 and got.iterations == want.iterations
    np.testing.assert_array_equal(got.values, want.values)
    assert got.values[:4].tolist() == [0.0, 1.5, 3.5, 3.75] and np.isinf(got.values[4])


def test_run_algorithm_matches_jax_and_reads_sssp_delta(graphs):
    jg, tg = graphs
    for delta in (2.5, 0.2):
        want = j_run_algorithm("sssp", jg, JParams(source_vertex=5),
                               JConfig(sssp_impl="delta", sssp_delta=delta))
        got = run_algorithm("sssp", tg, AlgorithmParams(source_vertex=5),
                            PlatformConfig(device="cpu", sssp_impl="delta", sssp_delta=delta))
        np.testing.assert_array_equal(got.values, want.values)
        assert got.iterations == want.iterations
    assert got.iterations > run_algorithm(
        "sssp", tg, AlgorithmParams(source_vertex=5),
        PlatformConfig(device="cpu", sssp_impl="delta")).iterations  # the key is read


def test_delta_prep_is_memoized_and_needs_no_sentinel_edge(graphs):
    """One split per (delta, dtype, device); a class without edges is an
    empty CSR (the JAX prep pads it with one inert edge)."""
    jg, tg = graphs
    light, heavy = tsssp.sssp_delta_prep(tg, 2.5, torch.float32, "cpu")
    assert tsssp.sssp_delta_prep(tg, 2.5, torch.float32, "cpu")[0] is light
    assert tsssp.sssp_delta_prep(tg, 0.5, torch.float32, "cpu")[0] is not light
    assert heavy.dst.numel() == 0 and int(heavy.deg_pad.sum()) == 0  # weights below 1.01
    assert light.dst.numel() == tg.nnz
    _, j_light, j_heavy = jsssp.sssp_delta_prep(jg, 0.5, np.float32)[1:]
    light, heavy = tsssp.sssp_delta_prep(tg, 0.5, torch.float32, "cpu")
    for got, want in ((light, j_light), (heavy, j_heavy)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_through_platform(fixtures_dir, tmp_path, name):
    spec = GraphSpec.from_properties(fixtures_dir / f"{name}.properties")
    plat = GraphTorchPlatform(PlatformConfig(device="cpu", intermediate_dir=str(tmp_path),
                                             sssp_impl="delta"))
    plat.load_graph(spec)
    plat.startup(log_dir=str(tmp_path / "logs"))
    plat.prepare(spec, "sssp")
    res = plat.run(spec, "sssp")
    assert plat.finalize().processing_time_seconds >= 0
    ok, msg = validate_result(res, plat.graphs[spec.name], str(fixtures_dir / f"{name}-SSSP"))
    assert ok, msg


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_through_cli(fixtures_dir, tmp_path, capsys, name):
    props = tmp_path / "platform.properties"
    props.write_text("platform.graphtpu.sssp-impl = delta\nplatform.graphtpu.sssp-delta = 0.7\n")
    rc = cli_main([
        "run", "--graph-properties", str(fixtures_dir / f"{name}.properties"),
        "--algorithm", "sssp", "--device", "cpu", "--intermediate-dir", str(tmp_path),
        "--platform-properties", str(props),
        "--validation-file", str(fixtures_dir / f"{name}-SSSP"),
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "validation: PASS" in out, out


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_every_platform_key_parses_as_in_jax_and_logs_no_warning(tmp_path):
    """No key the JAX package acts on is left unported, so none logs a
    warning: shard-checkpoints (the last one ported), num-devices,
    sssp-delta, lcc-impl, the four the harness's port brought (spmv-impl,
    skip-convergence-checks, profile-dir, fault-injection) and the
    hybrids' two thresholds parse as in the JAX package and log nothing."""
    ported = {"shard-checkpoints": "false", "num-devices": "4", "sssp-delta": "0.5",
              "lcc-impl": "sweep", "sssp-impl": "delta",
              "intermediate-dir": "x", "no-such-key": "1", "spmv-impl": "slab",
              "skip-convergence-checks": "3", "profile-dir": "/tmp/p",
              "fault-injection": "hang:bfs", "bfs-active-threshold": "0.2",
              "sssp-active-threshold": "0.3"}
    props = tmp_path / "platform.properties"
    props.write_text("".join(f"platform.graphtpu.{k} = {v}\n" for k, v in ported.items()))
    handler = _Records()
    logger = logging.getLogger("graphtpu_torch")
    logger.addHandler(handler)
    try:
        got = PlatformConfig.from_properties(props)
    finally:
        logger.removeHandler(handler)
    want = JConfig.from_properties(props)
    for attr in ("shard_checkpoints", "num_devices", "sssp_delta", "lcc_impl", "sssp_impl",
                 "intermediate_dir", "spmv_impl", "skip_convergence_checks", "profile_dir",
                 "fault_injection", "bfs_active_threshold", "sssp_active_threshold"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.shard_checkpoints is False
    assert (PlatformConfig().sssp_delta, PlatformConfig().lcc_impl,
            PlatformConfig().shard_checkpoints) == \
        (JConfig().sssp_delta, JConfig().lcc_impl, JConfig().shard_checkpoints) == \
        (2.5, "auto", True)
    # "True" as the JAX package reads it (any case), anything else False
    for text, value in (("True", True), ("TRUE", True), ("yes", False)):
        props.write_text(f"platform.graphtpu.shard-checkpoints = {text}\n")
        assert PlatformConfig.from_properties(props).shard_checkpoints is \
            JConfig.from_properties(props).shard_checkpoints is value, text
    assert not handler.messages, handler.messages
    # the port reads every key the JAX package knows
    from graphtpu.utils.config import _PLATFORM_PROPS as J_PROPS
    from graphtpu_torch.utils import config as tconfig

    assert set(tconfig._PLATFORM_PROPS) >= set(J_PROPS)
    assert not hasattr(tconfig, "_NOT_PORTED_PROPS")
