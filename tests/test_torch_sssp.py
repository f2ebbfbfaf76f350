"""graphtpu_torch's SSSP against the JAX package, on the CPU.

Both packages get the same weighted graph (the JAX package's RMAT
generator, handed over as numpy arrays). Distances must be bit-identical in
float32 and in float64: every candidate is the same addition dist[u] + w in
both, and min is exact in any order. Round counts and the adaptive run's
per-tier counts must be equal too; an ``sssp-tiers`` ladder with small
budgets forces tier and full rounds. K8's plain version is held against
the JAX scatter-min it replaces, and the golden fixtures validate through
the port's platform and CLI.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.algorithms import sssp as jsssp
from graphtpu.algorithms.common import run_algorithm as j_run_algorithm
from graphtpu.ops.frontier import expand as j_expand
from graphtpu.utils.config import AlgorithmParams as JParams
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import sssp as tsssp
from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.cli import main as cli_main
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.harness.platform import GraphTorchPlatform
from graphtpu_torch.harness.validator import validate_result
from graphtpu_torch.ops.frontier import relax_min, relax_min_plain
from graphtpu_torch.utils.config import AlgorithmParams, GraphSpec, PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

GOLDENS = ["example-directed", "example-undirected", "test-sssp-directed", "test-sssp-undirected"]
DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}
# a three-tier ladder (rows e/4) that leaves the big rounds to full sweeps
LADDER = dict(sssp_tiers="8,32,128")


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w, jg.mapping, jg.directed, True)


@pytest.fixture(scope="module", params=[True, False], ids=["directed", "undirected"])
def graphs(request):
    jg = j_rmat_graph(9, 8, directed=request.param, weighted=True, seed=3)
    return jg, _twin(jg)


@pytest.mark.parametrize("caps", [{}, LADDER], ids=["default", "ladder"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_adaptive_matches_jax(graphs, dtype, caps):
    jg, tg = graphs
    jdt, tdt = DTYPES[dtype]
    tier_totals = np.zeros(len(jsssp.sssp_tiers(1 << 16, 1 << 18, JConfig(**caps))) + 1, int)
    for src in (0, 1, 77):
        jd, jn, js = jsssp.sssp_adaptive_run(jg, src, JConfig(**caps), jdt, with_stats=True)
        td, tn, ts = tsssp.sssp_adaptive_run(tg, src, PlatformConfig(device="cpu", **caps), tdt,
                                             with_stats=True)
        assert td.dtype == tdt
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert (tn, ts) == (jn, js)
        tier_totals += list(ts["tier_steps"].values()) + [ts["full_steps"]]
    if caps:
        # the upper tiers and the full sweep each ran (the 8-edge tier
        # fits no changed set of this graph)
        assert (tier_totals[1:] > 0).all(), tier_totals


@pytest.mark.parametrize("impl", ["auto", "adaptive", "device"])
@pytest.mark.parametrize("precision", list(DTYPES))
def test_run_algorithm_matches_jax(graphs, impl, precision):
    jg, tg = graphs
    want = j_run_algorithm("sssp", jg, JParams(source_vertex=5),
                           JConfig(sssp_impl=impl, precision=precision))
    got = run_algorithm("sssp", tg, AlgorithmParams(source_vertex=5),
                        PlatformConfig(device="cpu", sssp_impl=impl, precision=precision))
    assert got.values.dtype == np.float64
    np.testing.assert_array_equal(got.values, want.values)
    assert got.iterations == want.iterations
    assert np.isinf(got.values).any() and np.isfinite(got.values).sum() > 1


@pytest.mark.parametrize("spec", ["", "1024", "8,32,128", "4096,16,64"])
def test_sssp_tiers_match_jax(spec):
    for k_cap, e_cap in ((1 << 16, 1 << 18), (8, 8), (1, 1), (100, 7)):
        assert tsssp.sssp_tiers(k_cap, e_cap, PlatformConfig(sssp_tiers=spec)) == \
            jsssp.sssp_tiers(k_cap, e_cap, JConfig(sssp_tiers=spec))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_relax_min_plain_matches_jax(graphs, dtype):
    """K8's plain version against sssp.py:140-145 on a tier expansion of
    the graph (pad slots, and targets reached from two slots with equal
    candidates, included)."""
    jg, tg = graphs
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    n = tg.n
    dist = np.where(rng.random(n) < 0.5, np.inf, rng.random(n) * 4).astype(jdt)
    w = (rng.random(tg.nnz) + 0.01).astype(jdt)
    w[1] = w[0]  # two slots of row 0 with one candidate, when they share a target
    ids = np.full(64, n, dtype=np.int32)
    ids[:40] = np.sort(rng.choice(n, size=40, replace=False))
    ids[0] = 0
    deg_pad = jnp.asarray(np.concatenate([jg.out_degree, [0]]).astype(np.int32))
    exp = j_expand(jnp.asarray(ids), deg_pad, jnp.asarray(jg.indptr.astype(np.int32)),
                   jnp.asarray(jg.dst.astype(np.int32)), 1024)
    du = jnp.asarray(dist)[jnp.where(exp.valid, exp.row_ids, 0)]
    cand = du + jnp.asarray(w)[exp.gpos]
    targets = jnp.where(exp.valid, exp.neigh, n)
    want = jnp.asarray(dist).at[targets].min(jnp.where(exp.valid, cand, jnp.inf), mode="drop")
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    args = (t(dist), t(exp.row_ids), t(exp.neigh), t(exp.gpos), t(exp.valid), t(w))
    got = relax_min(*args)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(relax_min_plain(*args).numpy(), got.numpy())
    assert (got.numpy() < dist).any()


def test_relax_min_refuses_bad_arguments():
    d = torch.zeros(4)
    i = torch.zeros(3, dtype=torch.int32)
    v = torch.ones(3, dtype=torch.bool)
    with pytest.raises(TypeError, match="share a float dtype"):
        relax_min(d, i, i, i, v, torch.zeros(4, dtype=torch.float64))
    with pytest.raises(TypeError, match="int32"):
        relax_min(d, i.long(), i, i, v, d)
    with pytest.raises(ValueError, match="one length"):
        relax_min(d, i, i[:2], i, v, d)


def test_errors():
    jg = j_rmat_graph(6, 4, directed=True, weighted=True, seed=1)
    tg = _twin(jg)
    cpu = PlatformConfig(device="cpu")
    with pytest.raises(ValueError, match="requires source-vertex"):
        run_algorithm("sssp", tg, AlgorithmParams(), cpu)
    with pytest.raises(ValueError, match="not in graph"):
        run_algorithm("sssp", tg, AlgorithmParams(source_vertex=-3), cpu)
    with pytest.raises(ValueError, match="weight-property"):
        run_algorithm("sssp", tg, AlgorithmParams(source_vertex=0, weight_property="cost"), cpu)
    # delta-stepping and the hybrid are ported: they run, and agree with the default impl
    for impl in ("delta", "hybrid"):
        got = run_algorithm("sssp", tg, AlgorithmParams(source_vertex=0),
                            PlatformConfig(device="cpu", sssp_impl=impl))
        np.testing.assert_array_equal(
            got.values, run_algorithm("sssp", tg, AlgorithmParams(source_vertex=0), cpu).values)
    # "dense" is the JAX package's one-chip dense kernel: the port runs it as
    # "device", with the JAX package's distances and round count
    want = j_run_algorithm("sssp", jg, JParams(source_vertex=0), JConfig(sssp_impl="dense"))
    dense = run_algorithm("sssp", tg, AlgorithmParams(source_vertex=0),
                          PlatformConfig(device="cpu", sssp_impl="dense"))
    np.testing.assert_array_equal(dense.values, want.values)
    assert dense.iterations == want.iterations
    with pytest.raises(ValueError, match="unknown sssp-impl"):
        run_algorithm("sssp", tg, AlgorithmParams(source_vertex=0),
                      PlatformConfig(device="cpu", sssp_impl="bogus"))
    res = run_algorithm("sssp", tg, AlgorithmParams(source_vertex=0, weight_property="weight"), cpu)
    assert res.values[0] == 0.0


@pytest.mark.parametrize("impl", ["auto", "device"])
@pytest.mark.parametrize("name", GOLDENS)
def test_golden_through_platform(fixtures_dir, tmp_path, name, impl):
    spec = GraphSpec.from_properties(fixtures_dir / f"{name}.properties")
    assert spec.params["sssp"].source_vertex is not None
    assert spec.params["sssp"].weight_property == "weight"
    plat = GraphTorchPlatform(PlatformConfig(device="cpu", intermediate_dir=str(tmp_path),
                                             sssp_impl=impl))
    plat.load_graph(spec)
    plat.startup(log_dir=str(tmp_path / "logs"))
    plat.prepare(spec, "sssp")
    res = plat.run(spec, "sssp")
    assert plat.finalize().processing_time_seconds >= 0
    ok, msg = validate_result(res, plat.graphs[spec.name], str(fixtures_dir / f"{name}-SSSP"))
    assert ok, msg


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_through_cli(fixtures_dir, tmp_path, capsys, name):
    out_file = tmp_path / "out"
    rc = cli_main([
        "run", "--graph-properties", str(fixtures_dir / f"{name}.properties"),
        "--algorithm", "sssp", "--device", "cpu", "--intermediate-dir", str(tmp_path),
        "--output-file", str(out_file),
        "--validation-file", str(fixtures_dir / f"{name}-SSSP"),
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "validation: PASS" in out, out
    golden = (fixtures_dir / f"{name}-SSSP").read_text()
    assert ("infinity" in out_file.read_text()) == ("infinity" in golden)


@pytest.mark.parametrize("directed", [True, False])
def test_edgeless_graph(directed):
    """Vertices without edges (the JAX package raises here): BFS and SSSP
    reach only the source, WCC keeps every vertex apart, for every impl."""
    e = np.empty(0, np.int32)
    tg = Graph(4, e, e, None, np.array([10, 11, 12, 13]), directed, False)
    for impl in ("auto", "device"):
        cfg = PlatformConfig(device="cpu", bfs_impl=impl, wcc_impl=impl, sssp_impl=impl)
        bfs = run_algorithm("bfs", tg, AlgorithmParams(source_vertex=11), cfg)
        assert bfs.values.tolist() == [np.iinfo(np.int64).max, 0] + [np.iinfo(np.int64).max] * 2
        assert bfs.iterations == 1
        sssp = run_algorithm("sssp", tg, AlgorithmParams(source_vertex=11), cfg)
        assert sssp.values.tolist() == [np.inf, 0.0, np.inf, np.inf]
        wcc = run_algorithm("wcc", tg, AlgorithmParams(), cfg)
        assert wcc.values.tolist() == [10, 11, 12, 13]
