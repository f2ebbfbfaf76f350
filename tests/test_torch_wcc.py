"""graphtpu_torch's WCC against the JAX package, on the CPU.

Both packages get the same graph (the JAX package's RMAT generator, handed
over as numpy arrays). Labels (not only the partition), iteration counts
and the adaptive runs' counts of full and active steps must be equal, for
every impl. Small capacities force both phases. The slab kernel K6's plain
version is held against the JAX expressions it replaces, and the golden
fixtures validate through the port's platform and CLI.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.algorithms import wcc as jwcc
from graphtpu.algorithms.common import run_algorithm as j_run_algorithm
from graphtpu.core.semiring import MIN_SECOND as J_MIN_SECOND
from graphtpu.ops import spmv as jspmv
from graphtpu.utils.config import AlgorithmParams as JParams
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import wcc as twcc
from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.cli import main as cli_main
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.semiring import MIN_SECOND
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.harness.platform import GraphTorchPlatform
from graphtpu_torch.harness.validator import validate_result
from graphtpu_torch.ops.spmv import build_pull_plan, slab_spmv, slab_spmv_min
from graphtpu_torch.utils.config import AlgorithmParams, GraphSpec, PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

GOLDENS = ["example-directed", "example-undirected", "test-wcc-directed", "test-wcc-undirected"]
# (rows, edges): the default caps, caps under which iteration 0 overflows
# and full steps precede active ones, and caps so small no active set fits
CAPS = {"default": {}, "mid": dict(wcc_frontier_rows=128, wcc_frontier_edges=1024),
        "tiny": dict(wcc_frontier_rows=16, wcc_frontier_edges=64)}


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, jg.directed, False)


@pytest.fixture(scope="module", params=[True, False], ids=["directed", "undirected"])
def graphs(request):
    # several components: a sparse RMAT leaves isolated vertices and islands
    jg = j_rmat_graph(9, 4, directed=request.param, seed=11)
    return jg, _twin(jg)


def test_symmetrized_matches_jax(graphs):
    jg, tg = graphs
    js, ts = jg.symmetrized(), tg.symmetrized()
    assert ts is tg.symmetrized()  # memoized
    assert (ts.directed, ts.weighted, ts.n, ts.nnz) == (False, False, js.n, js.nnz)
    np.testing.assert_array_equal(ts.src, js.src)
    np.testing.assert_array_equal(ts.dst, js.dst)
    if not tg.directed:
        assert ts is tg


@pytest.mark.parametrize("caps", list(CAPS), ids=list(CAPS))
@pytest.mark.parametrize("impl", ["auto", "slab", "adaptive"])
def test_adaptive_matches_jax(graphs, impl, caps):
    jg, tg = graphs
    cfg = dict(CAPS[caps], wcc_impl=impl)
    jl, jn, js = jwcc.wcc_adaptive_run(jg, JConfig(**cfg), with_stats=True)
    tl, tn, ts = twcc.wcc_adaptive_run(tg, PlatformConfig(device="cpu", **cfg), with_stats=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tn, ts) == (jn, js)
    assert ts["full_steps"] >= 1
    if caps != "tiny":
        assert ts["active_steps"] >= 1
    if caps == "mid":
        assert ts["full_steps"] >= 2


@pytest.mark.parametrize("impl", ["auto", "slab", "adaptive", "device"])
def test_run_algorithm_matches_jax(graphs, impl):
    jg, tg = graphs
    want = j_run_algorithm("wcc", jg, JParams(), JConfig(wcc_impl=impl))
    got = run_algorithm("wcc", tg, AlgorithmParams(), PlatformConfig(device="cpu", wcc_impl=impl))
    np.testing.assert_array_equal(got.values, want.values)
    assert got.iterations == want.iterations
    assert len(np.unique(got.values)) > 1


def test_unknown_impl_is_refused(graphs):
    _, tg = graphs
    with pytest.raises(ValueError, match="unknown wcc-impl"):
        run_algorithm("wcc", tg, AlgorithmParams(), PlatformConfig(device="cpu", wcc_impl="dense"))


def _slabs(seed, w, r, n):
    rng = np.random.default_rng(seed)
    slab = rng.integers(0, n, size=(w, r)).astype(np.int32)
    deg = rng.integers(0, w + 1, size=r)
    slab[np.arange(w)[:, None] >= deg[None, :]] = -1
    return slab, rng.integers(0, n, size=n).astype(np.int32)


@pytest.mark.parametrize("w", [1, 3, 32, 100])
def test_slab_spmv_min_plain_matches_jax(w):
    """K6's plain version against the JAX expressions it replaces: the
    min.second bucket body (gather mode) and WCC's iteration-0 row min of
    the stored ids (identity mode); columns without entries give INT32_INF."""
    n = 700
    slab, x = _slabs(w, w, 500, n)
    js = jnp.asarray(slab)
    want_gather = jnp.min(jnp.where(js >= 0, jnp.asarray(x)[jnp.where(js >= 0, js, 0)], INT32_INF),
                          axis=0)
    want_ident = jnp.min(jnp.where(js >= 0, js, INT32_INF), axis=0)
    got = slab_spmv_min(torch.from_numpy(slab), torch.from_numpy(x), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_gather))
    got = slab_spmv_min(torch.from_numpy(slab), None, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ident))


def test_slab_spmv_min_semiring_matches_jax(graphs):
    """slab_spmv(min.second) over int32 routes to K6 and K7 and equals the
    JAX package's, heavy rows included (small buckets force them)."""
    jg, tg = graphs
    sym_j, sym_t = jg.symmetrized(), tg.symmetrized()
    x = np.random.default_rng(0).integers(0, tg.n, size=tg.n).astype(np.int32)
    for buckets in (None, (2, 4)):
        jplan = jspmv.build_pull_plan(sym_j, with_values=False, buckets=buckets)
        tplan = build_pull_plan(sym_t, device="cpu", with_values=False, buckets=buckets)
        assert (tplan.heavy_rows is not None) == (buckets is not None)
        want = jspmv.slab_spmv(J_MIN_SECOND, jplan, jnp.asarray(x), tg.n)
        got = slab_spmv(MIN_SECOND, tplan, torch.from_numpy(x), tg.n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_slab_spmv_min_refuses_bad_arguments():
    slab = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(TypeError, match="slab must be"):
        slab_spmv_min(slab.to(torch.int64), None, 4)
    with pytest.raises(TypeError, match="x must be"):
        slab_spmv_min(slab, torch.zeros(3, dtype=torch.int32), 4)


@pytest.mark.parametrize("impl", ["auto", "device"])
@pytest.mark.parametrize("name", GOLDENS)
def test_golden_through_platform(fixtures_dir, tmp_path, name, impl):
    spec = GraphSpec.from_properties(fixtures_dir / f"{name}.properties")
    plat = GraphTorchPlatform(PlatformConfig(device="cpu", intermediate_dir=str(tmp_path),
                                             wcc_impl=impl))
    plat.load_graph(spec)
    plat.startup(log_dir=str(tmp_path / "logs"))
    plat.prepare(spec, "wcc")
    res = plat.run(spec, "wcc")
    assert plat.finalize().processing_time_seconds >= 0
    ok, msg = validate_result(res, plat.graphs[spec.name], str(fixtures_dir / f"{name}-WCC"))
    assert ok, msg


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_through_cli(fixtures_dir, tmp_path, capsys, name):
    rc = cli_main([
        "run", "--graph-properties", str(fixtures_dir / f"{name}.properties"),
        "--algorithm", "wcc", "--device", "cpu", "--intermediate-dir", str(tmp_path),
        "--output-file", str(tmp_path / "out"),
        "--validation-file", str(fixtures_dir / f"{name}-WCC"),
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "validation: PASS" in out, out
