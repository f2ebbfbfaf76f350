"""graphtpu_torch's host side against the JAX package's: synthetic graphs,
.v/.e ingest, slab plans, the binary cache and the serializer must all
give identical arrays and bytes."""

import numpy as np
import pytest
import torch

from graphtpu.core.graph import Graph as JGraph
from graphtpu.ingest import cache as jcache
from graphtpu.ingest.relabel import relabel as j_relabel
from graphtpu.ops.slab import build_slab_plan as j_build_slab_plan
from graphtpu.utils import synth as jsynth
from graphtpu.utils.config import GraphSpec as JGraphSpec

from graphtpu_torch.algorithms.cdlp import build_incidence
from graphtpu_torch.algorithms.common import AlgorithmResult
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.ingest import cache as tcache
from graphtpu_torch.ingest.relabel import relabel
from graphtpu_torch.ops.slab import build_slab_plan
from graphtpu_torch.utils import synth as tsynth
from graphtpu_torch.utils.config import GraphSpec, PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

CPU = torch.device("cpu")


def _assert_same_graph(tg: Graph, jg: JGraph):
    assert (tg.n, tg.nnz, tg.directed, tg.weighted) == (jg.n, jg.nnz, jg.directed, jg.weighted)
    for a, b in ((tg.src, jg.src), (tg.dst, jg.dst), (tg.mapping, jg.mapping), (tg.w, jg.w)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tg.pull_arrays(), jg.pull_arrays()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tg.pull_indptr, jg.pull_indptr)
    np.testing.assert_array_equal(tg.indptr, jg.indptr)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("directed", [True, False])
def test_synth_graphs_bit_identical(directed, weighted):
    for name, args in (("rmat_graph", (9, 8)), ("uniform_graph", (500, 4000))):
        jg = getattr(jsynth, name)(*args, directed=directed, weighted=weighted, seed=3)
        tg = getattr(tsynth, name)(*args, directed=directed, weighted=weighted, seed=3)
        _assert_same_graph(tg, jg)
    n, s, d = tsynth.rmat_edges(8, 4, seed=9)
    n2, s2, d2 = jsynth.rmat_edges(8, 4, seed=9)
    assert n == n2 and np.array_equal(s, s2) and np.array_equal(d, d2)


def _fixture_specs(fixtures_dir):
    return sorted(fixtures_dir.glob("*.properties"))


def test_ingest_matches_jax_on_every_fixture(fixtures_dir):
    paths = _fixture_specs(fixtures_dir)
    assert len(paths) >= 14
    for p in paths:
        spec, jspec = GraphSpec.from_properties(p), JGraphSpec.from_properties(p)
        assert (spec.name, spec.directed, spec.weighted, spec.algorithms) == (
            jspec.name, jspec.directed, jspec.weighted, jspec.algorithms
        )
        tg = relabel(spec.vertex_path, spec.edge_path, spec.directed, spec.weighted)
        jg = j_relabel(jspec.vertex_path, jspec.edge_path, jspec.directed, jspec.weighted)
        _assert_same_graph(tg, jg)


def test_graph_from_arrays_and_device_views():
    jg = jsynth.rmat_graph(8, 8, directed=True, weighted=True, seed=1)
    tg = Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w, jg.mapping, True, True)
    _assert_same_graph(tg, jg)
    coo = tg.device_pull(CPU, torch.float64)
    s, d, w = jg.pull_arrays()
    np.testing.assert_array_equal(coo.src.numpy(), s)
    np.testing.assert_array_equal(coo.dst.numpy(), d)
    np.testing.assert_array_equal(coo.w.numpy(), w)
    assert tg.device_push(CPU).src.dtype == torch.int32
    assert tg.device_push(CPU).w.dtype == torch.float32


def test_relabel_rejects_bad_input():
    with pytest.raises(ValueError, match="duplicate"):
        Graph.from_original_ids(np.array([1, 1]), np.array([1]), np.array([1]), None, True, False)
    with pytest.raises(ValueError, match="unknown"):
        Graph.from_original_ids(np.array([1, 2]), np.array([1]), np.array([3]), None, True, False)
    with pytest.raises(ValueError, match="conflicting"):
        Graph.from_original_ids(
            np.array([1, 2]), np.array([1, 2]), np.array([2, 1]), np.array([1.0, 2.0]),
            False, True,
        )


@pytest.mark.parametrize("buckets", [None, (4, 8), (16, 64, 256, 1024, 4096)])
@pytest.mark.parametrize("directed", [True, False])
def test_slab_plan_identical_to_jax(directed, buckets):
    from graphtpu.algorithms.cdlp import build_incidence as j_build_incidence

    jg = jsynth.rmat_graph(10, 12, directed=directed, seed=0)
    tg = Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, directed, False)
    centers, neigh = build_incidence(tg)
    jc, jn = j_build_incidence(jg)
    np.testing.assert_array_equal(centers, jc)
    np.testing.assert_array_equal(neigh, jn)
    deg = np.bincount(centers, minlength=tg.n).astype(np.int64)
    values = np.random.default_rng(0).random(centers.shape[0]).astype(np.float32)
    jplan = j_build_slab_plan(jc, jn, deg, jg.n, buckets, values=values)
    plan = build_slab_plan(centers, neigh, deg, tg.n, buckets, values=values, device=CPU)
    assert len(plan.slabs) == len(jplan.slabs)
    for b, jb in zip(plan.slabs, jplan.slabs):
        for f in ("rows", "slab", "values"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(jb, f)))
    for f in ("heavy_rows", "heavy_centers", "heavy_neigh", "heavy_values",
              "heavy_indptr", "rest_rows", "inv_perm"):
        a, ja = getattr(plan, f), getattr(jplan, f)
        assert (a is None) == (ja is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja), err_msg=f)


def test_cache_interchanges_with_jax(tmp_path):
    jg = jsynth.rmat_graph(8, 8, directed=False, weighted=True, seed=2)
    tg = Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w, jg.mapping, False, True)
    tcache.save(tg, tmp_path, "g")
    _assert_same_graph(tcache.load(tmp_path, "g"), jcache.load(tmp_path, "g"))
    jcache.save(jg, tmp_path, "h")
    _assert_same_graph(tcache.load(tmp_path, "h"), jg)


@pytest.mark.parametrize("algo", ["pr", "cdlp", "sssp", "bfs"])
def test_serializer_bytes_match_jax(algo, tmp_path):
    from graphtpu.algorithms.common import AlgorithmResult as JResult

    jg = jsynth.uniform_graph(300, 900, directed=True, seed=4)
    tg = Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, True, False)
    rng = np.random.default_rng(4)
    if algo in ("pr", "sssp"):
        vals = rng.random(jg.n) * 10.0 ** rng.integers(-12, 3, size=jg.n)
        vals[::7] = np.inf
    else:
        vals = rng.integers(0, 1 << 40, size=jg.n)
        vals[::7] = np.iinfo(np.int64).max
    JResult(algo, vals).write(jg, str(tmp_path / "j.out"))
    AlgorithmResult(algo, vals).write(tg, str(tmp_path / "t.out"))
    assert (tmp_path / "t.out").read_bytes() == (tmp_path / "j.out").read_bytes()


def test_platform_config_reads_the_same_keys(tmp_path):
    p = tmp_path / "platform.properties"
    p.write_text(
        "platform.graphtpu.device = cpu\nplatform.graphtpu.precision = float64\n"
        "platform.graphtpu.cdlp-impl = sort\nplatform.graphtpu.slab-buckets = 4,8\n"
        "platform.graphtpu.iteration-timing = true\nplatform.graphtpu.bfs-impl = dense\n"
    )
    cfg = PlatformConfig.from_properties(p)
    assert (cfg.device, cfg.precision, cfg.cdlp_impl, cfg.slab_buckets, cfg.iteration_timing) == (
        "cpu", "float64", "sort", (4, 8), True
    )
