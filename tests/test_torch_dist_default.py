"""The JAX package's default distributed CDLP, PageRank and LCC in the port
(graphtpu_torch/parallel/slab_cdlp.py, slab_pr.py, wedge_lcc.py) and the
routing of run_algorithm to every default loop, over gloo groups of 2 and
4 CPU ranks, held against the JAX package's (graphtpu/parallel/) on a mesh
of as many CPU devices.

Both packages get the same RMAT graphs (scale 10, edge factor 8, directed
and undirected), handed over as arrays. The host plans (the bucket-split
slab plans) equal the JAX package's array for array, and so does what each
rank holds, gathered back, against the JAX package's per-device slices
(the wedge plan's bucket columns included). CDLP labels, LCC coefficients
and iteration counts are bit for bit; PageRank in float64 within 1e-12
relative (the sums add in another order). The rank groups run with a
collective timeout of 120 s, so that a rank that waits alone fails the test
instead of the suite's clock.
"""

import logging

import numpy as np
import pytest
import torch

from graphtpu.ingest.loader import load_graph_from_spec as j_load
from graphtpu.parallel import ShardedGraph as JShardedGraph
from graphtpu.parallel import make_mesh as j_make_mesh
from graphtpu.parallel.adaptive_wcc import _build_slab_plan as j_wcc_slab_plan
from graphtpu.parallel.slab_cdlp import build_dist_slab_plan as j_build_plan
from graphtpu.parallel.slab_cdlp import build_dist_slab_plan_from as j_build_plan_from
from graphtpu.parallel.slab_cdlp import cdlp_slab_dist as j_cdlp_slab_dist
from graphtpu.parallel.slab_pr import pr_slab_dist as j_pr_slab_dist
from graphtpu.parallel.wedge_lcc import lcc_oriented_dist as j_lcc_oriented_dist
from graphtpu.utils.config import GraphSpec as JSpec
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import common as tcommon
from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.harness.validator import validate_result
from graphtpu_torch.parallel import dispatch
from graphtpu_torch.parallel import mesh as mesh_mod
from graphtpu_torch.parallel.adaptive_wcc import _build_slab_plan
from graphtpu_torch.parallel.mesh import close_mesh, make_mesh
from graphtpu_torch.parallel.partition import ShardedGraph, _round_up
from graphtpu_torch.parallel.slab_cdlp import (
    build_dist_slab_plan, build_dist_slab_plan_from, cdlp_slab_dist,
)
from graphtpu_torch.parallel.slab_pr import pr_slab_dist
from graphtpu_torch.parallel.wedge_lcc import lcc_oriented_dist
from graphtpu_torch.utils.config import AlgorithmParams, GraphSpec, PlatformConfig
from graphtpu_torch.utils.synth import uniform_graph

from conftest import FIXTURES
from torch_dist_gather import gather_at, tests_on_worker_path  # noqa: F401
from torch_native_env import jax_native_on_port_build  # noqa: F401

SUFFIX = {"bfs": "BFS", "pr": "PR", "wcc": "WCC", "cdlp": "CDLP", "sssp": "SSSP", "lcc": "LCC"}
RTOL = 1e-12
BUCKETS = (4, 8, 16, 32)  # small buckets: many rows take the heavy stream
GROUP_TIMEOUT_S = 120.0


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w if jg.weighted else None, jg.mapping,
                             jg.directed, jg.weighted)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request):
    # rank 0 takes one thread, as the worker ranks do (the CPU ranks share
    # one host, and so do the suite's other test processes)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh_mod, "GROUP_TIMEOUT_S", GROUP_TIMEOUT_S)
        close_mesh()  # a live mesh of another module keeps its own timeout
        make_mesh(request.param, "cpu")
        yield request.param
        close_mesh()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[False, True], ids=["undirected", "directed"])
def rmat(request):
    jg = j_rmat_graph(10, 8, directed=request.param, seed=7)
    return jg, _twin(jg)


def _pair(ranks, rmat, wdtype=np.float32):
    jg, g = rmat
    return (ShardedGraph(g, make_mesh(ranks, "cpu"), wdtype=wdtype),
            JShardedGraph(jg, j_make_mesh(ranks), wdtype=wdtype))


def _plans_equal(plan, jplan):
    assert len(plan.bucket_slabs) == len(jplan.bucket_slabs)
    for a, b in zip(plan.bucket_slabs, jplan.bucket_slabs):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (plan.heavy is None) == (jplan.heavy is None)
    for a, b in zip(plan.heavy or (), jplan.heavy or ()):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(plan.inv_perm, np.asarray(jplan.inv_perm))
    np.testing.assert_array_equal(plan.has_neighbors, np.asarray(jplan.has_neighbors))


def _held_equal(sg, key, plan):
    """What the ranks hold of ``plan`` under ``key``, gathered back."""
    slabs = gather_at(sg, key, "plan", "table", "slabs")
    for a, b in zip(slabs, plan.bucket_slabs, strict=True):
        np.testing.assert_array_equal(a, b)
    if plan.heavy is not None:
        for a, b in zip(gather_at(sg, key, "heavy"), plan.heavy, strict=True):
            np.testing.assert_array_equal(a, b)
    for held, rep in ((gather_at(sg, key, "plan", "inv_perm"), plan.inv_perm),
                      (gather_at(sg, key, "has_neighbors"), plan.has_neighbors)):
        assert all(np.array_equal(row, rep) for row in held[0])  # replicated


def test_slab_plans_equal_jax(ranks, rmat):
    """The CDLP incidence plans (small and DP-optimal buckets), the PageRank
    pull plan and the WCC symmetrized plan, on the host and as the ranks
    hold them."""
    jg, g = rmat
    sg, jsg = _pair(ranks, rmat)
    jmesh = j_make_mesh(ranks)
    for buckets in (BUCKETS, None):
        plan = build_dist_slab_plan(g, ranks, buckets)
        _plans_equal(plan, j_build_plan(jg, jmesh, buckets))
        cdlp_slab_dist(sg, 2, buckets)
        _held_equal(sg, (sg.key, "cdlp-slab"), plan)
    src, dst, _ = g.pull_arrays()
    jsrc, jdst, _ = jg.pull_arrays()
    pr_plan = build_dist_slab_plan_from(dst.astype(np.int64), src.astype(np.int32), g.n, ranks)
    _plans_equal(pr_plan, j_build_plan_from(jdst.astype(np.int64), jsrc.astype(np.int32), jg.n,
                                            jmesh))
    pr_slab_dist(sg, 0.85, 1)
    _held_equal(sg, (sg.key, "pr-pull"), pr_plan)
    (deg,) = gather_at(sg, (sg.key, "out-degree"), 0)
    assert all(np.array_equal(row, g.out_degree) for row in deg)
    _plans_equal(_build_slab_plan(sg), j_wcc_slab_plan(jsg))
    sg.release()


def test_cdlp_slab_dist_matches_jax(ranks, rmat):
    """Labels and iterations bit for bit, with small buckets (heavy rows on
    every rank) and with the DP-optimal ones, the plan installed again for
    the second bucket choice; and against the port's one-device slab run."""
    sg, jsg = _pair(ranks, rmat)
    for buckets in (BUCKETS, None):
        labels, it = cdlp_slab_dist(sg, 10, buckets)
        jlabels, jit = j_cdlp_slab_dist(jsg, 10, buckets)
        np.testing.assert_array_equal(labels, np.asarray(jlabels))
        assert it == jit
    cfg = PlatformConfig(device="cpu", cdlp_impl="slab")
    one = run_algorithm("cdlp", rmat[1], AlgorithmParams(max_iterations=10), cfg)
    np.testing.assert_array_equal(rmat[1].mapping[labels], one.values)
    assert it == one.iterations
    sg.release()


def test_pr_slab_dist_matches_jax(ranks, rmat):
    """Ranks within 1e-12 relative in float64, against the JAX package and
    against the port's one-device slab arm."""
    sg, jsg = _pair(ranks, rmat, wdtype=np.float64)
    r = pr_slab_dist(sg, 0.85, 10, dtype=np.float64)
    jr = np.asarray(j_pr_slab_dist(jsg, 0.85, 10, dtype=np.float64))
    assert r.dtype == np.float64 and r.shape == jr.shape
    np.testing.assert_allclose(r, jr, rtol=RTOL, atol=0)
    one = run_algorithm("pr", rmat[1], AlgorithmParams(damping_factor=0.85, num_iterations=10),
                        PlatformConfig(device="cpu", precision="float64"))
    np.testing.assert_allclose(r, one.values, rtol=RTOL, atol=0)
    sg.release()


def test_lcc_oriented_dist_matches_jax(ranks, rmat):
    """Coefficients bit for bit against the JAX package's; each rank's
    columns of every wedge bucket, gathered back, equal the JAX package's
    per-device slices of its plan."""
    jg, g = rmat
    sg, jsg = _pair(ranks, rmat)
    coeff = lcc_oriented_dist(sg)
    np.testing.assert_array_equal(coeff, j_lcc_oriented_dist(jsg))
    jplan = jg._wedge_plan  # the plan the JAX run memoized
    for k, b in enumerate(jplan.buckets):
        slab, mslab = np.asarray(b.slab), np.asarray(b.mslab)
        w, r_pad = slab.shape
        r_dev = _round_up(-(-r_pad // ranks), b.chunk_cols)
        pad = ((0, 0), (0, r_dev * ranks - r_pad))
        for held, want, fill in ((0, slab, -1), (1, mslab, 0)):
            want = np.pad(want, pad, constant_values=fill).reshape(w, ranks, r_dev)
            (got,) = gather_at(sg, (sg.key, "lcc-wedge"), "buckets", k, held)
            np.testing.assert_array_equal(got, want.transpose(1, 0, 2))
    sg.release()


def _release(g):
    """Drop ``g``'s sharded views on every rank, keeping the ranks."""
    for key in [k for k in dispatch._sharded_cache if k[0] == id(g)]:
        dispatch._sharded_cache.pop(key).release()


def _one_device_trap(graph, params, cfg):
    raise AssertionError("the one-device path ran under num-devices > 1")


@pytest.mark.parametrize("name", ["example-directed", "example-undirected"])
def test_dispatch_defaults_all_six(ranks, name, monkeypatch, tmp_path):
    """run_algorithm under num-devices = D and no impl set runs all six
    algorithms over the ranks (the one-device functions are replaced by a
    trap), warns nothing, and validates the example goldens."""
    tspec = GraphSpec.from_properties(FIXTURES / f"{name}.properties")
    g = _twin(j_load(JSpec.from_properties(FIXTURES / f"{name}.properties"), use_cache=False))
    for algo in tcommon.ALGORITHMS:
        monkeypatch.setitem(tcommon.ALGORITHMS, algo, _one_device_trap)
    warnings = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    logging.getLogger("graphtpu_torch").addHandler(handler)
    cfg = PlatformConfig(device="cpu", num_devices=ranks, precision="float64",
                         intermediate_dir=str(tmp_path))
    try:
        for algo in tspec.algorithms:
            res = run_algorithm(algo, g, tspec.params.get(algo), cfg)
            ok, msg = validate_result(res, g, str(FIXTURES / f"{name}-{SUFFIX[algo]}"))
            assert ok, f"{name}/{algo} over {ranks} ranks: {msg}"
    finally:
        logging.getLogger("graphtpu_torch").removeHandler(handler)
        _release(g)
    assert not warnings, warnings


def test_edgeless_graph_runs_every_default(ranks):
    """A graph with vertices and no edges: the defaults run over the ranks
    and equal the port's one-device runs (the JAX package's BFS, WCC and
    SSSP raise there, fault F5)."""
    g = uniform_graph(300, 0, directed=True, seed=1)
    cfg = PlatformConfig(device="cpu", num_devices=ranks, precision="float64")
    one_cfg = PlatformConfig(device="cpu", precision="float64")
    params = {"pr": AlgorithmParams(damping_factor=0.85, num_iterations=3),
              "cdlp": AlgorithmParams(max_iterations=3), "lcc": AlgorithmParams(),
              "wcc": AlgorithmParams(), "bfs": AlgorithmParams(source_vertex=int(g.mapping[5])),
              "sssp": AlgorithmParams(source_vertex=int(g.mapping[5]))}
    try:
        for algo, p in params.items():
            res = dispatch.try_run_distributed(algo, g, p, cfg)
            one = run_algorithm(algo, g, p, one_cfg)
            np.testing.assert_allclose(res.values, one.values, rtol=RTOL, atol=0)
    finally:
        _release(g)


def test_release_drops_every_plan(ranks):
    """The default loops' plans are installed once per ShardedGraph (a
    second run sends only keys) and ``purge_sharded`` drops them all."""
    g = uniform_graph(400, 3000, directed=True, weighted=True, seed=2)
    cfg = PlatformConfig(device="cpu", num_devices=ranks)
    params = {"pr": AlgorithmParams(damping_factor=0.85, num_iterations=2),
              "cdlp": AlgorithmParams(max_iterations=2), "lcc": AlgorithmParams(),
              "wcc": AlgorithmParams(), "bfs": AlgorithmParams(source_vertex=int(g.mapping[0])),
              "sssp": AlgorithmParams(source_vertex=int(g.mapping[0]))}
    mesh = make_mesh(ranks, "cpu")
    for algo, p in params.items():
        dispatch.try_run_distributed(algo, g, p, cfg)
    (sg,) = [s for k, s in dispatch._sharded_cache.items() if k[0] == id(g)]
    kinds = {k for k in sg._installed}
    assert {"pr-pull", "out-degree", "cdlp-slab", "lcc-wedge", "wcc-adaptive", "wcc-slab",
            "bfs-adaptive-2", "sssp-adaptive-float32", "pull"} <= kinds
    held = {k for k in mesh.state if k[0] == sg.key}
    assert held == {(sg.key, k) for k in kinds}
    calls = []
    real_call = mesh.call
    mesh.call = lambda fn, args: calls.append(fn.__name__) or real_call(fn, args)
    try:
        for algo, p in params.items():
            dispatch.try_run_distributed(algo, g, p, cfg)
    finally:
        del mesh.call
    assert calls == ["_pr_body", "_cdlp_body", "_lcc_body", "_wcc_slab_body", "_bfs_body",
                     "_sssp_body"]
    dispatch.purge_sharded(g)
    assert not {k for k in mesh.state if k[0] == sg.key}
