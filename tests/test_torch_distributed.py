"""The port's distributed base (graphtpu_torch/parallel/) over gloo groups of
2 and 4 CPU ranks, held against the JAX package's naive distributed
kernels (graphtpu/parallel/algorithms.py) and partitions
(graphtpu/parallel/partition.py) on a mesh of as many CPU devices.

Both packages get the same graphs (the two example graphs and a uniform
random one, handed over as arrays). Partitions, held by each rank and
gathered back, must be equal array for array; BFS levels, WCC and CDLP
labels, LCC coefficients (the same integer numerators over the same
degrees) and every iteration count bit for bit; PageRank within 1e-12
relative in float64 (the sums add in another order) and SSSP within 1e-12
relative. Each rank group starts once for the module (4 ranks give an
uneven last block on every graph here).
"""

import logging
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graphtpu.ingest.loader import load_graph_from_spec as j_load
from graphtpu.parallel import ShardedGraph as JShardedGraph
from graphtpu.parallel import algorithms as jdist
from graphtpu.parallel import make_mesh as j_make_mesh
from graphtpu.utils.config import GraphSpec as JSpec
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import uniform_graph as j_uniform_graph

from graphtpu_torch.algorithms import common as tcommon
from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.harness.platform import GraphTorchPlatform
from graphtpu_torch.harness.validator import validate_result
from graphtpu_torch.parallel import algorithms as dist
from graphtpu_torch.parallel import dispatch
from graphtpu_torch.parallel import mesh as mesh_mod
from graphtpu_torch.parallel import partition
from graphtpu_torch.parallel.mesh import current_mesh, make_mesh
from graphtpu_torch.parallel.partition import ShardedGraph
from graphtpu_torch.utils.config import AlgorithmParams, GraphSpec, PlatformConfig

from conftest import FIXTURES
from torch_dist_gather import gather, tests_on_worker_path  # noqa: F401
from torch_native_env import jax_native_on_port_build  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SUFFIX = {"bfs": "BFS", "pr": "PR", "wcc": "WCC", "cdlp": "CDLP", "sssp": "SSSP", "lcc": "LCC"}
NAIVE = dict(pr_impl="segment", bfs_impl="dense", sssp_impl="dense", wcc_impl="dense",
             cdlp_impl="sort", lcc_impl="sweep")
RTOL = 1e-12


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w if jg.weighted else None, jg.mapping,
                             jg.directed, jg.weighted)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request):
    # rank 0 takes one thread, as the worker ranks do (the CPU ranks share
    # one host, and so do the suite's other test processes)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    make_mesh(request.param, "cpu")
    yield request.param
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["example-directed", "example-undirected", "random"])
def graphs(request):
    if request.param == "random":
        jg = j_uniform_graph(700, 5000, directed=True, weighted=True, seed=3)
        return None, jg, _twin(jg)
    spec = JSpec.from_properties(FIXTURES / f"{request.param}.properties")
    jg = j_load(spec, use_cache=False)
    return spec, jg, _twin(jg)


def _pair(ranks, graphs, wdtype=np.float64):
    """The port's and the JAX package's sharded views of one graph."""
    _, jg, tg = graphs
    sg = ShardedGraph(tg, make_mesh(ranks, "cpu"), wdtype=wdtype)
    jsg = JShardedGraph(jg, j_make_mesh(ranks), wdtype=wdtype)
    return sg, jsg


def _equal(port, jax_arrays):
    assert len(port) == len(jax_arrays)
    for a, b in zip(port, jax_arrays):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_partitions_equal_jax(ranks, graphs):
    sg, jsg = _pair(ranks, graphs)
    assert (sg.n_pad, sg.rows_per_dev, sg.num_devices) == (jsg.n_pad, jsg.rows_per_dev, ranks)
    _equal(sg.pull_host()[:4], jsg.pull())
    _equal(sg.pull_symmetrized_host()[:4], jsg.pull_symmetrized())
    _equal(sg.incidence_host()[:3], jsg.incidence())
    # what each rank holds on its device, gathered back
    _equal(gather(sg, sg.pull()), jsg.pull())
    _equal(gather(sg, sg.pull_symmetrized()), jsg.pull_symmetrized())
    _equal(gather(sg, sg.incidence()), jsg.incidence())
    np.testing.assert_array_equal(sg.out_degree_padded(), np.asarray(jsg.out_degree_padded()))
    np.testing.assert_array_equal(sg.incidence_degree_padded(),
                                  np.asarray(jsg.incidence_degree_padded()))
    sg.release()


def test_pr_matches_jax(ranks, graphs):
    sg, jsg = _pair(ranks, graphs)
    ranks_t = dist.pr_dist(sg, 0.85, 10, dtype=np.float64, cfg=PlatformConfig(pr_impl="segment"))
    ranks_j = jdist.pr_dist(jsg, 0.85, 10, dtype=np.float64, cfg=JConfig(pr_impl="segment"))
    np.testing.assert_allclose(ranks_t, ranks_j, rtol=RTOL, atol=0)
    sg.release()


def test_traversals_match_jax_bit_for_bit(ranks, graphs):
    """BFS levels, WCC labels, CDLP labels, LCC coefficients and each loop's
    iteration count; SSSP distances within 1e-12 relative."""
    sg, jsg = _pair(ranks, graphs)
    src = int(np.argmax(graphs[1].out_degree))  # a source that reaches the graph
    naive = PlatformConfig(**NAIVE)
    for got, want in (
        (dist.bfs_dist(sg, src, naive), jdist.bfs_dist(jsg, src, JConfig(bfs_impl="dense"))),
        (dist.wcc_dist(sg, naive), jdist.wcc_dist(jsg, JConfig(wcc_impl="dense"))),
        (dist.cdlp_dist(sg, 10, naive), jdist.cdlp_dist(jsg, 10, JConfig(cdlp_impl="sort"))),
    ):
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        assert got[1] == want[1]
    d, it = dist.sssp_dist(sg, src, naive)
    jd, jit = jdist.sssp_dist(jsg, src, JConfig(sssp_impl="dense"))
    np.testing.assert_allclose(d, jd, rtol=RTOL, atol=0)
    assert it == jit and np.isinf(d).sum() == np.isinf(jd).sum()
    np.testing.assert_array_equal(dist.lcc_dist(sg, naive),
                                  jdist.lcc_dist(jsg, JConfig(lcc_impl="sweep")))
    sg.release()


@pytest.mark.parametrize("name", ["example-directed", "example-undirected"])
def test_dispatch_all_six(ranks, name, monkeypatch):
    """run_algorithm under num-devices = D with the naive impls routes every
    algorithm through try_run_distributed (the one-device functions are
    replaced by a trap) and validates the example goldens."""
    tspec = GraphSpec.from_properties(FIXTURES / f"{name}.properties")
    g = _twin(j_load(JSpec.from_properties(FIXTURES / f"{name}.properties"), use_cache=False))
    for algo in tcommon.ALGORITHMS:
        monkeypatch.setitem(tcommon.ALGORITHMS, algo, _one_device_trap)
    cfg = PlatformConfig(device="cpu", num_devices=ranks, precision="float64", **NAIVE)
    for algo in tspec.algorithms:
        res = run_algorithm(algo, g, tspec.params.get(algo), cfg)
        ok, msg = validate_result(res, g, str(FIXTURES / f"{name}-{SUFFIX[algo]}"))
        assert ok, f"{name}/{algo} over {ranks} ranks: {msg}"


def _one_device_trap(graph, params, cfg):
    raise AssertionError("the one-device path ran under num-devices > 1")


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


# the impl names of the port's one-device paths that name the naive loops
# under another name in the JAX package
_JAX_NAME = {("pr", "scan"): "segment", ("bfs", "device"): "dense", ("sssp", "device"): "dense",
             ("wcc", "device"): "dense"}
# algorithm -> the JAX package's distributed functions its wrapper routes to:
# (module, name) of the default loop, then of the naive one
_JAX_TARGETS = {
    "pr": (("graphtpu.parallel.slab_pr", "pr_slab_dist"),
           ("graphtpu.parallel.algorithms", "pr_dist_kernel")),
    "cdlp": (("graphtpu.parallel.slab_cdlp", "cdlp_slab_dist"),
             ("graphtpu.parallel.algorithms", "cdlp_dist_kernel")),
    "bfs": (("graphtpu.parallel.adaptive_bfs", "bfs_adaptive_dist"),
            ("graphtpu.parallel.algorithms", "bfs_dist_kernel")),
    "sssp": (("graphtpu.parallel.adaptive_sssp", "sssp_adaptive_dist"),
             ("graphtpu.parallel.algorithms", "sssp_dist_kernel")),
    "wcc": (("graphtpu.parallel.adaptive_wcc", "wcc_adaptive_dist"),
            ("graphtpu.parallel.algorithms", "wcc_dist_kernel")),
    "lcc": (("graphtpu.parallel.wedge_lcc", "lcc_oriented_dist"),
            ("graphtpu.parallel.algorithms", "_lcc_dist_sweep")),
}


class _Picked(Exception):
    pass


def _jax_pick(algo, impl, jsg, monkeypatch):
    """The module of the distributed function the JAX wrapper of ``algo``
    picks under ``impl`` (each candidate replaced by a spy that stops it)."""
    import importlib

    with monkeypatch.context() as mp:
        for module, name in _JAX_TARGETS[algo]:
            def spy(*args, _module=module, **kwargs):
                raise _Picked(_module.rsplit(".", 1)[1])

            mp.setattr(importlib.import_module(module), name, spy)
        cfg = JConfig(**{f"{algo}_impl": _JAX_NAME.get((algo, impl), impl)})
        call = {"pr": lambda: jdist.pr_dist(jsg, 0.85, 2, dtype=np.float64, cfg=cfg),
                "cdlp": lambda: jdist.cdlp_dist(jsg, 2, cfg),
                "bfs": lambda: jdist.bfs_dist(jsg, 0, cfg),
                "sssp": lambda: jdist.sssp_dist(jsg, 0, cfg),
                "wcc": lambda: jdist.wcc_dist(jsg, cfg),
                "lcc": lambda: jdist.lcc_dist(jsg, cfg)}[algo]
        with pytest.raises(_Picked) as picked:
            call()
    return str(picked.value)


def test_default_impls_warn_and_run_on_one_device(ranks, monkeypatch, tmp_path):
    """Every algorithm under every impl name the port takes runs over the
    ranks (the one-device path never runs, and nothing warns): through the
    distributed loop of the module the JAX package's wrapper picks for that
    name (the port's one-device names scan and device read as segment and
    dense), and validates against the golden files. Before the default
    loops were ported, the JAX defaults warned here and ran on one device."""
    import importlib

    spec = GraphSpec.from_properties(FIXTURES / "example-directed.properties")
    jg = j_load(JSpec.from_properties(FIXTURES / "example-directed.properties"), use_cache=False)
    g = _twin(jg)
    jsg = JShardedGraph(jg, j_make_mesh(ranks), wdtype=np.float64)
    for algo in tcommon.ALGORITHMS:
        monkeypatch.setitem(tcommon.ALGORITHMS, algo, _one_device_trap)
    handler = _Records()
    handler.setLevel(logging.WARNING)
    logger = logging.getLogger("graphtpu_torch")
    logger.addHandler(handler)
    mesh = make_mesh(ranks, "cpu")
    bodies = []

    def spy(fn, per_rank_args, call=mesh.call):
        bodies.append(fn.__module__.rsplit(".", 1)[1])
        return call(fn, per_rank_args)

    monkeypatch.setattr(mesh, "call", spy)
    runs = 0
    try:
        for algo, attr in dispatch.IMPL_ATTRS.items():
            for impl in importlib.import_module(f"graphtpu_torch.algorithms.{algo}").IMPLS:
                cfg = PlatformConfig(device="cpu", num_devices=ranks, precision="float64",
                                     intermediate_dir=str(tmp_path),
                                     **{attr: impl})
                bodies.clear()
                res = dispatch.try_run_distributed(algo, g, spec.params.get(algo), cfg)
                assert bodies[-1] == _jax_pick(algo, impl, jsg, monkeypatch), (algo, impl)
                ok, msg = validate_result(res, g, str(FIXTURES / f"example-directed-{SUFFIX[algo]}"))
                assert ok, f"{algo} {attr}={impl}: {msg}"
                runs += 1
    finally:
        logger.removeHandler(handler)
        dispatch.purge_sharded(g)
    assert runs == 28 and not handler.messages, handler.messages


def test_dist_matches_single_device_on_random_graph(ranks):
    """As tests/test_distributed.py's test_dist_matches_single_chip_on_random_graph:
    the distributed loops against the port's one-device runs."""
    jg = j_uniform_graph(2000, 16000, directed=True, weighted=True, seed=3)
    g = _twin(jg)
    sg = ShardedGraph(g, make_mesh(ranks, "cpu"), wdtype=np.float64)
    cfg = PlatformConfig(device="cpu", precision="float64")

    ranks_d = dist.pr_dist(sg, 0.85, 10, dtype=np.float64)
    single = run_algorithm("pr", g, AlgorithmParams(damping_factor=0.85, num_iterations=10), cfg)
    np.testing.assert_allclose(ranks_d, single.values, rtol=1e-9)

    labels, _ = dist.cdlp_dist(sg, 5)
    single = run_algorithm("cdlp", g, AlgorithmParams(max_iterations=5), cfg)
    np.testing.assert_array_equal(g.mapping[labels], single.values)

    dd, _ = dist.sssp_dist(sg, 0)
    single = run_algorithm("sssp", g, AlgorithmParams(source_vertex=int(g.mapping[0])), cfg)
    np.testing.assert_allclose(dd, single.values, rtol=1e-12)
    sg.release()


def test_purge_sharded_drops_the_blocks_and_stops_the_workers(ranks):
    """delete_graph's purge drops a graph's blocks on every rank; with the
    last sharded graph gone, the workers stop."""
    g = _twin(j_uniform_graph(300, 2000, directed=False, seed=5))
    cfg = PlatformConfig(device="cpu", num_devices=ranks, **NAIVE)
    run_algorithm("wcc", g, AlgorithmParams(), cfg)
    mesh = current_mesh()
    (sg,) = [s for k, s in dispatch._sharded_cache.items() if k[0] == id(g)]
    others = [s.graph for k, s in dispatch._sharded_cache.items() if k[0] != id(g)]
    assert (sg.key, "pull") in mesh.state
    dispatch.purge_sharded(g)
    assert (sg.key, "pull") not in mesh.state and mesh.closed == (not others)
    for other in others:
        dispatch.purge_sharded(other)
    assert not dispatch._sharded_cache and mesh.closed
    assert all(w.proc.poll() == 0 for w in mesh._workers)


def test_prepare_starts_the_mesh_outside_the_processing_window(ranks, monkeypatch, tmp_path):
    """GraphTorchPlatform.prepare's warm-up starts the workers and installs
    the graph's blocks; the timed run (the processing window) starts no
    process and installs nothing, and its levels validate."""
    spec = GraphSpec.from_properties(FIXTURES / "example-directed.properties")
    plat = GraphTorchPlatform(PlatformConfig(device="cpu", num_devices=ranks,
                                             intermediate_dir=str(tmp_path), **NAIVE))
    plat.load_graph(spec)
    plat.prepare(spec, "bfs")
    mesh = current_mesh()
    assert mesh is not None and mesh.size == ranks
    calls = []

    def no_worker(*args, **kwargs):
        raise AssertionError("a worker started inside the processing window")

    def spy(fn, per_rank_args, call=mesh.call):
        calls.append(fn)
        return call(fn, per_rank_args)

    monkeypatch.setattr(mesh_mod, "_Worker", no_worker)
    monkeypatch.setattr(mesh, "call", spy)
    plat.startup(log_dir=str(tmp_path / "log"))
    res = plat.run(spec, "bfs")
    assert current_mesh() is mesh and plat.finalize().processing_time_seconds >= 0
    assert calls == [dist._bfs_body]
    ok, msg = validate_result(res, plat.graphs[spec.name], str(FIXTURES / "example-directed-BFS"))
    assert ok, msg


def test_a_mesh_on_cards_it_lacks_raises_and_keeps_the_live_mesh(ranks):
    mesh = make_mesh(ranks, "cpu")
    with pytest.raises(ValueError, match="from cuda:1 on"):
        make_mesh(1, "cuda:1")
    assert current_mesh() is mesh and not mesh.closed


def test_a_failing_rank_raises_on_rank_0_and_closes_the_mesh():
    mesh = make_mesh(3, "cpu")
    with pytest.raises(RuntimeError, match="TypeError"):
        # rank 0 drops nothing; the other ranks iterate None
        mesh.call(partition._drop, [((),), (None,), (None,)])
    assert mesh.closed and current_mesh() is None
    assert all(w.proc.poll() is not None for w in mesh._workers)


def test_dryrun_multichip():
    from graphtpu_torch.entry import dryrun_multichip

    dryrun_multichip(2)
    assert current_mesh() is None


def test_multihost_environment_joins_two_processes(tmp_path):
    """Two processes with GRAPHTPU_COORDINATOR, GRAPHTPU_NUM_PROCESSES and
    GRAPHTPU_PROCESS_ID form one group (gloo), and run_algorithm's naive BFS
    runs over it; each process's levels validate."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = (
        "import sys\n"
        "from graphtpu_torch.parallel import multihost\n"
        "from graphtpu_torch.algorithms.common import run_algorithm\n"
        "from graphtpu_torch.harness.validator import validate_result\n"
        "from graphtpu_torch.ingest.loader import load_graph_from_spec\n"
        "from graphtpu_torch.utils.config import GraphSpec, PlatformConfig\n"
        f"spec = GraphSpec.from_properties({str(FIXTURES / 'example-directed.properties')!r})\n"
        "assert multihost.initialize('cpu') and multihost.is_multihost()\n"
        "g = load_graph_from_spec(spec, use_cache=False)\n"
        "cfg = PlatformConfig(device='cpu', num_devices=2, bfs_impl='dense')\n"
        "res = run_algorithm('bfs', g, spec.params['bfs'], cfg)\n"
        f"ok, msg = validate_result(res, g, {str(FIXTURES / 'example-directed-BFS')!r})\n"
        "print('primary' if multihost.is_primary() else 'secondary', ok, msg)\n"
    )
    env = dict(os.environ, GRAPHTPU_COORDINATOR=f"127.0.0.1:{port}", GRAPHTPU_NUM_PROCESSES="2",
               GRAPHTPU_NATIVE_LIB=os.devnull,
               PYTHONPATH=os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                                          if p))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=dict(env, GRAPHTPU_PROCESS_ID=str(r))) for r in (0, 1)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0].splitlines()[-1].startswith("primary True")
    assert outs[1][0].splitlines()[-1].startswith("secondary True")
