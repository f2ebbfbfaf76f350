"""The JAX package's default distributed BFS, SSSP and WCC in the port
(graphtpu_torch/parallel/adaptive_bfs.py, adaptive_sssp.py,
adaptive_wcc.py) over gloo groups of 2 and 4 CPU ranks, held against the
JAX package's (graphtpu/parallel/) on a mesh of as many CPU devices.

Both packages get the same RMAT graphs (scale 9, edge factor 8, directed
and undirected, weighted for SSSP), handed over as arrays, under the
capacity matrices of tests/test_distributed.py, which force every phase:
push only, bottom-up, the dense fall-back, and phases that hand over mid
traversal. The per-rank CSR slices (``_local_csr``) and probe tables equal
the JAX package's array for array, on the host and as the ranks hold them.
BFS levels, WCC labels, SSSP distances (min of the same float64 sums: a
tolerance of 0), every iteration count and the JAX package's step
statistics are bit for bit. The rank groups run with a collective timeout
of 120 s, so that a rank that waits alone fails the test instead of the
suite's clock.
"""

import numpy as np
import pytest
import torch

from graphtpu.parallel import ShardedGraph as JShardedGraph
from graphtpu.parallel import make_mesh as j_make_mesh
from graphtpu.parallel.adaptive_bfs import _build_prep as j_bfs_prep
from graphtpu.parallel.adaptive_bfs import bfs_adaptive_dist as j_bfs_adaptive_dist
from graphtpu.parallel.adaptive_sssp import _build_prep as j_sssp_prep
from graphtpu.parallel.adaptive_sssp import sssp_adaptive_dist as j_sssp_adaptive_dist
from graphtpu.parallel.adaptive_wcc import _build_prep as j_wcc_prep
from graphtpu.parallel.adaptive_wcc import wcc_adaptive_dist as j_wcc_adaptive_dist
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms.bfs import bfs_adaptive_run
from graphtpu_torch.algorithms.sssp import sssp_adaptive_run
from graphtpu_torch.algorithms.wcc import wcc_adaptive_run
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.parallel import mesh as mesh_mod
from graphtpu_torch.parallel.adaptive_bfs import _build_prep as bfs_prep
from graphtpu_torch.parallel.adaptive_bfs import bfs_adaptive_dist
from graphtpu_torch.parallel.adaptive_sssp import _build_prep as sssp_prep
from graphtpu_torch.parallel.adaptive_sssp import sssp_adaptive_dist
from graphtpu_torch.parallel.adaptive_wcc import _build_prep as wcc_prep
from graphtpu_torch.parallel.adaptive_wcc import wcc_adaptive_dist
from graphtpu_torch.parallel.mesh import close_mesh, make_mesh
from graphtpu_torch.parallel.partition import ShardedGraph
from graphtpu_torch.utils.config import PlatformConfig

from torch_dist_gather import gather_at, tests_on_worker_path  # noqa: F401

GROUP_TIMEOUT_S = 120.0
BFS_CAPS = [
    {},  # defaults: push handles everything at this scale
    # tiny push caps: every level runs the truncated bottom-up
    dict(bfs_frontier_rows=2, bfs_frontier_edges=4, bfs_bu_rows=512, bfs_bu_edges=4096),
    # bottom-up aborts too: the dense fall-back takes every heavy level
    dict(bfs_frontier_rows=2, bfs_frontier_edges=4, bfs_bu_rows=1, bfs_bu_edges=1),
    # mixed: phases hand over mid traversal
    dict(bfs_frontier_rows=64, bfs_frontier_edges=256, bfs_bu_rows=32, bfs_bu_edges=512),
]
WCC_CAPS = [
    {},  # wcc-impl auto: the slab-adaptive kernel
    dict(wcc_frontier_rows=16, wcc_frontier_edges=64),  # heavy rounds take full slab steps
    dict(wcc_impl="adaptive"),  # the edge-stream full steps
    dict(wcc_impl="adaptive", wcc_frontier_rows=16, wcc_frontier_edges=64),
]
SSSP_CAPS = [
    {},  # the default two-tier ladder
    dict(sssp_frontier_rows=8, sssp_frontier_edges=32),  # heavy rounds take full sweeps
    dict(sssp_tiers="64,512,4096"),  # an explicit three-tier ladder
]


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


@pytest.fixture(scope="module")
def rmats():
    """(JAX graph, the port's twin) by (directed, weighted)."""
    out = {}
    for directed in (False, True):
        for weighted in (False, True):
            jg = j_rmat_graph(9, 8, directed=directed, seed=7, weighted=weighted)
            out[directed, weighted] = (jg, _twin(jg))
    return out


def _pairs(ranks, rmats, weighted=False):
    wdtype = np.float64 if weighted else np.float32
    for directed in (False, True):
        jg, g = rmats[directed, weighted]
        yield (ShardedGraph(g, make_mesh(ranks, "cpu"), wdtype=wdtype),
               JShardedGraph(jg, j_make_mesh(ranks), wdtype=wdtype))


def _equal_tree(port, jax):
    if isinstance(port, tuple):
        assert len(port) == len(jax)
        for a, b in zip(port, jax):
            _equal_tree(a, b)
    else:
        b = np.asarray(jax)
        assert port.dtype == b.dtype and port.shape == b.shape
        np.testing.assert_array_equal(port, b)


def test_local_csr_preps_equal_jax(ranks, rmats):
    """BFS's push and pull slices, probe table and degrees, SSSP's weighted
    push slices and WCC's symmetrized ones: host arrays, then what each rank
    holds, gathered back."""
    for weighted in (False, True):
        for sg, jsg in _pairs(ranks, rmats, weighted):
            bp, jbp = bfs_prep(sg), j_bfs_prep(jsg)
            _equal_tree(tuple(bp), (jbp["push"], jbp["pull"], jbp["trunc"], jbp["gdeg_pad"]))
            sp, jsp = sssp_prep(sg), j_sssp_prep(jsg)
            _equal_tree(sp, (jsp["push"], jsp["gdeg_pad"]))
            wp, jwp = wcc_prep(sg), j_wcc_prep(jsg)
            _equal_tree(wp, (jwp["push"], jwp["sdeg_pad"]))
            bfs_adaptive_dist(sg, 0)
            key = (sg.key, "bfs-adaptive-2")
            _equal_tree((gather_at(sg, key, 0, 0), gather_at(sg, key, 0, 1),
                         gather_at(sg, key, 0, 2)[0]), (bp.push, bp.pull, bp.trunc))
            (gdeg,) = gather_at(sg, key, 1)
            assert all(np.array_equal(row, bp.gdeg_pad) for row in gdeg)
            wcc_adaptive_dist(sg)
            _equal_tree(gather_at(sg, (sg.key, "wcc-adaptive"), 0, 0), wp[0])
            if weighted:
                sssp_adaptive_dist(sg, 0)
                _equal_tree(gather_at(sg, (sg.key, "sssp-adaptive-float64"), 0, 0), sp[0])
            sg.release()


@pytest.mark.parametrize("caps", BFS_CAPS, ids=["default", "bottom-up", "dense", "mixed"])
def test_bfs_adaptive_dist_matches_jax(ranks, rmats, caps):
    """Levels and levels run bit for bit under every phase regime; the
    steps the port counts are the levels run plus the aborted bottom-up
    steps, each of which hands its level to one dense step."""
    for sg, jsg in _pairs(ranks, rmats):
        levels, it, stats = bfs_adaptive_dist(sg, 0, PlatformConfig(**caps), with_stats=True)
        jlevels, jit = j_bfs_adaptive_dist(jsg, 0, JConfig(**caps))
        np.testing.assert_array_equal(levels, np.asarray(jlevels))
        assert it == jit
        steps = sum(stats["tier_steps"].values()) + stats["bu_steps"] + stats["dense_steps"]
        assert steps == it + stats["dense_steps"]
        sg.release()


@pytest.mark.parametrize("caps", SSSP_CAPS, ids=["default", "full", "three-tiers"])
def test_sssp_adaptive_dist_matches_jax(ranks, rmats, caps):
    """Distances (tolerance 0), rounds and the JAX package's statistics
    (full, active and per-tier rounds) bit for bit, in float64."""
    for sg, jsg in _pairs(ranks, rmats, weighted=True):
        d, it, stats = sssp_adaptive_dist(sg, 0, PlatformConfig(**caps), with_stats=True)
        jd, jit, jstats = j_sssp_adaptive_dist(jsg, 0, JConfig(**caps), with_stats=True)
        np.testing.assert_array_equal(d, jd)
        assert it == jit and stats == jstats
        sg.release()


@pytest.mark.parametrize("caps", WCC_CAPS, ids=["auto", "auto-small", "adaptive",
                                               "adaptive-small"])
def test_wcc_adaptive_dist_matches_jax(ranks, rmats, caps):
    """Labels, rounds and the JAX package's statistics bit for bit, under
    both kernels (slab and edge-stream full steps)."""
    for sg, jsg in _pairs(ranks, rmats):
        labels, it, stats = wcc_adaptive_dist(sg, PlatformConfig(**caps), with_stats=True)
        jlabels, jit, jstats = j_wcc_adaptive_dist(jsg, JConfig(**caps), with_stats=True)
        np.testing.assert_array_equal(labels, np.asarray(jlabels))
        assert it == jit and stats == jstats
        sg.release()


def test_adaptive_dist_equals_one_device(ranks, rmats):
    """The distributed loops' results equal the port's one-device adaptive
    runs (levels, labels and distances; the step schedules differ: the
    budgets are per rank). The one-device runs take small frontier budgets,
    which change their schedules and not their results."""
    for weighted in (False, True):
        for sg, _ in _pairs(ranks, rmats, weighted):
            g = sg.graph
            cfg = PlatformConfig(device="cpu", precision="float64", bfs_frontier_edges=1 << 12,
                                 wcc_frontier_edges=1 << 12, sssp_frontier_edges=1 << 12)
            if weighted:
                d, _ = sssp_adaptive_dist(sg, 0)
                np.testing.assert_array_equal(
                    d, sssp_adaptive_run(g, 0, cfg, dtype=torch.float64)[0].numpy())
            else:
                np.testing.assert_array_equal(bfs_adaptive_dist(sg, 0)[0],
                                              bfs_adaptive_run(g, 0, cfg)[0].numpy())
                np.testing.assert_array_equal(wcc_adaptive_dist(sg)[0],
                                              wcc_adaptive_run(g, cfg)[0].numpy())
            sg.release()
