"""graphtpu_torch's six algorithms against the pure-numpy oracles of
tests/test_fuzz_oracles.py, on the CPU.

The same randomized graphs (duplicate edges, self-loops, isolated vertices,
sparse original ids; directed and undirected; weighted) and the same seeds
as the JAX package's fuzz, handed to the port as numpy arrays, through the
port's ``run_algorithm`` under every BFS and SSSP impl, hybrid included.
Tolerances are the JAX fuzz's: exact for BFS and CDLP, the partition for
WCC, 1e-12 relative for SSSP and LCC (float64) and 1e-10 for PageRank.
"""

import numpy as np
import pytest

from test_fuzz_oracles import (
    _bfs_oracle, _cdlp_oracle, _lcc_oracle, _pr_oracle, _random_graph, _sssp_oracle,
    _wcc_oracle,
)

from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401


def _graphs(seed, directed, weighted, **size):
    """(the JAX fuzz's graph, which the oracles read; its port twin)."""
    jg = _random_graph(seed, directed, weighted, **size)
    tg = Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w if weighted else None, jg.mapping,
                           directed, weighted)
    return jg, tg


def _cfg(**over):
    return PlatformConfig(device="cpu", precision="float64", **over)


@pytest.mark.parametrize("impl", ["auto", "device", "hybrid"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("directed", [True, False])
def test_fuzz_bfs(seed, directed, impl):
    jg, tg = _graphs(seed, directed, False)
    res = run_algorithm("bfs", tg, AlgorithmParams(source_vertex=int(tg.mapping[0])),
                        _cfg(bfs_impl=impl))
    np.testing.assert_array_equal(res.values, _bfs_oracle(jg, 0))


@pytest.mark.parametrize("impl", ["auto", "device", "delta", "hybrid"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("directed", [True, False])
def test_fuzz_sssp(seed, directed, impl):
    jg, tg = _graphs(seed, directed, True)
    res = run_algorithm("sssp", tg, AlgorithmParams(source_vertex=int(tg.mapping[0])),
                        _cfg(sssp_impl=impl))
    np.testing.assert_allclose(res.values, _sssp_oracle(jg, 0), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("directed", [True, False])
def test_fuzz_wcc(seed, directed):
    jg, tg = _graphs(seed, directed, False)
    res = run_algorithm("wcc", tg, AlgorithmParams(), _cfg())
    # the same partition (labels are arbitrary)
    _, mi = np.unique(res.values, return_inverse=True)
    _, gi = np.unique(_wcc_oracle(jg), return_inverse=True)
    n_m, n_g = mi.max() + 1, gi.max() + 1
    assert n_m == n_g
    assert np.unique(mi * n_g + gi).size == n_m


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("directed", [True, False])
def test_fuzz_pr(seed, directed):
    jg, tg = _graphs(seed, directed, False)
    res = run_algorithm("pr", tg, AlgorithmParams(damping_factor=0.85, num_iterations=12),
                        _cfg())
    np.testing.assert_allclose(res.values, _pr_oracle(jg, 0.85, 12), rtol=1e-10)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("directed", [True, False])
def test_fuzz_lcc(seed, directed):
    jg, tg = _graphs(seed, directed, False)
    res = run_algorithm("lcc", tg, AlgorithmParams(), _cfg())
    np.testing.assert_allclose(res.values, _lcc_oracle(jg), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("directed", [True, False])
def test_fuzz_cdlp(seed, directed):
    jg, tg = _graphs(seed, directed, False, n=40, m=160)
    res = run_algorithm("cdlp", tg, AlgorithmParams(max_iterations=5), _cfg())
    np.testing.assert_array_equal(res.values, tg.mapping[_cdlp_oracle(jg, 5)])
