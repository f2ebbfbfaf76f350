"""graphtpu_torch's adaptive CDLP against the JAX package, on the CPU.

Both packages get the same graph (the JAX package's RMAT generator, handed
over as numpy arrays). Labels, iteration counts and, for the device run,
the counts of full and active steps must be equal.
"""

import numpy as np
import pytest

from graphtpu.algorithms.cdlp import build_incidence as j_build_incidence
from graphtpu.algorithms.common import run_algorithm as j_run_algorithm
from graphtpu.core.graph import Graph as JGraph
from graphtpu.ops import active as ja
from graphtpu.utils.config import AlgorithmParams as JParams
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms.cdlp import build_incidence
from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.ops import active as ta
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, jg.directed, False)


def _inputs(jg, tg):
    jc, jn = j_build_incidence(jg)
    tc, tn = build_incidence(tg)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tn, jn)
    deg = np.bincount(tc, minlength=tg.n).astype(np.int32)
    return (jc, jn, deg), (tc, tn, deg)


def _oscillator():
    """0-1 an isolated edge (swaps labels forever), 2 an isolated vertex,
    3-4-5 a triangle (tests/test_adaptive.py:106-115)."""
    src = np.array([0, 1, 3, 4, 5, 4, 5, 3], dtype=np.int64)
    dst = np.array([1, 0, 4, 5, 3, 3, 4, 5], dtype=np.int64)
    return JGraph(6, src, dst, None, np.arange(6, dtype=np.uint64), directed=False,
                  weighted=False)


def _device_runs(jg, itermax, **caps):
    tg = _twin(jg)
    jin, tin = _inputs(jg, tg)
    jl, jit, js = ja.cdlp_adaptive_device_run(jg, *jin, itermax, JConfig(**caps),
                                              with_stats=True)
    tl, tit, ts = ta.cdlp_adaptive_device_run(tg, *tin, itermax,
                                              PlatformConfig(device="cpu", **caps),
                                              with_stats=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tit, ts) == (jit, js)
    return ts


@pytest.mark.parametrize("itermax", [1, 3, 10])
@pytest.mark.parametrize("caps", [(1 << 10, 1 << 14), (8, 32)])
@pytest.mark.parametrize("directed", [True, False])
def test_device_run_matches_jax(directed, caps, itermax):
    jg = j_rmat_graph(9, 8, directed=directed, seed=3)
    stats = _device_runs(jg, itermax, cdlp_frontier_rows=caps[0],
                         cdlp_frontier_edges=caps[1])
    assert stats["full_steps"] >= 1


@pytest.mark.parametrize("directed", [True, False])
def test_device_run_tier_ladder_matches_jax(directed):
    """Three tiers: every one survives the m/4 cut on this graph."""
    jg = j_rmat_graph(10, 16, directed=directed, seed=5)
    stats = _device_runs(jg, 10, cdlp_tiers="256,1024,4096")
    assert stats["active_steps"] >= 1


def test_device_run_oscillators_match_jax():
    jg = _oscillator()
    for itermax in (1, 2, 5, 9):
        _device_runs(jg, itermax, cdlp_frontier_rows=1 << 8, cdlp_frontier_edges=1 << 10)


@pytest.mark.parametrize("threshold", [1.0, 0.3, 1e-9])
@pytest.mark.parametrize("directed", [True, False])
def test_host_run_matches_jax(directed, threshold):
    jg = j_rmat_graph(9, 8, directed=directed, seed=3)
    tg = _twin(jg)
    jin, tin = _inputs(jg, tg)
    for itermax in (1, 3, 10):
        jl, jit = ja.cdlp_adaptive_run(jg, *jin, itermax,
                                       JConfig(cdlp_active_threshold=threshold))
        tl, tit = ta.cdlp_adaptive_run(tg, *tin, itermax,
                                       PlatformConfig(device="cpu",
                                                      cdlp_active_threshold=threshold))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert tit == jit


@pytest.mark.parametrize("directed", [True, False])
def test_run_algorithm_auto_matches_jax(directed):
    jg = j_rmat_graph(10, 12, directed=directed, seed=7)
    want = j_run_algorithm("cdlp", jg, JParams(max_iterations=10), JConfig())
    got = run_algorithm("cdlp", _twin(jg), AlgorithmParams(max_iterations=10),
                        PlatformConfig(device="cpu"))
    np.testing.assert_array_equal(got.values, want.values)
    assert got.iterations == want.iterations


@pytest.mark.parametrize("spec", ["", "1024", "256,1024,4096", "4096,16,64,1099511627776"])
def test_cdlp_tiers_match_jax(spec):
    for m_inc in (100, 20000, 1 << 24):
        assert ta.cdlp_tiers(1 << 16, 1 << 18, m_inc, PlatformConfig(cdlp_tiers=spec)) == \
            ja.cdlp_tiers(1 << 16, 1 << 18, m_inc, JConfig(cdlp_tiers=spec))


def test_prepare_is_memoized_per_device_and_buckets():
    """A warm run finds its plan and CSR arrays on the Graph."""
    tg = _twin(j_rmat_graph(8, 4, directed=False, seed=1))
    centers, neigh = build_incidence(tg)
    deg = np.bincount(centers, minlength=tg.n).astype(np.int32)
    cfg = PlatformConfig(device="cpu")
    prep = ta.prepare_cdlp_adaptive(tg, centers, neigh, deg, cfg)
    assert ta.prepare_cdlp_adaptive(tg, centers, neigh, deg, cfg) is prep
    other = ta.prepare_cdlp_adaptive(tg, centers, neigh, deg,
                                     PlatformConfig(device="cpu", slab_buckets=(2, 4)))
    assert other is not prep
    assert prep.deg_pad.tolist() == deg.tolist() + [0]
    assert prep.indptr_pad[-1].item() == centers.shape[0]
