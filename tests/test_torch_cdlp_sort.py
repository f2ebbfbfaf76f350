"""cdlp-impl=sort on one device, which runs on kernel K12
(``ops/minmode.py:stream_minmode``) over the whole incidence, against the
JAX package's ``graphtpu.algorithms.cdlp._cdlp_sort_kernel``; K12's plain
version at its class boundaries against the JAX ``stream_minmode``; and
WCC's active step, whose segment minimum runs on K7 ``min_i32``.

Inputs come from numpy with a seed; labels and iteration counts must be
bit-identical. The JAX results are computed once per module (fixtures), so
that each JAX compile is shared by the tests that read it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.algorithms.cdlp import _cdlp_sort_kernel as j_sort_kernel
from graphtpu.algorithms.cdlp import build_incidence as j_build_incidence
from graphtpu.core.graph import Graph as JGraph
from graphtpu.ops import minmode as jmm
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import cdlp as tcdlp
from graphtpu_torch.algorithms import wcc as twcc
from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import frontier as tfr
from graphtpu_torch.ops import minmode as tmm
from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

ITERMAX = 10
SKIPS = (0, 2)


def _with_isolated(jg, extra):
    """jg with ``extra`` vertices of no edge appended, and original ids
    that are not the dense ids."""
    n = jg.n + extra
    return JGraph(n, jg.src, jg.dst, None, np.arange(n) * 3 + 7, jg.directed, False,
                  _presorted=True)


GRAPHS = {
    "directed": lambda: j_rmat_graph(8, 4, directed=True, seed=21),
    "undirected": lambda: j_rmat_graph(8, 4, directed=False, seed=22),
    "isolated": lambda: _with_isolated(j_rmat_graph(7, 3, directed=True, seed=23), 30),
}


@pytest.fixture(scope="module")
def sort_cases():
    """name -> (the port's Graph, {skip: (JAX labels as original ids, JAX
    iterations)}): one JAX compile per graph and skip."""
    cases = {}
    for name, make in GRAPHS.items():
        jg = make()
        centers, neigh = j_build_incidence(jg)
        deg = np.bincount(centers, minlength=jg.n).astype(np.int32)
        want = {}
        for skip in SKIPS:
            labels, it = j_sort_kernel(jnp.asarray(centers), jnp.asarray(neigh),
                                       jnp.asarray(deg), jg.n, ITERMAX, skip)
            want[skip] = (jg.mapping[np.asarray(labels)], int(it))
        tg = Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, jg.directed, False)
        cases[name] = (tg, want)
    return cases


@pytest.mark.parametrize("skip", SKIPS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_sort_route_matches_jax_sort_kernel(sort_cases, name, skip):
    tg, want = sort_cases[name]
    got = run_algorithm("cdlp", tg, AlgorithmParams(max_iterations=ITERMAX),
                        PlatformConfig(device="cpu", cdlp_impl="sort",
                                       skip_convergence_checks=skip))
    np.testing.assert_array_equal(got.values, want[skip][0])
    assert got.iterations == want[skip][1]
    if name == "isolated":  # a vertex of no edge keeps its own label
        np.testing.assert_array_equal(got.values[-30:], tg.mapping[-30:])


def test_sort_route_takes_stream_minmode_once_an_iteration(sort_cases, monkeypatch):
    """The route calls K12's wrapper once an iteration, over the whole
    incidence CSR (memoized on the Graph), and never the torch-op oracle."""
    tg, want = sort_cases["directed"]
    calls = []
    real = tmm.stream_minmode

    def spy(labels, centers, neigh, indptr, identity=False):
        calls.append((centers.shape[0], indptr.shape[0]))
        return real(labels, centers, neigh, indptr, identity)

    def oracle(*args, **kwargs):
        raise AssertionError("the sort route ran the torch-op oracle")

    monkeypatch.setattr(tmm, "stream_minmode", spy)
    monkeypatch.setattr(tcdlp, "_cdlp_sort_kernel", oracle)
    got = run_algorithm("cdlp", tg, AlgorithmParams(max_iterations=ITERMAX),
                        PlatformConfig(device="cpu", cdlp_impl="sort"))
    m = tcdlp.build_incidence(tg)[0].shape[0]
    assert calls == [(m, tg.n + 1)] * got.iterations
    assert got.iterations == want[0][1]
    assert ("cdlp_incidence_csr", "cpu") in tg.memo


def test_sort_route_equals_the_torch_op_oracle(sort_cases):
    """The oracle the route replaced, kept for the card's check, agrees."""
    tg, want = sort_cases["undirected"]
    centers, neigh = tcdlp.build_incidence(tg)
    deg = np.bincount(centers, minlength=tg.n).astype(np.int32)
    labels, it = tcdlp._cdlp_sort_kernel(
        *(torch.from_numpy(a) for a in (centers, neigh, deg)), tg.n, ITERMAX, 2)
    np.testing.assert_array_equal(tg.mapping[labels.numpy()], want[2][0])
    assert it == want[2][1]


# segment lengths at each side of K12's class boundaries
BOUNDARY_LENGTHS = [0, 1, tmm.K12_WARP_LEN, tmm.K12_WARP_LEN + 1, tmm.K12_MED_LEN,
                    tmm.K12_MED_LEN + 1, 512, 513, tmm.K12_SMEM_LEN, tmm.K12_SMEM_LEN + 1,
                    2 * tmm.K12_SMEM_LEN + 7]


@pytest.mark.parametrize("identity", [False, True], ids=["gather", "identity"])
def test_stream_minmode_plain_at_the_class_boundaries(identity):
    rng = np.random.default_rng(16)
    n = 3000
    seg_len = rng.permutation(np.repeat(BOUNDARY_LENGTHS, 2))
    indptr = np.concatenate([[0], np.cumsum(seg_len)]).astype(np.int32)
    centers = np.repeat(np.arange(seg_len.shape[0]), seg_len).astype(np.int32)
    neigh = rng.integers(0, n, size=centers.shape[0]).astype(np.int32)
    if identity:
        neigh %= 200  # few ids: ties and repeats
    labels = rng.integers(0, 40, size=n).astype(np.int32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = tmm.stream_minmode(None if identity else t(labels), t(centers), t(neigh), t(indptr),
                             identity=identity).numpy()
    want = np.asarray(jmm.stream_minmode(None if identity else jnp.asarray(labels),
                                         jnp.asarray(centers), jnp.asarray(neigh),
                                         jnp.asarray(indptr), n, identity=identity))
    nonempty = seg_len > 0
    np.testing.assert_array_equal(got[nonempty], want[nonempty])
    assert (got[~nonempty] == INT32_INF).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_valid_slots_are_the_prefix_before_the_pad_segment(seed):
    """K7 has no mask: WCC's active step routes its segment minimum there
    because every invalid K5 slot lies at or past seg_starts[k] (the pad
    segment, which it drops) whenever the rows' edges fit e_cap."""
    rng = np.random.default_rng(seed)
    n, k, e_cap = 300, 24, 400
    deg = rng.integers(0, 30, size=n)
    indptr_pad = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    neigh = rng.integers(0, n, size=int(deg.sum())).astype(np.int32)
    ids = np.sort(rng.permutation(n)[:k])
    ids = ids[np.cumsum(deg[ids]) <= e_cap]
    ids = np.concatenate([ids, np.full(k - ids.shape[0], n)]).astype(np.int32)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731
    exp = tfr.expand(i32(ids), i32(np.concatenate([deg, [0]])), i32(indptr_pad), i32(neigh),
                     e_cap, with_row_ids=False)
    real = int(exp.seg_starts[-1])
    assert real <= e_cap
    np.testing.assert_array_equal(exp.valid.numpy(), np.arange(e_cap) < real)


def test_wcc_active_step_takes_k7(monkeypatch):
    """WCC's active steps reduce on csr_pull_reduce ("min_i32", one call a
    step beside the full steps'), and the labels stay those of the JAX
    package (tests/test_torch_wcc.py holds them under every cap)."""
    jg = j_rmat_graph(9, 4, directed=False, seed=11)
    tg = Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, jg.directed, False)
    modes = []
    real = twcc.csr_pull_reduce

    def spy(mode, *args, **kwargs):
        modes.append(mode)
        return real(mode, *args, **kwargs)

    monkeypatch.setattr(twcc, "csr_pull_reduce", spy)
    cfg = PlatformConfig(device="cpu", wcc_impl="adaptive")
    _, it, stats = twcc.wcc_adaptive_run(tg, cfg, with_stats=True)
    assert stats["active_steps"] >= 1
    assert modes == ["min_i32"] * it
