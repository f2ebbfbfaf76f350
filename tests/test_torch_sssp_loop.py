"""graphtpu_torch's device loop of SSSP auto against the JAX package, on the
CPU (where K5, K7, K8's in-place mode, K14, K18 and K22 run their plain
PyTorch versions, and the loop is the host loop that reads its conditions
from the control words).

Inputs come from numpy with a seed and go to both packages. Distances must
be bit-identical in float32 and float64 (tolerance 0: every candidate is the
same addition and min is exact in any order), and every count equal. The
JAX references are the formulas of
graphtpu/algorithms/sssp.py:_sssp_adaptive_kernel (chosen, derive, the tier
step, the phase conditions), written out here where they are nested
functions of the jitted kernel, and ``sssp_adaptive_run`` itself.

    JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_sssp_loop.py
"""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.algorithms import sssp as jsssp
from graphtpu.ops import frontier as jf
from graphtpu.ops.gather import table_gather as j_table_gather
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import grid_graph as j_grid_graph
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import sssp as tsssp
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.ops import frontier as tf
from graphtpu_torch.utils.config import PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}
TIERS = ((4, 16), (16, 64), (64, 256))


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_chosen(acnt, ae, tiers):
    """sssp.py:113-118."""
    c = jnp.int32(len(tiers))
    for i in range(len(tiers) - 1, -1, -1):
        k_i, e_i = tiers[i]
        c = jnp.where((acnt <= k_i) & (ae <= e_i), jnp.int32(i), c)
    return c


def _ctl(it, counts):
    t = len(TIERS)
    ctl = torch.zeros(tsssp.ctl_words(t), dtype=torch.int32)
    ctl[tsssp.SCTL_IT], ctl[tsssp.SCTL_ITERMAX] = it, 50
    ctl[tsssp.SCTL_COND + t + 2:] = torch.tensor(counts, dtype=torch.int32)
    return ctl


@pytest.mark.parametrize("count", [0, 1, 4, 5, 16, 17, 64, 65, 200])
@pytest.mark.parametrize("stage", ["init", "full", "tier1"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_matches_jax_round(dtype, stage, count):
    """K22's plain version against the JAX kernel: iteration 0's derive of
    fmask0 (:181-182), a full round's minimum(dist, relaxed) and new < dist
    (:67-68), a tier round's mask as it is; then mask_status (:125-128),
    chosen over the ladder, the phase loops' conditions (:166-179) and the
    counters it and counts[T+1]."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(count + 7 * len(stage))
    n, t = 300, len(TIERS)
    deg = rng.integers(0, 5, size=n).astype(np.int32)
    dist = rng.random(n).astype(jdt) * 10
    dist[rng.random(n) < 0.2] = np.inf
    changed = np.zeros(n, bool)
    changed[rng.choice(n, size=count, replace=False)] = True
    relaxed = np.where(changed, dist - rng.random(n).astype(jdt) - 0.5, dist + 1).astype(jdt)
    relaxed[changed & np.isinf(dist)] = 3.0
    src, it, counts = 17, (0 if stage == "init" else 7), [2, 0, 1, 3]
    if stage == "init":
        want_dist = jnp.full((n,), jnp.inf, jdt).at[src].set(0.0)
        want_mask = jnp.zeros((n,), bool).at[src].set(True)
    elif stage == "full":
        want_dist = jnp.minimum(jnp.asarray(dist), jnp.asarray(relaxed))
        want_mask = want_dist < jnp.asarray(dist)
    else:
        want_dist, want_mask = jnp.asarray(dist), jnp.asarray(changed)
    cnt, fe = jf.mask_status(want_mask, jnp.asarray(deg), int(deg.sum()))
    chosen = int(_jax_chosen(cnt, fe, TIERS))
    step = {"init": tsssp.STAGE_INIT, "full": tsssp.STAGE_FULL, "tier1": tsssp.STAGE_TIER + 1}
    want_it = 0 if stage == "init" else it + 1
    want_counts = [0] * (t + 1) if stage == "init" else list(counts)
    if stage != "init":
        want_counts[t if stage == "full" else 1] += 1
    live = int(cnt) > 0 and want_it < 50
    td, tm = _t(dist), _t(changed)
    ctl = _ctl(it, counts)
    tsssp.sssp_apply(td, _t(relaxed) if stage == "full" else None, tm,
                     _t(np.concatenate([deg, [0]]).astype(np.int32)),
                     torch.tensor([src], dtype=torch.int32), ctl,
                     torch.tensor(TIERS, dtype=torch.int32), step[stage], 50)
    np.testing.assert_array_equal(td.numpy(), np.asarray(want_dist))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(want_mask))
    c = tsssp.SCTL_COND
    assert ctl[:c].tolist() == [int(cnt), int(fe), want_it, 50]
    assert ctl[c:c + t + 2].tolist() == [live] + [live and chosen == i for i in range(t + 1)]
    assert ctl[c + t + 2:].tolist() == want_counts


def _csr(rng, n, max_deg, jdt):
    deg = rng.integers(0, max_deg + 1, size=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    dst = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    w = (rng.random(int(indptr[-1])) * 4).astype(jdt)
    return np.concatenate([deg, [0]]).astype(np.int32), indptr.astype(np.int32), dst, w


@pytest.mark.parametrize("count", [0, 1, 40, 150])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_relax_in_place_matches_jax_tier_step(dtype, count):
    """K8's in-place mode against the tier step of sssp.py:135-147: the
    expansion's candidates du + w from the distances before the round (a
    frontier vertex may be a target of the same round), the scatter-min
    into dist and derive's new < dist."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(count + len(dtype))
    n, k, e_cap = 200, 160, 2048
    deg_pad, indptr, dst, w = _csr(rng, n, 9, jdt)
    ids = np.full(k, n, dtype=np.int32)
    ids[:count] = np.sort(rng.choice(n, size=count, replace=False))
    dst[:: 3] = ids[rng.integers(0, max(count, 1), size=dst[::3].shape[0])] % n  # frontier targets
    dist = (rng.random(n) * 8).astype(jdt)
    dist[rng.random(n) < 0.3] = np.inf
    jexp = jf.expand(jnp.asarray(ids), jnp.asarray(deg_pad), jnp.asarray(indptr),
                     jnp.asarray(dst), e_cap)
    jd = jnp.asarray(dist)
    du = j_table_gather(jd, jnp.where(jexp.valid, jexp.row_ids, 0))
    cand = du + j_table_gather(jnp.asarray(w), jexp.gpos)
    targets = jnp.where(jexp.valid, jexp.neigh, jnp.int32(n))
    new = jd.at[targets].min(jnp.where(jexp.valid, cand, jnp.inf), mode="drop")
    texp = tf.expand(_t(ids), _t(deg_pad), _t(indptr), _t(dst), e_cap, with_row_ids=False)
    td, tm = _t(dist), torch.ones(n, dtype=torch.bool)
    tf.relax_min_into(td, _t(ids), texp, _t(w), tm)
    np.testing.assert_array_equal(td.numpy(), np.asarray(new))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(new < jd))


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w, jg.mapping, jg.directed, True)


GRAPHS = {
    "rmat10-directed": lambda: j_rmat_graph(10, 8, directed=True, weighted=True, seed=4),
    "rmat10-undirected": lambda: j_rmat_graph(10, 8, directed=False, weighted=True, seed=4),
    "grid20": lambda: j_grid_graph(20, seed=2),
}
# (graph, sssp-tiers, dtypes, sources): 2-3 tiers, small enough that the
# big rounds run full
CASES = [
    ("rmat10-directed", "16,64,256", ("float32", "float64"), (0, 3)),
    ("rmat10-undirected", "32,256", ("float32",), (0, 9)),
    ("grid20", "16,64", ("float32", "float64"), (0, 210)),
]


@pytest.fixture(scope="module")
def graphs():
    return {name: (jg, _twin(jg)) for name, make in GRAPHS.items() for jg in (make(),)}


@pytest.mark.parametrize("case", range(len(CASES)))
def test_loop_matches_sssp_adaptive_run(graphs, case):
    """The ctl-driven loop's distances (bit for bit, unreachable vertices
    +inf), rounds, tier rounds by tier and full rounds against the JAX
    package's sssp_adaptive_run."""
    name, tiers, dtypes, sources = CASES[case]
    jg, tg = graphs[name]
    phases = np.zeros(len(tiers.split(",")) + 1, int)
    for dtype in dtypes:
        jdt, tdt = DTYPES[dtype]
        for src in sources:
            jd, jn, js = jsssp.sssp_adaptive_run(jg, src, JConfig(sssp_tiers=tiers), jdt,
                                                 with_stats=True)
            td, tn, ts = tsssp.sssp_adaptive_run(
                tg, src, PlatformConfig(device="cpu", sssp_tiers=tiers), tdt, with_stats=True)
            assert td.dtype == tdt
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            assert (tn, ts) == (jn, js), (name, dtype, src)
            assert tsssp.last_run["driver"] == "host loop"
            phases += list(ts["tier_steps"].values()) + [ts["full_steps"]]
            if name == "rmat10-directed":
                assert np.isinf(td.numpy()).any()  # unreachable vertices stay +inf
    assert phases.sum() > 0 and phases[-1] > 0 and phases[:-1].sum() > 0, phases


def test_edgeless_graph():
    """A graph of vertices and no edge (the JAX package raises on it, fault
    F5): the source at 0, the rest +inf, one tier round."""
    tg = Graph.from_arrays(4, np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.float64), np.arange(4, dtype=np.uint64), True, True)
    dist, it, stats = tsssp.sssp_adaptive_run(tg, 2, PlatformConfig(device="cpu"),
                                              with_stats=True)
    np.testing.assert_array_equal(dist.numpy(), [np.inf, np.inf, 0.0, np.inf])
    assert (it, stats["full_steps"], sum(stats["tier_steps"].values())) == (1, 0, 1)


# the functions the loop runs at each step, and the wrappers they call
STEP_FUNCTIONS = ("_step_init", "_step_full", "_step_tier", "_apply", "sssp_apply", "relax_min_into",
                  "compact")


@pytest.mark.parametrize("name", STEP_FUNCTIONS)
def test_step_functions_read_nothing_back(name):
    """No step function, nor a wrapper it calls, reads a tensor to the host:
    no .tolist(), .item(), .cpu(), .numpy() and no bool(), int() or float()."""
    tree = ast.parse(inspect.getsource(getattr(tsssp, name)))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in ("tolist", "item", "cpu", "numpy"):
                bad.append(f.attr)
            if isinstance(f, ast.Name) and f.id in ("bool", "int", "float"):
                bad.append(f.id)
    assert not bad, (name, bad)
