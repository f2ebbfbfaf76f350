"""graphtpu_torch's device loop of WCC auto and adaptive against the JAX
package, on the CPU (where K7, K14, K18, K19, K20 and K21 run their plain
PyTorch versions, and the loop is the host loop that reads its conditions
from the control words).

Inputs come from numpy with a seed and go to both packages; every integer
must be equal bit for bit. The JAX references are
graphtpu/algorithms/wcc.py:_wcc_adaptive_loop and the kernels' ``finish``
(:202-207), written out here where they are nested functions of the jitted
kernels, and ``wcc_adaptive_run`` itself.

    JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_wcc_loop.py
"""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.algorithms import wcc as jwcc
from graphtpu.ops import frontier as jf
from graphtpu.ops.gather import table_gather as j_table_gather
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import wcc as twcc
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import active as ta
from graphtpu_torch.utils.config import PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_finish(labels, neigh_min):
    """graphtpu/algorithms/wcc.py:202-207."""
    new = jnp.minimum(labels, neigh_min)
    new = jnp.minimum(new, j_table_gather(new, new))
    new = jnp.minimum(new, j_table_gather(new, new))
    return new, new != labels


def _labels(rng, n, share):
    """Labels that point at smaller ids (a forest of chains, as a run's are)
    and a neighbours' minimum below them on a ``share`` of the vertices."""
    labels = np.minimum(np.arange(n), rng.integers(0, n, size=n)).astype(np.int32)
    labels = labels[labels]
    lower = rng.integers(0, n, size=n)
    neigh_min = np.where(rng.random(n) < share, np.minimum(lower, labels), INT32_INF)
    return labels, neigh_min.astype(np.int32)


@pytest.mark.parametrize("share", [0.0, 0.01, 0.3, 1.0])
@pytest.mark.parametrize("n", [1, 700, 5000])
def test_jump_and_status_match_jax_finish(n, share):
    """K21 (the first jump) and K20's status in its jump mode (the second
    jump, the changed mask, the labels, acnt, ch, the count and degree sum)
    against the JAX kernel's finish, mask_status and fits."""
    rng = np.random.default_rng(n + int(share * 100))
    labels, neigh_min = _labels(rng, n, share)
    deg = rng.integers(0, 9, size=n).astype(np.int32)
    k_cap, e_cap = 40, 300
    new, mask = _jax_finish(jnp.asarray(labels), jnp.asarray(neigh_min))
    cnt, ce = jf.mask_status(mask, jnp.asarray(deg), int(deg.sum()))
    fits = bool((cnt <= k_cap) & (ce <= e_cap))
    jumped = torch.full((n,), -7, dtype=torch.int32)
    twcc.wcc_jump(_t(labels), _t(neigh_min), jumped)
    first = jnp.minimum(jnp.asarray(labels), jnp.asarray(neigh_min))
    np.testing.assert_array_equal(
        jumped.numpy(), np.asarray(jnp.minimum(first, j_table_gather(first, first))))
    tl, tm = _t(labels), torch.zeros(n, dtype=torch.bool)
    ctl = torch.zeros(ta.ctl_words(1), dtype=torch.int32)
    ta.cdlp_status(tl, jumped, _t(np.concatenate([deg, [0]]).astype(np.int32)), tm, ctl, k_cap,
                   e_cap, jump=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(new))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(mask))
    assert [int(ctl[i]) for i in (ta.CTL_ACNT, ta.CTL_CH, ta.CTL_MCNT, ta.CTL_MES)] == \
        [ta.DERIVE if fits else ta.STAY_FULL, int(jnp.any(mask)), int(cnt), int(ce)]


@pytest.mark.parametrize("share", [0.0, 0.2, 0.7, 1.0])
def test_min_apply_matches_jax_active_update(share):
    """K19's min mode against wcc.py:123-129: winners = min(old, mins),
    changed rows where winners < old, the scatter, and any()."""
    rng = np.random.default_rng(int(share * 10) + 3)
    n, k = 400, 96
    labels = rng.integers(0, n, size=n).astype(np.int32)
    ids = np.full(k, n, dtype=np.int32)
    ids[:70] = np.sort(rng.choice(n, size=70, replace=False))
    old_at = labels[np.minimum(ids, n - 1)]
    mins = np.where(rng.random(k) < share, rng.integers(0, n, size=k),
                    old_at + rng.integers(0, 3, size=k))
    mins[::11] = INT32_INF  # rows with no neighbour slot
    mins = mins.astype(np.int32)
    jl, ji = jnp.asarray(labels), jnp.asarray(ids)
    valid_row = ji < n
    old = j_table_gather(jl, jnp.where(valid_row, ji, 0))
    winners = jnp.minimum(old, jnp.asarray(mins))
    changed_row = valid_row & (winners < old)
    want = jl.at[jnp.where(changed_row, ji, jnp.int32(n))].set(
        jnp.where(changed_row, winners, 0), mode="drop")
    buf = torch.cat([_t(labels), torch.zeros(1, dtype=torch.int32)])
    rowflag = torch.zeros(k, dtype=torch.bool)
    ch = torch.tensor(-1, dtype=torch.int32)
    ta.cdlp_tier_apply(buf, _t(ids), _t(mins), rowflag, ch, mode="min")
    np.testing.assert_array_equal(buf[:n].numpy(), np.asarray(want))
    np.testing.assert_array_equal(rowflag.numpy(), np.asarray(changed_row))
    assert int(ch) == int(jnp.any(changed_row))


def _ctl(**words):
    ctl = torch.zeros(ta.ctl_words(1), dtype=torch.int32)
    for name, v in words.items():
        ctl[getattr(ta, f"CTL_{name}")] = v
    return ctl


@pytest.mark.parametrize("stage", ["full", "active", "boundary"])
def test_route_matches_the_jax_phase_conditions(stage):
    """K20's route with WCC's one tier (k_cap, e_cap) and itermax = n
    against the conditions of wcc.py:138-185: the full phase's changed & it
    < n & !ok, the active phase's changed & it < n & ok and the outer
    loop's changed & it < n, where ok is fits (after a full step) or the
    next set's count and degree sum within the capacities (after a derive
    or an active step); the it and nf counters."""
    n, (k_cap, e_cap) = 50, (16, 64)
    tiers = torch.tensor([[k_cap, e_cap]], dtype=torch.int32)
    itermax = torch.tensor([n], dtype=torch.int32)
    sets = [(c, e) for c in (0, 1, 15, 16, 17, 40) for e in (0, 63, 64, 65, INT32_INF)]
    for ch in (0, 1):
        for it in (1, 48, 49):
            if stage == "full":
                cases = [((ta.DERIVE if fits else ta.STAY_FULL), 0, fits)
                         for fits in (False, True)]
            else:
                cases = [(c, e, c <= k_cap and e <= e_cap) for c, e in sets]
            for acnt, ae, ok in cases:
                ctl = _ctl(ACNT=acnt, AE=ae, CH=ch, IT=it, NF=1, ITERMAX=n)
                if stage == "full":
                    ta.cdlp_route(ctl, tiers, ta.STAGE_FULL, itermax)
                    it_after = it + 1
                elif stage == "active":
                    ta.cdlp_route(ctl, tiers, ta.STAGE_TIER, itermax)
                    it_after = it + 1
                else:  # after a derive: its route, then the boundary's
                    ta.cdlp_route(ctl, tiers, ta.STAGE_DERIVE, itermax)
                    ta.cdlp_route(ctl, tiers, ta.STAGE_BOUNDARY, itermax)
                    it_after = it
                live = bool(ch) and it_after < n
                cond = [int(c) for c in ctl[ta.CTL_COND:ta.CTL_COND + ta.COND_TIER + 1]]
                assert int(ctl[ta.CTL_IT]) == it_after, (stage, ch, it)
                assert int(ctl[ta.CTL_NF]) == 1 + (stage == "full")
                assert cond[ta.COND_OUTER] == live
                if stage == "full":
                    assert cond[ta.COND_FULL] == (live and not ok)
                    assert cond[ta.COND_DERIVE] == (live and ok)
                else:
                    # the active phase's condition; a set that does not fit
                    # goes back to full steps (at the next boundary after an
                    # active step)
                    assert cond[ta.COND_TIER] == (live and ok), (stage, acnt, ae, ch, it)
                    if stage == "boundary":
                        assert cond[ta.COND_FULL] == (live and not ok)


def _path_into_hub(base, m, d, rng):
    """(vertices, src, dst) of a component that makes an active phase end
    in full steps again: a path of m vertices from ``base`` (the component's
    smallest id) into a hub with d leaves, ``base + 1`` a leaf (the rest of
    the ids at random). The leaf's label floods the star and the path in
    full steps, then ``base`` walks the path one hop a step (pointer jumps
    do not help a label whose root is the leaf), so the changed set fits
    and the steps go active, until the hub changes: its leaves are more
    rows than the capacity, and the loop goes back to full steps."""
    n = m + 1 + d
    ids = base + np.concatenate([[0], 2 + rng.permutation(n - 2)])
    path, hub = ids[:m], ids[m]
    leaves = np.concatenate([[base + 1], ids[m + 1:]])[:d]
    return n, np.concatenate([path[:-1], [path[-1]], np.full(d, hub)]), \
        np.concatenate([path[1:], [hub], leaves])


def _graph(scale, directed):
    """An RMAT graph (the JAX package's generator) and a path into a hub, as
    one JAX Graph (edges push-sorted, both directions where undirected) and
    its twin in the port."""
    from graphtpu.core.graph import Graph as JGraph

    rmat = j_rmat_graph(scale, 4, directed=directed, seed=scale + 5 * directed)
    m, s2, t2 = _path_into_hub(rmat.n, 20, 60, np.random.default_rng(scale))
    src, dst = np.concatenate([rmat.src, s2]), np.concatenate([rmat.dst, t2])
    if not directed:
        src, dst = np.concatenate([src, t2]), np.concatenate([dst, s2])
    order = np.lexsort((dst, src))
    n = rmat.n + m
    jg = JGraph(n, src[order].astype(np.int64), dst[order].astype(np.int64), None,
                np.arange(n, dtype=np.uint64), directed=directed, weighted=False)
    return jg, Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, jg.directed, False)


# (scale, directed, impl, (rows, edges)): capacities that the hub's leaves
# overflow and its degree does not
CASES = [
    (10, False, "auto", (8, 256)), (10, True, "adaptive", (16, 512)),
    (11, False, "adaptive", (16, 512)), (11, True, "auto", (8, 256)),
    (12, False, "auto", (32, 1024)), (12, True, "adaptive", (16, 512)),
]


@pytest.fixture(scope="module")
def graphs():
    return {(scale, directed): _graph(scale, directed) for scale, directed, _, _ in CASES}


@pytest.fixture
def step_log(monkeypatch):
    """The names of the steps the host loop runs, in order (the steps are
    wrapped, not changed)."""
    log = []
    steps = twcc._steps

    def spy(*args):
        return [(name, lambda s=step, name=name: (log.append(name), s())[1])
                for name, step in steps(*args)]

    monkeypatch.setattr(twcc, "_steps", spy)
    return log


@pytest.mark.parametrize("case", range(len(CASES)))
def test_loop_matches_wcc_adaptive_run(graphs, step_log, case):
    """The ctl-driven loop's labels, iterations, full and active steps
    against the JAX package's wcc_adaptive_run, with phases that alternate:
    full steps, a derive, active steps, then full steps again."""
    scale, directed, impl, (k_cap, e_cap) = CASES[case]
    jg, tg = graphs[scale, directed]
    cfg = dict(wcc_impl=impl, wcc_frontier_rows=k_cap, wcc_frontier_edges=e_cap)
    jl, jn, js = jwcc.wcc_adaptive_run(jg, JConfig(**cfg), with_stats=True)
    tl, tn, ts = twcc.wcc_adaptive_run(tg, PlatformConfig(device="cpu", **cfg), with_stats=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tn, ts) == (jn, js), (scale, directed, impl)
    run = twcc.last_run
    assert run["driver"] == "host loop" and run["condition_reads"] > 0
    order = "".join({"init": "I", "full": "F", "derive": "D", "boundary": "B",
                     "tier0": "A"}[s] for s in step_log)
    assert order.count("F") + 1 == ts["full_steps"] and order.count("A") == ts["active_steps"]
    assert "FDBA" in order and "ABF" in order, order  # full, derive, active, full again


def test_edgeless_graph():
    """A graph of vertices and no edge (the JAX package raises on it, fault
    F5): every vertex its own component after iteration 0."""
    tg = Graph.from_arrays(5, np.zeros(0, np.int64), np.zeros(0, np.int64), None,
                           np.arange(5, dtype=np.uint64), False, False)
    for impl in ("auto", "adaptive"):
        labels, it, stats = twcc.wcc_adaptive_run(
            tg, PlatformConfig(device="cpu", wcc_impl=impl), with_stats=True)
        np.testing.assert_array_equal(labels.numpy(), np.arange(5))
        assert (it, stats["full_steps"], stats["active_steps"]) == (1, 1, 0)


# the functions the loop runs at each step, and the wrappers they call
STEP_FUNCTIONS = ("_step_init", "_step_full", "_step_derive", "_step_boundary", "_step_active",
                  "_finish_step", "_route", "_neigh_min_slab", "_neigh_min_edges", "wcc_jump")


@pytest.mark.parametrize("name", STEP_FUNCTIONS)
def test_step_functions_read_nothing_back(name):
    """No step function, nor a wrapper it calls, reads a tensor to the host:
    no .tolist(), .item(), .cpu(), .numpy() and no bool(), int() or float()."""
    tree = ast.parse(inspect.getsource(getattr(twcc, name)))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in ("tolist", "item", "cpu", "numpy"):
                bad.append(f.attr)
            if isinstance(f, ast.Name) and f.id in ("bool", "int", "float"):
                bad.append(f.id)
    assert not bad, (name, bad)
