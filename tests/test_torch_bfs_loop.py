"""graphtpu_torch's device loops of BFS auto and bfs-impl=device against the
JAX package, on the CPU (where K5, K7, K13, K14, K17, K18 and K23 run their
plain PyTorch versions, and the loops are the host loops that read their
conditions from the control words).

Inputs come from numpy with a seed and go to both packages. Levels, counts
and step counts are integers: tolerance 0. The JAX references are the
formulas of graphtpu/algorithms/bfs.py:_bfs_adaptive_kernel (the source's
status, a tier step's ``applied`` scatter, the bottom-up's ``ok`` update,
the dense step, ``chosen`` and the phase conditions), written out here where
they are nested functions of the jitted kernel, ``bfs_adaptive_run`` and
``_bfs_kernel`` themselves.

    JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_bfs_loop.py
"""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.algorithms import bfs as jbfs
from graphtpu.ops import frontier as jf
from graphtpu.ops.gather import table_gather as j_table_gather
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import bfs as tbfs
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import frontier as tf
from graphtpu_torch.utils.config import PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

TIERS = ((8, 16), (8, 64), (8, 256))
K_BU, E_BU = 4, 16
N = 300
# the caps of tests/test_torch_bfs.py: every tier, a tier abort, a bottom-up,
# an aborted bottom-up and a dense step run over SOURCES on RMAT s9/ef8
SOURCES = (0, 1, 5, 77)
SMALL = dict(bfs_push_tiers="16,64,256", bfs_frontier_rows=8, bfs_bu_rows=4, bfs_bu_edges=16)
CAPS = {"default": {}, "small": SMALL, "small-t1": dict(SMALL, bfs_trunc=1)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_chosen(cnt, fe, min_tier, tiers):
    """bfs.py:154-160 and :274-276."""
    ff = jnp.int32(len(tiers))
    for i in range(len(tiers) - 1, -1, -1):
        k_i, e_i = tiers[i]
        ff = jnp.where((cnt <= k_i) & (fe <= e_i), jnp.int32(i), ff)
    return jnp.maximum(ff, min_tier)


def _levels(rng, level):
    """Levels of a BFS at ``level``: about half the vertices reached at 0..level."""
    lev = rng.integers(0, level + 1, size=N).astype(np.int32)
    lev[rng.random(N) < 0.5] = INT32_INF
    return lev


# stage -> (what the step wrote before K23, and whether the step applies)
CASES = {
    "init": None, "tier1-applied": True, "tier1-aborted": False, "tier2-aborted": False,
    "bu-ok": True, "bu-aborted-rows": False, "bu-aborted-edges": False, "dense": True,
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_matches_jax_step(case):
    """K23's plain version against the JAX kernel's step ends: the source's
    levels and status (:287-288), a tier step's applied scatter and status
    (:194-209), the bottom-up's claims, claimed ids and status under ok
    (:233-260), the dense step (:57-59, :271); then chosen with min_tier, the
    phase conditions (:278-298) and the counters; and the dense frontier
    (the JAX dense kernel's: the source, the new frontier, levels == level
    before a dense step)."""
    rng = np.random.default_rng(len(case))
    t, level, src = len(TIERS), 3, 17
    deg = rng.integers(0, 6, size=N).astype(np.int32)
    deg_pad = np.concatenate([deg, [0]]).astype(np.int32)
    lev = _levels(rng, level)
    counts0 = [2, 1, 0, 1, 3]
    cnt0, fe0, min_tier0 = 5, 20, 0
    ctl = torch.zeros(tbfs.ctl_words(t), dtype=torch.int32)
    ctl[:tbfs.BCTL_COND] = torch.tensor([cnt0, fe0, level, min_tier0, N])
    ctl[tbfs.BCTL_COND + t + 3:] = torch.tensor(counts0)
    fmask = rng.integers(0, 2, size=N).astype(np.int32)
    tl, tfm = _t(lev), _t(fmask)
    tiers = torch.tensor(TIERS, dtype=torch.int32)
    jl = jnp.asarray(lev)
    kw, counts = {}, list(counts0)
    want_fmask = fmask
    unvis = np.flatnonzero(lev == INT32_INF)
    if case == "init":
        want = jnp.full((N,), INT32_INF, jnp.int32).at[src].set(0)
        cnt, fe = jf.mask_status(want == 0, jnp.asarray(deg), int(deg.sum()))
        want_level, min_tier, counts = 0, 0, [0] * (t + 2)
        want_fmask = np.zeros(N, np.int32)
        want_fmask[src] = 1
        stage = tbfs.STAGE_INIT
        kw = dict(source=torch.tensor([src], dtype=torch.int32))
    elif case.startswith("tier"):
        i = int(case[4])
        k = TIERS[i][0]
        cnt2 = k if CASES[case] else k + 3
        ids2 = np.full(k, N, np.int32)
        picked = np.sort(rng.choice(unvis, size=min(cnt2, k), replace=False))
        ids2[:picked.shape[0]] = picked
        fe2 = int(deg_pad[ids2].sum())
        applied = cnt2 <= k
        want = jnp.where(applied, jl.at[jnp.asarray(ids2)].set(level + 1, mode="drop"), jl)
        cnt, fe = (cnt2, fe2) if applied else (cnt0, fe0)
        want_level = level + int(applied)
        min_tier = 0 if applied else i + 1
        counts[i] += 1
        stage = tbfs.STAGE_TIER + i
        kw = dict(ids=_t(ids2), stat=torch.tensor([cnt2, fe2], dtype=torch.int32))
    elif case.startswith("bu"):
        claim = np.zeros(N, bool)
        claim[unvis[::3]] = True
        rest = np.setdiff1d(unvis, unvis[::3])
        claimed = np.full(K_BU, N, np.int32)
        claimed[:2] = rest[:2]
        rcnt = {"bu-ok": K_BU, "bu-aborted-rows": K_BU + 1, "bu-aborted-edges": 2}[case]
        fe_r = E_BU + 1 if case == "bu-aborted-edges" else E_BU
        ok = (rcnt <= K_BU) & (fe_r <= E_BU)
        updated = jnp.where(jnp.asarray(claim), level + 1, jl)
        updated = updated.at[jnp.asarray(claimed)].set(level + 1, mode="drop")
        want = jnp.where(ok, updated, jl)
        ncnt, nfe = jf.mask_status(want == level + 1, jnp.asarray(deg), int(deg.sum()))
        cnt, fe = (ncnt, nfe) if ok else (cnt0, fe0)
        want_level = level + int(ok)
        min_tier = 0 if ok else t + 1
        if not ok:  # the dense step's frontier (bfs.py:267)
            want_fmask = np.asarray(jl == level).astype(np.int32)
        counts[t] += 1
        stage = tbfs.STAGE_BU
        kw = dict(claim=_t(claim), ids=_t(claimed),
                  stat=torch.tensor([rcnt, fe_r], dtype=torch.int32))
    else:
        reached = (rng.random(N) < 0.3).astype(np.int32)
        new_frontier = jnp.where(jl == INT32_INF, jnp.asarray(reached), 0)
        want = jnp.where(new_frontier == 1, level + 1, jl)
        cnt, fe = jf.mask_status(want == level + 1, jnp.asarray(deg), int(deg.sum()))
        want_level, min_tier = level + 1, 0
        want_fmask = np.asarray(new_frontier)
        counts[t + 1] += 1
        stage = tbfs.STAGE_DENSE
        kw = dict(reached=_t(reached))
    tbfs.bfs_apply(tl, tfm, ctl, tiers, stage, N, deg_pad=_t(deg_pad), k_bu=K_BU, e_bu=E_BU,
                   **kw)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tfm.numpy(), want_fmask)
    chosen = int(_jax_chosen(jnp.int32(cnt), jnp.int32(fe), jnp.int32(min_tier), TIERS))
    outer = int(cnt) > 0 and want_level < N
    c = tbfs.BCTL_COND
    assert ctl[:c].tolist() == [int(cnt), int(fe), want_level, min_tier, N], case
    assert ctl[c:c + t + 3].tolist() == [outer] + [outer and chosen == j for j in range(t + 2)]
    assert ctl[c + t + 3:].tolist() == counts


def test_apply_dense_nest_has_no_degrees():
    """bfs-impl=device's K23 without degrees (no tier): the count alone, an
    edge sum of 0, and the JAX dense kernel's cond nonempty & level < n."""
    lev = np.full(6, INT32_INF, np.int32)
    lev[2] = 0
    tl, tfm = _t(lev), torch.zeros(6, dtype=torch.int32)
    tfm[2] = 1
    ctl = torch.zeros(tbfs.ctl_words(0), dtype=torch.int32)
    ctl[:tbfs.BCTL_COND] = torch.tensor([1, 0, 0, 0, 6])
    tiers = torch.zeros((0, 2), dtype=torch.int32)
    tbfs.bfs_apply(tl, tfm, ctl, tiers, tbfs.STAGE_DENSE, 6,
                   reached=torch.tensor([0, 1, 1, 0, 1, 0], dtype=torch.int32))
    assert tl.tolist() == [INT32_INF, 1, 0, INT32_INF, 1, INT32_INF]
    assert tfm.tolist() == [0, 1, 0, 0, 1, 0]
    assert ctl[:tbfs.BCTL_COND + 1].tolist() == [2, 0, 1, 0, 6, 1]


def test_apply_refuses_bad_arguments():
    lev, fm = torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    ctl = torch.zeros(tbfs.ctl_words(1), dtype=torch.int32)
    tiers = torch.tensor([[2, 4]], dtype=torch.int32)
    with pytest.raises(ValueError, match="stage"):
        tbfs.bfs_apply(lev, fm, ctl, tiers, tbfs.STAGE_DENSE, 4)  # no reached
    with pytest.raises(ValueError, match="stage"):
        tbfs.bfs_apply(lev, fm, ctl, tiers, tbfs.STAGE_TIER + 1, 4,
                       ids=torch.zeros(2, dtype=torch.int32),
                       stat=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        tbfs.bfs_apply(lev.long(), fm, ctl, tiers, tbfs.STAGE_INIT, 4,
                       source=torch.zeros(1, dtype=torch.int32))


def _expansion(rng, levels, k, e_cap):
    deg = rng.integers(0, 7, size=N)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    dst = rng.integers(0, N, size=int(indptr[-1])).astype(np.int32)
    deg_pad = np.concatenate([deg, [0]]).astype(np.int32)
    ids = np.full(k, N, np.int32)
    front = np.flatnonzero(levels == 2)[:k]
    ids[:front.shape[0]] = front
    return deg_pad, indptr, dst, ids, e_cap


@pytest.mark.parametrize("k", [1, 8, 40, 400])
def test_k14_level_and_unvisited_modes_match_jax_and_scalar_forms(k):
    """K14's level mode against compact(levels == level, k) (the scalar
    form, and the JAX package's compact), its unvisited mode against the
    JAX tier step's unvisited filter, compact_stream and frontier_deg_sum
    (bfs.py:185-201) and against the scalar form (compact_stream_into of the
    filter), and compact_into against compact and frontier_deg_sum."""
    rng = np.random.default_rng(k)
    lev = _levels(rng, 3)
    tl = _t(lev)
    level = torch.tensor([2], dtype=torch.int32)
    ids, count = torch.zeros(k, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    tf.compact_level_into(tl, level, ids, count)
    j_ids, j_cnt = jf.compact(jnp.asarray(lev) == 2, k)
    s_ids, s_cnt = tf.compact(tl == 2, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    assert torch.equal(ids, s_ids) and int(count[0]) == int(j_cnt) == int(s_cnt)

    deg_pad, indptr, dst, f_ids, e_cap = _expansion(rng, lev, 32, 96)
    texp = tf.expand(_t(f_ids), _t(deg_pad), _t(indptr), _t(dst), e_cap, with_row_ids=False)
    out, status = torch.zeros(k, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    tf.compact_unvisited_into(texp, tl, N, _t(deg_pad), out, status)
    jexp = jf.expand(jnp.asarray(f_ids), jnp.asarray(deg_pad), jnp.asarray(indptr),
                     jnp.asarray(dst), e_cap, with_row_ids=False)
    unvisited = jexp.valid & (j_table_gather(jnp.asarray(lev), jexp.neigh) == INT32_INF)
    j_ids2, j_cnt2 = jf.compact_stream(jexp.neigh, unvisited, k, N)
    j_fe2 = jf.frontier_deg_sum(j_ids2, jnp.asarray(deg_pad))
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_ids2))
    assert status.tolist() == [int(j_cnt2), int(j_fe2)]
    s_out, s_status = torch.zeros(k, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    tf.compact_stream_into(texp.neigh, texp.valid & (tl[texp.neigh.long()] == INT32_INF), N,
                           _t(deg_pad), s_out, s_status)
    assert torch.equal(out, s_out) and torch.equal(status, s_status)

    resid = torch.from_numpy(rng.random(N) < 0.1)
    tf.compact_into(resid, _t(deg_pad), out, status)
    c_ids, c_cnt = tf.compact(resid, k)
    assert torch.equal(out, c_ids)
    assert status.tolist() == [int(c_cnt), int(tf.frontier_deg_sum(c_ids, _t(deg_pad)))]


@pytest.mark.parametrize("t", [1, 2, 3])
def test_k13_k17_device_level_modes_match_scalar_forms(t):
    """K13 and K17 given the level as a one-element tensor (read on the card
    in their device-level modes) against their scalar forms, and K17's
    claims against the JAX bottom-up's segment-any (bfs.py:236-248)."""
    rng = np.random.default_rng(t)
    lev = _levels(rng, 3)
    tl = _t(lev)
    pdeg = rng.integers(0, 6, size=N).astype(np.int32)
    trunc = rng.integers(0, N + 1, size=t * N).astype(np.int32)  # N: the sentinel
    level = torch.tensor([2], dtype=torch.int32)
    got = tf.bfs_trunc_probe(tl, level, _t(trunc), _t(pdeg), t)
    want = tf.bfs_trunc_probe(tl, 2, _t(trunc), _t(pdeg), t)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tf.bfs_trunc_probe_plain(tl, level, _t(trunc), _t(pdeg), t)[0].equal(want[0])

    k_bu, e_bu = 16, 48
    deg_pad, indptr, dst, _, _ = _expansion(rng, lev, 32, 96)
    rids = np.full(k_bu, N, np.int32)
    rows = np.sort(rng.choice(N, size=10, replace=False))
    rids[:10] = rows
    texp = tf.expand(_t(rids), _t(deg_pad), _t(indptr), _t(dst), e_bu, with_row_ids=False)
    got = tf.residual_claim(tl, level, texp, e_bu, _t(rids), N)
    assert torch.equal(got, tf.residual_claim(tl, 2, texp, e_bu, _t(rids), N))
    jexp = jf.expand(jnp.asarray(rids), jnp.asarray(deg_pad), jnp.asarray(indptr),
                     jnp.asarray(dst), e_bu, with_row_ids=False)
    fmask_pad = jnp.concatenate([(jnp.asarray(lev) == 2).astype(jnp.int32),
                                 jnp.zeros((1,), jnp.int32)])
    rhit = (jexp.valid & (j_table_gather(fmask_pad, jexp.neigh) == 1)).astype(jnp.int32)
    cs = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(rhit, dtype=jnp.int32)])
    seg = j_table_gather(cs, jexp.seg_starts[1:]) - j_table_gather(cs, jexp.seg_starts[:-1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.where(seg > 0, jnp.asarray(rids),
                                                                    N)))


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, jg.directed, False)


@pytest.fixture(scope="module", params=[True, False], ids=["directed", "undirected"])
def graphs(request):
    jg = j_rmat_graph(9, 8, directed=request.param, seed=3)
    return jg, _twin(jg)


@pytest.fixture(scope="module")
def jax_runs(graphs):
    """The JAX package's adaptive runs, per caps and source (compiled once
    per module and graph)."""
    jg, _ = graphs
    return {(name, src): jbfs.bfs_adaptive_run(jg, src, JConfig(**caps), with_stats=True)
            for name, caps in CAPS.items() for src in SOURCES}


@pytest.mark.parametrize("mode", ["phases", "switch"])
@pytest.mark.parametrize("caps", list(CAPS))
def test_host_walk_matches_bfs_adaptive_run(graphs, jax_runs, caps, mode):
    """The ctl-driven nest's levels, levels done and per-phase step counts
    against the JAX package's bfs_adaptive_run, from every source, under
    both step modes; under small caps every tier, a tier abort, a bottom-up,
    an aborted bottom-up and a dense step run over the sources."""
    jg, tg = graphs
    seen = np.zeros(6, dtype=np.int64)  # tiers 0-2, bottom-up, dense, tier aborts
    for src in SOURCES:
        jl, jn, js = jax_runs[caps, src]
        tl, tn, ts = tbfs.bfs_adaptive_run(
            tg, src, PlatformConfig(device="cpu", bfs_step_mode=mode, **CAPS[caps]),
            with_stats=True)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert (tn, ts) == (jn, js), (caps, src)
        assert tbfs.last_run["driver"] == "host loop" and tbfs.last_run["condition_reads"] > 0
        tier = list(ts["tier_steps"].values())
        steps = tier[:3] + [ts["bu_steps"], ts["dense_steps"]]
        # a level ends in one completing step; a dense step follows one aborted
        # bottom-up; the rest are tier aborts
        steps.append(sum(tier) + ts["bu_steps"] - tn)
        seen += steps
    if caps != "default":
        assert (seen > 0).all(), seen


def test_dense_nest_matches_bfs_kernel(graphs):
    """bfs-impl=device's nest against the JAX package's _bfs_kernel: levels
    and steps (the last, empty one included)."""
    jg, tg = graphs
    coo = jg.device_pull()
    indptr = jnp.asarray(jg.pull_indptr.astype(np.int32))
    for src in SOURCES:
        jl, jn = jbfs._bfs_kernel(coo.src, coo.dst, indptr, jnp.int32(src), jg.n)
        tl, tn = tbfs._bfs_kernel(tg, src, "cpu")
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert tn == int(jn)
        assert tbfs.last_run == {"driver": "host loop", "condition_reads": tn + 1}


def test_edgeless_graph():
    """A graph of vertices and no edge: the source at 0, the rest unreached;
    auto takes one tier step (its frontier has no edge: the empty new
    frontier applies, as in the JAX kernel, and counts a level), device one
    dense step."""
    tg = Graph.from_arrays(4, np.zeros(0, np.int64), np.zeros(0, np.int64), None,
                           np.arange(4, dtype=np.uint64), True, False)
    levels, it, stats = tbfs.bfs_adaptive_run(tg, 2, PlatformConfig(device="cpu"),
                                              with_stats=True)
    want = [INT32_INF, INT32_INF, 0, INT32_INF]
    assert levels.tolist() == want
    assert (it, sum(stats["tier_steps"].values()), stats["bu_steps"], stats["dense_steps"]) == \
        (1, 1, 0, 0)
    levels, it = tbfs._bfs_kernel(tg, 2, "cpu")
    assert levels.tolist() == want and it == 1


def test_loop_nest_and_runs():
    """The nest holds each condition once, in the JAX kernel's phase order,
    and loop_runs reads each step's executions from the counters."""
    from graphtpu_torch.ops import device_loop

    assert device_loop.conditions(tbfs.loop_nest(4)) == 4 + 3
    assert device_loop.conditions(tbfs.DENSE_NEST) == 1
    order = [node[2][0] for node in tbfs.loop_nest(2)[1][2]]
    assert order == ["tier0", "tier1", "bu", "dense"]
    ctl = [0] * tbfs.ctl_words(2)
    ctl[tbfs.BCTL_COND + 5:] = [3, 1, 2, 1]
    assert tbfs.loop_runs(ctl, 2) == {"init": 1, "tier0": 3, "tier1": 1, "bu": 2, "dense": 1}


# the functions the loops run at each step, and the wrappers they call
STEP_FUNCTIONS = ("_step_init", "_step_tier", "_step_bu", "_step_dense", "_apply", "_level",
                  "bfs_apply", "compact_level_into", "compact_unvisited_into", "compact_into",
                  "expand")


@pytest.mark.parametrize("name", STEP_FUNCTIONS)
def test_step_functions_read_nothing_back(name):
    """No step function, nor a wrapper it calls, reads a tensor to the host:
    no .tolist(), .item(), .cpu(), .numpy() and no bool(), int() or float()."""
    tree = ast.parse(inspect.getsource(getattr(tbfs, name)))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in ("tolist", "item", "cpu", "numpy"):
                bad.append(f.attr)
            if isinstance(f, ast.Name) and f.id in ("bool", "int", "float"):
                bad.append(f.id)
    assert not bad, (name, bad)
