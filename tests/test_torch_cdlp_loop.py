"""graphtpu_torch's device loop of CDLP auto against the JAX package, on the
CPU (where K14, K18, K19 and K20 run their plain PyTorch versions, and the
loop is the host loop that reads its conditions from the control words).

Inputs come from numpy with a seed and go to both packages; every integer
must be equal bit for bit. The JAX references are graphtpu/ops/frontier.py
(expand, compact_stream, mask_status, frontier_deg_sum) and the formulas of
graphtpu/ops/active.py:_cdlp_adaptive_kernel (chosen, fits_mask, the tier
step's update, the boundary's rule), written out here where they are
nested functions of the jitted kernel.

    JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_cdlp_loop.py
"""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.algorithms.cdlp import build_incidence as j_build_incidence
from graphtpu.ops import active as ja
from graphtpu.ops import frontier as jf
from graphtpu.ops.gather import table_gather as j_table_gather
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms.cdlp import build_incidence
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import active as ta
from graphtpu_torch.ops import frontier as tf
from graphtpu_torch.utils.config import PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _csr(rng, n, max_deg):
    deg = rng.integers(0, max_deg + 1, size=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    neigh = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    return np.concatenate([deg, [0]]).astype(np.int32), indptr.astype(np.int32), neigh


def _frontier(rng, n, k, count):
    """An ascending frontier of ``count`` distinct ids padded with n to k."""
    ids = np.full(k, n, dtype=np.int32)
    ids[:count] = np.sort(rng.choice(n, size=count, replace=False))
    return ids


@pytest.mark.parametrize("k, count", [(1, 0), (1, 1), (7, 3), (64, 64), (300, 111)])
def test_frontier_starts_matches_jax_expand(k, count):
    """K18's plain version against JAX expand's seg_starts and edge_count,
    pad ids (n) included."""
    rng = np.random.default_rng(k + count)
    n = 500
    deg_pad, indptr, neigh = _csr(rng, n, 9)
    ids = _frontier(rng, n, k, count)
    want = jf.expand(jnp.asarray(ids), jnp.asarray(deg_pad), jnp.asarray(indptr),
                     jnp.asarray(neigh), 4096)
    starts = tf.frontier_starts(_t(ids), _t(deg_pad))
    assert starts.dtype == torch.int32 and starts.shape == (k + 1,)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(want.seg_starts))
    assert int(starts[-1]) == int(want.edge_count)
    got = tf.expand(_t(ids), _t(deg_pad), _t(indptr), _t(neigh), 4096)
    np.testing.assert_array_equal(got.seg_starts.numpy(), np.asarray(want.seg_starts))


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("k_out", [5, 40, 400])
def test_compact_rows_and_degree_sum_match_jax(share, k_out):
    """K14's row-flag mode and its degree sum against JAX compact_stream over
    the tier step's ch_edge mask and frontier_deg_sum, and the valid-mask
    mode (``compact_stream_into``, derive's) against compact_stream over
    exp.valid."""
    rng = np.random.default_rng(int(share * 10) + k_out)
    n, k, e_cap = 400, 64, 256
    deg_pad, indptr, neigh = _csr(rng, n, 8)
    ids = _frontier(rng, n, k, 50)
    changed = rng.random(k) < share
    jexp = jf.expand(jnp.asarray(ids), jnp.asarray(deg_pad), jnp.asarray(indptr),
                     jnp.asarray(neigh), e_cap, with_row_ids=False)
    ch_edge = jexp.valid & (j_table_gather(jnp.asarray(changed.astype(np.int32)),
                                           jexp.rows_local) == 1)
    texp = tf.expand(_t(ids), _t(deg_pad), _t(indptr), _t(neigh), e_cap, with_row_ids=False)
    for active, call in ((ch_edge, lambda o, s: tf.compact_rows_into(
            texp, _t(changed), n, _t(deg_pad), o, s)),
            (jexp.valid, lambda o, s: tf.compact_stream_into(
                texp.neigh, texp.valid, n, _t(deg_pad), o, s))):
        jids, jcnt = jf.compact_stream(jexp.neigh, active, k_out, n)
        jsum = jf.frontier_deg_sum(jids, jnp.asarray(deg_pad))
        out = torch.full((k_out,), -7, dtype=torch.int32)
        status = torch.full((2,), -7, dtype=torch.int32)
        call(out, status)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jids))
        assert status.tolist() == [int(jcnt), int(jsum)]


@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
def test_tier_apply_matches_jax(share):
    """K19's plain version against active.py:194-199 and :209: the new
    labels, the changed rows and their any()."""
    rng = np.random.default_rng(int(share * 10))
    n, k = 300, 80
    labels = rng.integers(0, n, size=n).astype(np.int32)
    ids = _frontier(rng, n, k, 60)
    winners = np.where(rng.random(k) < share, rng.integers(0, n, size=k),
                       labels[np.minimum(ids, n - 1)]).astype(np.int32)
    jl, ji, jw = jnp.asarray(labels), jnp.asarray(ids), jnp.asarray(winners)
    valid_row = ji < n
    old = j_table_gather(jl, jnp.where(valid_row, ji, 0))
    changed_row = valid_row & (jw != old)
    want = jl.at[jnp.where(changed_row, ji, jnp.int32(n))].set(
        jnp.where(changed_row, jw, 0), mode="drop")
    buf = torch.cat([_t(labels), torch.zeros(1, dtype=torch.int32)])
    rowflag = torch.zeros(k, dtype=torch.bool)
    ch = torch.tensor(-1, dtype=torch.int32)
    ta.cdlp_tier_apply(buf, _t(ids), _t(winners), rowflag, ch)
    np.testing.assert_array_equal(buf[:n].numpy(), np.asarray(want))
    np.testing.assert_array_equal(rowflag.numpy(), np.asarray(changed_row))
    assert int(ch) == int(jnp.any(changed_row))


@pytest.mark.parametrize("identity", [False, True])
def test_stream_minmode_without_centers_matches_jax(identity):
    """K12's plain version given no centres (the tier step's call) builds
    them from the starts: against JAX stream_minmode over the centres the
    JAX tier step uses (rows_local, H past the last start), with empty
    segments and pad slots."""
    from graphtpu.ops import minmode as jmm
    from graphtpu_torch.ops import minmode as tmm

    rng = np.random.default_rng(11 + identity)
    n, h, pad = 200, 40, 17
    seg_len = rng.integers(0, 9, size=h)
    seg_len[::7] = 0
    indptr = np.concatenate([[0], np.cumsum(seg_len)]).astype(np.int32)
    m = int(indptr[-1]) + pad
    centers = np.full(m, h, dtype=np.int32)
    centers[:indptr[-1]] = np.repeat(np.arange(h), seg_len)
    neigh = rng.integers(0, n, size=m).astype(np.int32)
    labels = rng.integers(0, 30, size=n).astype(np.int32)
    lab = None if identity else labels
    got = tmm.stream_minmode(None if identity else _t(labels), None, _t(neigh), _t(indptr),
                             identity=identity)
    want = jmm.stream_minmode(None if identity else jnp.asarray(lab), jnp.asarray(centers),
                              jnp.asarray(neigh), jnp.asarray(indptr), n, identity=identity)
    full = seg_len > 0  # JAX leaves an empty segment's winner unset (its callers mask it)
    np.testing.assert_array_equal(got.numpy()[full], np.asarray(want)[full])
    assert (got.numpy()[~full] == INT32_INF).all()
    same = tmm.stream_minmode(None if identity else _t(labels), _t(centers), _t(neigh),
                              _t(indptr), identity=identity)
    assert torch.equal(got, same)


def _ctl(t, **words):
    ctl = torch.zeros(ta.ctl_words(t), dtype=torch.int32)
    for name, v in words.items():
        ctl[getattr(ta, f"CTL_{name}")] = v
    return ctl


@pytest.mark.parametrize("share", [0.0, 0.01, 0.2, 1.0])
def test_status_matches_jax_mask_status_and_fits(share):
    """K20's status against the JAX kernel's full_step: changed mask,
    mask_status, fits_mask's sentinel and any()."""
    rng = np.random.default_rng(int(share * 100))
    n, k_max, e_max = 1000, 30, 200
    deg = rng.integers(0, 20, size=n).astype(np.int32)
    labels = rng.integers(0, n, size=n).astype(np.int32)
    new = np.where(rng.random(n) < share, rng.integers(0, n, size=n), labels).astype(np.int32)
    mask = jnp.asarray(new != labels)
    cnt, ce = jf.mask_status(mask, jnp.asarray(deg), int(deg.sum()))
    acnt = jnp.where((cnt <= k_max) & (ce <= e_max), jnp.int32(-1), jnp.int32(INT32_INF))
    tl, tm, ctl = _t(labels), torch.zeros(n, dtype=torch.bool), _ctl(1)
    ta.cdlp_status(tl, _t(new), _t(np.concatenate([deg, [0]]).astype(np.int32)), tm, ctl,
                   k_max, e_max)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(mask))
    np.testing.assert_array_equal(tl.numpy(), new)
    assert [int(ctl[i]) for i in (ta.CTL_ACNT, ta.CTL_CH, ta.CTL_MCNT, ta.CTL_MES)] == \
        [int(acnt), int(jnp.any(mask)), int(cnt), int(ce)]


def _jax_chosen(acnt, ae, tiers):
    """active.py:144-152."""
    c = jnp.int32(len(tiers))
    for i in range(len(tiers) - 1, -1, -1):
        k_i, e_i = tiers[i]
        c = jnp.where((acnt >= 0) & (acnt <= k_i) & (ae <= e_i), jnp.int32(i), c)
    return c


@pytest.mark.parametrize("tiers", [((16, 64),), ((16, 64), (64, 256), (128, 4096))])
def test_route_matches_jax_chosen_and_boundary(tiers):
    """K20's route at the boundary over a grid of (acnt, ae), the -1 and
    INT32_MAX sentinels included: the forward-progress rule (active.py:287)
    and each condition (the phase loops' conds, :215-217, :228-230)."""
    t = len(tiers)
    acnts = sorted({-1, 0, 1, INT32_INF} | {k + d for k, _ in tiers for d in (-1, 0, 1)})
    aes = sorted({0, INT32_INF} | {e + d for _, e in tiers for d in (-1, 0, 1)})
    tiers_t = torch.tensor(tiers, dtype=torch.int32)
    itermax = torch.tensor([10], dtype=torch.int32)
    for ch, it in ((1, 3), (0, 3), (1, 10)):
        for acnt in acnts:
            for ae in aes:
                chosen = int(_jax_chosen(jnp.int32(acnt), jnp.int32(ae), tiers))
                want_acnt = int(jnp.where(chosen == t, jnp.int32(INT32_INF), jnp.int32(acnt)))
                ctl = _ctl(t, ACNT=acnt, AE=ae, CH=ch, IT=it, ITERMAX=10)
                ta.cdlp_route(ctl, tiers_t, ta.STAGE_BOUNDARY, itermax)
                live = bool(ch) and it < 10
                after = int(_jax_chosen(jnp.int32(want_acnt), jnp.int32(ae), tiers))
                cond = ctl[ta.CTL_COND:ta.CTL_COND + ta.COND_TIER + t].tolist()
                assert int(ctl[ta.CTL_ACNT]) == want_acnt
                assert cond == [live, live and want_acnt == INT32_INF, live and want_acnt == -1] \
                    + [live and after == i for i in range(t)], (acnt, ae, ch, it)


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, jg.directed, False)


def _oscillator():
    """0-1 an isolated edge (swaps labels forever), 2 an isolated vertex,
    3-4-5 a triangle (tests/test_adaptive.py:106-115)."""
    from graphtpu.core.graph import Graph as JGraph

    src = np.array([0, 1, 3, 4, 5, 4, 5, 3], dtype=np.int64)
    dst = np.array([1, 0, 4, 5, 3, 3, 4, 5], dtype=np.int64)
    return JGraph(6, src, dst, None, np.arange(6, dtype=np.uint64), directed=False,
                  weighted=False)


# (graph, caps) -> the itermax values run: tests/test_torch_active.py's graphs,
# tiers and itermax values, with itermax 0
GRAPHS = {
    "rmat9-directed": lambda: j_rmat_graph(9, 8, directed=True, seed=3),
    "rmat9-undirected": lambda: j_rmat_graph(9, 8, directed=False, seed=3),
    "rmat10-directed": lambda: j_rmat_graph(10, 16, directed=True, seed=5),
    "rmat10-undirected": lambda: j_rmat_graph(10, 16, directed=False, seed=5),
    "oscillators": _oscillator,
}
CASES = [
    ("rmat9-directed", dict(cdlp_frontier_rows=1 << 10, cdlp_frontier_edges=1 << 14), (0, 1, 10)),
    ("rmat9-undirected", dict(cdlp_frontier_rows=1 << 10, cdlp_frontier_edges=1 << 14),
     (0, 1, 3)),
    ("rmat9-directed", dict(cdlp_frontier_rows=8, cdlp_frontier_edges=32), (1, 3, 10)),
    ("rmat9-undirected", dict(cdlp_frontier_rows=8, cdlp_frontier_edges=32), (10,)),
    ("rmat10-directed", dict(cdlp_tiers="256,1024,4096"), (10,)),
    ("rmat10-undirected", dict(cdlp_tiers="256,1024,4096"), (10,)),
    ("oscillators", dict(cdlp_frontier_rows=1 << 8, cdlp_frontier_edges=1 << 10), (2, 9)),
]


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name, make in GRAPHS.items():
        jg = make()
        tg = _twin(jg)
        jc, jn = j_build_incidence(jg)
        tc, tn = build_incidence(tg)
        deg = np.bincount(tc, minlength=tg.n).astype(np.int32)
        out[name] = (jg, tg, (jc, jn, deg), (tc, tn, deg))
    return out


@pytest.fixture
def boundaries(monkeypatch):
    """Records (acnt before, acnt after) of every boundary step of the host
    loop, read from ctl (the test may read; the steps may not)."""
    seen = []
    step = ta._step_boundary

    def spy(prep, st):
        before = int(st.ctl[ta.CTL_ACNT])
        step(prep, st)
        seen.append((before, int(st.ctl[ta.CTL_ACNT])))

    monkeypatch.setattr(ta, "_step_boundary", spy)
    return seen


@pytest.mark.parametrize("case", range(len(CASES)))
def test_ctl_loop_matches_cdlp_adaptive_kernel(graphs, boundaries, case):
    """The ctl-driven loop's labels, iterations and full steps against
    _cdlp_adaptive_kernel: directed and undirected, one tier and a ladder,
    itermax 0, 1 and reached inside a tier phase, the oscillators."""
    name, caps, itermaxes = CASES[case]
    jg, tg, jin, tin = graphs[name]
    for itermax in itermaxes:
        jl, jit, js = ja.cdlp_adaptive_device_run(jg, *jin, itermax, JConfig(**caps),
                                                  with_stats=True)
        boundaries.clear()
        tl, tit, ts = ta.cdlp_adaptive_device_run(tg, *tin, itermax,
                                                  PlatformConfig(device="cpu", **caps),
                                                  with_stats=True)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert (tit, ts) == (jit, js), (name, itermax)
        run = ta.last_run
        assert run["driver"] == "host loop" and run["condition_reads"] >= (itermax > 0)
        assert sum(run["tier_steps"]) == ts["active_steps"]
        if name == "oscillators" and itermax == 9:  # the run ends inside a tier phase
            assert ts["active_steps"] > 0 and tit == itermax


def test_ctl_loop_sends_an_exact_set_past_every_tier_back_to_full(graphs, boundaries):
    """A derived active set that exceeds every tier (the mask's statistics
    fit, the neighbour union does not): the boundary routes it back to full
    steps, as the JAX kernel's forward-progress rule does, with the JAX
    kernel's labels and counts."""
    jg, tg, jin, tin = graphs["rmat9-directed"]
    caps = dict(cdlp_frontier_rows=8, cdlp_frontier_edges=512)
    jl, jit, js = ja.cdlp_adaptive_device_run(jg, *jin, 10, JConfig(**caps), with_stats=True)
    tl, tit, ts = ta.cdlp_adaptive_device_run(tg, *tin, 10, PlatformConfig(device="cpu", **caps),
                                              with_stats=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tit, ts) == (jit, js)
    assert any(0 <= a < INT32_INF and b == INT32_INF for a, b in boundaries), boundaries


# the functions the loop runs at each step, and the wrappers they call
STEP_FUNCTIONS = ("_step_init", "_step_full", "_step_derive", "_step_boundary", "_step_tier",
                  "_route", "_status", "cdlp_route", "cdlp_status", "cdlp_tier_apply")


@pytest.mark.parametrize("name", STEP_FUNCTIONS)
def test_step_functions_read_nothing_back(name):
    """No step function, nor a wrapper it calls, reads a tensor to the host:
    no .tolist(), .item(), .cpu(), .numpy() and no bool(), int() or float()."""
    tree = ast.parse(inspect.getsource(getattr(ta, name)))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in ("tolist", "item", "cpu", "numpy"):
                bad.append(f.attr)
            if isinstance(f, ast.Name) and f.id in ("bool", "int", "float"):
                bad.append(f.id)
    assert not bad, (name, bad)
