"""The plain versions of kernels K12 (``ops/minmode.py:stream_minmode``,
kernel ``segment_minmode``) and K13 (``ops/frontier.py:bfs_trunc_probe``)
against the JAX package, on the CPU, where each wrapper runs its plain
version.

K12 takes its segments from ``indptr`` alone, while the plain version and
the JAX function sort by ``centers``: the two are one function where
``centers`` is ``repeat_interleave(arange(H), diff(indptr))`` followed by
H for each entry past ``indptr[-1]`` (entries that join no segment), which
is held here for every caller's stream (the heavy rows of a slab plan, a
tier step's expansion, whose pad slots the JAX kernel gives a segment of
their own, a distributed slab rank's heavy stream and its trailing junk
segment). Inputs come from numpy with a seed; results must be bit-identical
on every non-empty segment (the JAX function leaves empty ones as junk,
which its callers mask; the port gives INT32_INF there).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graphtpu.algorithms import bfs as jbfs
from graphtpu.ops import frontier as jfr
from graphtpu.ops import minmode as jmm
from graphtpu.ops.gather import table_gather as j_table_gather
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import bfs as tbfs
from graphtpu_torch.algorithms.cdlp import build_incidence
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import frontier as tfr
from graphtpu_torch.ops import kernels
from graphtpu_torch.ops import minmode as tmm
from graphtpu_torch.ops.slab import build_slab_plan
from graphtpu_torch.parallel.slab_cdlp import build_dist_slab_plan
from graphtpu_torch.utils.config import PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, jg.directed, False)


def _segment_ids(indptr) -> np.ndarray:
    ip = np.asarray(indptr, dtype=np.int64)
    return np.repeat(np.arange(ip.shape[0] - 1), np.diff(ip))


def _assert_segmented_by(centers, indptr):
    """centers = the segment ids of indptr, then H past indptr[-1]."""
    centers, ip = np.asarray(centers), np.asarray(indptr)
    np.testing.assert_array_equal(centers[:ip[-1]], _segment_ids(ip))
    assert (centers[ip[-1]:] == ip.shape[0] - 1).all()


def _stream(rng, seg_len, n_ids):
    indptr = np.concatenate([[0], np.cumsum(seg_len)]).astype(np.int32)
    centers = _segment_ids(indptr).astype(np.int32)
    neigh = rng.integers(0, n_ids, size=centers.shape[0]).astype(np.int32)
    return centers, neigh, indptr


def _both(labels, centers, neigh, indptr, n, identity):
    """(the port's stream_minmode, the JAX stream_minmode) as numpy."""
    got = tmm.stream_minmode(None if identity else _t(labels), _t(centers), _t(neigh),
                             _t(indptr), identity=identity).numpy()
    want = np.asarray(jmm.stream_minmode(
        None if identity else jnp.asarray(labels), jnp.asarray(centers), jnp.asarray(neigh),
        jnp.asarray(indptr), n, identity=identity))
    return got, want


def _assert_matches_jax(got, want, indptr):
    nonempty = np.diff(np.asarray(indptr)) > 0
    np.testing.assert_array_equal(got[nonempty], want[nonempty])
    assert (got[~nonempty] == INT32_INF).all()


# (segments, longest segment, distinct ids, distinct labels): few labels
# make ties and long runs, many make every run short
SIZES = [(1, 1, 5, 3), (40, 60, 50, 15), (300, 9, 400, 4), (64, 5000, 3000, 2000),
         (7, 70000, 1 << 20, 1 << 20)]


@pytest.mark.parametrize("identity", [False, True], ids=["gather", "identity"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"h{s[0]}-len{s[1]}")
def test_stream_minmode_plain_matches_jax(size, identity):
    h, longest, n_ids, n_labels = size
    rng = np.random.default_rng(h + longest)
    seg_len = rng.integers(1, longest + 1, size=h)
    centers, neigh, indptr = _stream(rng, seg_len, n_ids)
    labels = rng.integers(0, n_labels, size=n_ids).astype(np.int32)
    got, want = _both(labels, centers, neigh, indptr, n_ids, identity)
    _assert_matches_jax(got, want, indptr)


@pytest.mark.parametrize("identity", [False, True], ids=["gather", "identity"])
def test_stream_minmode_empty_segments_and_one_segment_of_every_entry(identity):
    rng = np.random.default_rng(11)
    n = 500
    labels = rng.integers(0, 30, size=n).astype(np.int32)
    # runs of empty segments between real ones, empty ones at both ends
    seg_len = np.array([0, 0, 3, 0, 1, 0, 0, 41, 0, 7, 0], dtype=np.int64)
    centers, neigh, indptr = _stream(rng, seg_len, n)
    got, want = _both(labels, centers, neigh, indptr, n, identity)
    _assert_matches_jax(got, want, indptr)
    assert (got[seg_len == 0] == INT32_INF).all()
    # one segment that holds every entry
    centers, neigh, indptr = _stream(rng, np.array([4000]), n)
    got, want = _both(labels, centers, neigh, indptr, n, identity)
    _assert_matches_jax(got, want, indptr)
    # no segment at all
    got = tmm.stream_minmode(_t(labels), _t(centers[:0]), _t(neigh[:0]),
                             torch.zeros(1, dtype=torch.int32))
    assert got.shape == (0,) and got.dtype == torch.int32


def test_stream_minmode_ties_take_the_smallest_label():
    labels = np.array([9, 4, 4, 9, 7, 2, 2, 7, 1, 8], dtype=np.int32)
    # segment 0: 9 x2, 4 x2 -> 4; segment 1: 7 x2, 2 x2, 1 -> 2; segment 2: all
    # distinct -> the smallest; segment 3: one entry; segment 4: all equal
    neigh = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 8, 3, 0, 0, 3], dtype=np.int32)
    seg_len = np.array([4, 5, 3, 1, 3])
    indptr = np.concatenate([[0], np.cumsum(seg_len)]).astype(np.int32)
    centers = _segment_ids(indptr).astype(np.int32)
    got, want = _both(labels, centers, neigh, indptr, 10, False)
    assert got.tolist() == [4, 2, 1, 9, 9]
    np.testing.assert_array_equal(got, want)
    got, want = _both(None, centers, neigh, indptr, 10, True)
    assert got.tolist() == [0, 4, 0, 3, 0]
    np.testing.assert_array_equal(got, want)


def test_stream_minmode_pads_join_no_count():
    """Ids outside [0, len(labels)) in gather mode, and negative ids in
    identity mode, are pads, as the kernel treats them."""
    labels = torch.tensor([5, 5, 3, 3, 3], dtype=torch.int32)
    neigh = torch.tensor([0, 7, 7, 7, 1, -1, 2, 2, 9, 9, 9, 0], dtype=torch.int32)
    indptr = torch.tensor([0, 5, 9, 12], dtype=torch.int32)
    centers = torch.repeat_interleave(torch.arange(3, dtype=torch.int32), indptr.diff())
    got = tmm.stream_minmode(labels, centers, neigh, indptr)
    assert got.tolist() == [5, 3, 5]
    ident = tmm.stream_minmode(None, centers, neigh, indptr, identity=True)
    assert ident.tolist() == [7, 2, 9]


def test_stream_minmode_checks_its_arguments():
    c = torch.zeros(3, dtype=torch.int32)
    ip = torch.tensor([0, 3], dtype=torch.int32)
    with pytest.raises(TypeError, match="gather mode"):
        tmm.stream_minmode(None, c, c, ip)
    with pytest.raises(TypeError, match="int32"):
        tmm.stream_minmode(c, c, c.long(), ip)
    with pytest.raises(ValueError, match="one length"):
        tmm.stream_minmode(c, c[:2], c, ip)


def _tier_stream(tg, k_i, e_i, seed):
    """A tier step's stream as ``ops/active.py:tier_step`` builds it (the
    expansion of k_i rows, ascending, pad = n, at e_i slots; the pad slots
    past the k_i segments), and as the JAX tier step builds it (the pad
    slots in a segment k_i of their own)."""
    centers, neigh = build_incidence(tg)
    deg = np.bincount(centers, minlength=tg.n).astype(np.int64)
    indptr_pad = np.zeros(tg.n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr_pad[1:])
    deg_pad = np.concatenate([deg, [0]])
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.permutation(tg.n)[:k_i])
    pick = pick[np.cumsum(deg[pick]) <= e_i]  # the tier's edge budget holds the rows
    assert pick.shape[0] > 0
    ids = np.full(k_i, tg.n, dtype=np.int32)
    ids[:pick.shape[0]] = pick
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731
    exp = tfr.expand(i32(ids), i32(deg_pad), i32(indptr_pad), i32(neigh), e_i,
                     with_row_ids=False)
    t_centers = torch.where(exp.valid, exp.rows_local, k_i)
    jexp = jfr.expand(jnp.asarray(ids), jnp.asarray(deg_pad.astype(np.int32)),
                      jnp.asarray(indptr_pad.astype(np.int32)), jnp.asarray(neigh), e_i)
    j_centers = jnp.where(jexp.valid, jexp.rows_local, jnp.int32(k_i))
    j_indptr = jnp.concatenate([jexp.seg_starts, jnp.full((1,), e_i, jnp.int32)])
    return (t_centers, exp.neigh, exp.seg_starts), (j_centers, jexp.neigh, j_indptr)


@pytest.mark.parametrize("k_i,e_i", [(16, 128), (64, 1024), (8, 37)])
def test_tier_step_stream_matches_jax_without_its_pad_segment(k_i, e_i):
    jg = j_rmat_graph(9, 8, directed=False, seed=3)
    tg = _twin(jg)
    (tc, tnb, tip), (jc, jnb, jip) = _tier_stream(tg, k_i, e_i, seed=k_i)
    # the pad slots read neighbour 0, inside the labels
    assert bool((tnb >= 0).all() and (tnb < tg.n).all())
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tnb.numpy(), np.asarray(jnb))
    np.testing.assert_array_equal(tip.numpy(), np.asarray(jip)[:k_i + 1])
    _assert_segmented_by(tc.numpy(), tip.numpy())
    _assert_segmented_by(np.asarray(jc), np.asarray(jip))  # the JAX layout: one more segment
    labels = np.random.default_rng(1).integers(0, 20, size=tg.n).astype(np.int32)
    got = tmm.stream_minmode(_t(labels), tc, tnb, tip).numpy()
    want = np.asarray(jmm.stream_minmode(jnp.asarray(labels), jc, jnb, jip, tg.n))[:k_i]
    _assert_matches_jax(got, want, tip.numpy())


@pytest.mark.parametrize("directed", [False, True], ids=["undirected", "directed"])
def test_heavy_plan_and_dist_rank_streams_are_segmented_by_indptr(directed):
    tg = _twin(j_rmat_graph(10, 16, directed=directed, seed=5))
    centers, neigh = build_incidence(tg)
    deg = np.bincount(centers, minlength=tg.n)
    buckets = (2, 4, 8)  # everything above 8 is a heavy row
    plan = build_slab_plan(centers, neigh, deg, tg.n, buckets, device="cpu")
    assert plan.heavy_rows is not None and plan.heavy_rows.shape[0] > 10
    _assert_segmented_by(plan.heavy_centers.numpy(), plan.heavy_indptr.numpy())
    assert int(plan.heavy_indptr[-1]) == plan.heavy_neigh.shape[0]
    for d in (1, 2, 3):
        dist = build_dist_slab_plan(tg, d, buckets)
        c_loc, nb, ip = dist.heavy
        for rank in range(d):
            # each rank's stream with its trailing junk segment (K7, the JAX
            # layout) and without it (K12: the padding joins no segment)
            _assert_segmented_by(c_loc[rank], ip[rank])
            _assert_segmented_by(c_loc[rank], ip[rank, :-1])
            assert ip[rank, -1] == nb.shape[1]


def test_heavy_rows_through_a_cdlp_step_match_jax():
    """The heavy rows' min-mode, as ``cdlp_step`` runs it, against the JAX
    function on the same plan arrays."""
    tg = _twin(j_rmat_graph(10, 16, directed=True, seed=9))
    centers, neigh = build_incidence(tg)
    deg = np.bincount(centers, minlength=tg.n)
    plan = build_slab_plan(centers, neigh, deg, tg.n, (2, 4, 8), device="cpu")
    labels = np.random.default_rng(2).integers(0, 64, size=tg.n).astype(np.int32)
    for identity in (False, True):
        got, want = _both(None if identity else labels, plan.heavy_centers.numpy(),
                          plan.heavy_neigh.numpy(), plan.heavy_indptr.numpy(), tg.n, identity)
        _assert_matches_jax(got, want, plan.heavy_indptr.numpy())


# ---------------------------------------------------------------- K13


def _jax_probe(levels, level, trunc, pdeg, t, n):
    """The JAX package's bu_step expressions (graphtpu/algorithms/bfs.py:
    bu_step) on the same arrays."""
    lv = jnp.asarray(levels)
    fmask_pad = jnp.concatenate([(lv == level).astype(jnp.int32), jnp.zeros((1,), jnp.int32)])
    hit = jnp.max(j_table_gather(fmask_pad, jnp.asarray(trunc)).reshape(t, n), axis=0)
    unvis = lv == INT32_INF
    claim = unvis & (hit == 1)
    resid = unvis & (jnp.asarray(pdeg) > t) & (hit == 0)
    return np.asarray(claim), np.asarray(resid)


def _probe_inputs(rng, n, t, level):
    """Levels with visited rows up to ``level`` and unvisited ones, a probe
    table with the sentinel n past each row's in-degree, in-degrees 0..3t."""
    levels = np.where(rng.random(n) < 0.4, rng.integers(0, level + 1, size=n),
                      INT32_INF).astype(np.int32)
    pdeg = rng.integers(0, 3 * t + 1, size=n).astype(np.int32)
    trunc = rng.integers(0, n, size=(t, n)).astype(np.int32)
    trunc[np.arange(t)[:, None] >= pdeg[None, :]] = n
    return levels, trunc.reshape(-1), pdeg


@pytest.mark.parametrize("t", [1, 2, 4, 11])
def test_bfs_trunc_probe_plain_matches_jax_bu_step(t):
    rng = np.random.default_rng(t)
    n, level = 3000, 3
    levels, trunc, pdeg = _probe_inputs(rng, n, t, level)
    claim, resid = tfr.bfs_trunc_probe(_t(levels), level, _t(trunc), _t(pdeg), t)
    want_claim, want_resid = _jax_probe(levels, level, trunc, pdeg, t, n)
    np.testing.assert_array_equal(claim.numpy(), want_claim)
    np.testing.assert_array_equal(resid.numpy(), want_resid)
    assert claim.any() and resid.any()
    assert not (claim & resid).any()


def test_bfs_trunc_probe_rank_rows_at_an_offset():
    """A rank's rows [offset, offset + r) of the replicated levels, its
    table of global ids with the sentinel len(levels): the rows of the
    one-device probe."""
    rng = np.random.default_rng(4)
    n, t, level, d = 1200, 2, 5, 3
    levels, trunc, pdeg = _probe_inputs(rng, n, t, level)
    claim, resid = tfr.bfs_trunc_probe(_t(levels), level, _t(trunc), _t(pdeg), t)
    r = n // d
    tab = trunc.reshape(t, n)
    for k in range(d):
        rows = slice(k * r, (k + 1) * r)
        c, s = tfr.bfs_trunc_probe(_t(levels), level, _t(tab[:, rows].reshape(-1)),
                                   _t(pdeg[rows]), t, k * r)
        np.testing.assert_array_equal(c.numpy(), claim[rows].numpy())
        np.testing.assert_array_equal(s.numpy(), resid[rows].numpy())


def test_bfs_trunc_probe_checks_its_arguments():
    lv = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="t >= 1"):
        tfr.bfs_trunc_probe(lv, 0, lv[:8], lv[:4], 0)
    with pytest.raises(ValueError, match="table entries"):
        tfr.bfs_trunc_probe(lv, 0, lv[:7], lv[:4], 2)
    with pytest.raises(ValueError, match="inside"):
        tfr.bfs_trunc_probe(lv, 0, lv[:8], lv[:4], 2, 8)
    with pytest.raises(TypeError, match="int32"):
        tfr.bfs_trunc_probe(lv, 0, lv[:8].long(), lv[:4], 2)


@pytest.mark.parametrize("directed", [False, True], ids=["undirected", "directed"])
def test_bfs_auto_takes_the_bottom_up_phase_and_matches_jax(directed):
    jg = j_rmat_graph(11, 16, directed=directed, seed=6)
    tg = _twin(jg)
    caps = dict(bfs_push_tiers="64,256", bfs_frontier_rows=64, bfs_bu_rows=1 << 12,
                bfs_bu_edges=1 << 15)
    jl, jn, js = jbfs.bfs_adaptive_run(jg, 0, JConfig(**caps), with_stats=True)
    kernels.reset_launch_counts()
    tl, tn, ts = tbfs.bfs_adaptive_run(tg, 0, PlatformConfig(device="cpu", **caps),
                                       with_stats=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tn, ts) == (jn, js)
    assert ts["bu_steps"] > 0
    # on the CPU every wrapper took its plain version: nothing was launched
    assert not any(kernels.launch_counts.values())
