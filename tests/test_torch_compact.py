"""graphtpu_torch's kernels K14 (compact, compact_stream), K7 in its
residual-test and int64 modes, K8's int32 scatter-min and K15 (the LCC
membership sweep) against the JAX package, on the CPU (where each wrapper
runs its plain PyTorch version).

Inputs come from numpy with a seed and go to both packages. Every output
must be bit-identical, pad slots included.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graphtpu.algorithms import bfs as jbfs
from graphtpu.algorithms import lcc as jlcc
from graphtpu.ops import frontier as jf
from graphtpu.ops import triangles as jtri
from graphtpu.ops.gather import table_gather as j_table_gather
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms import bfs as tbfs
from graphtpu_torch.algorithms import lcc as tlcc
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import frontier as tf
from graphtpu_torch.ops import triangles as ttri
from graphtpu_torch.utils.config import PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _twin(jg):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, jg.directed, False)


# ---------------------------------------------------------------- K14


def _mask(case, n, rng):
    if case == "empty":
        return np.zeros(n, dtype=bool)
    if case == "full":
        return np.ones(n, dtype=bool)
    if case == "last_only":
        m = np.zeros(n, dtype=bool)
        m[-1] = True
        return m
    return rng.random(n) < 0.3


@pytest.mark.parametrize("case", ["random", "empty", "full", "last_only"])
@pytest.mark.parametrize("n", [1, 33, 1007])
def test_compact_edge_cases_match_jax(case, n):
    """Empty, full and one-vertex masks at odd n, each with k cut below the
    count, at it, above it and above n (the pad id n fills the rest)."""
    rng = np.random.default_rng(n)
    mask = _mask(case, n, rng)
    cnt = int(mask.sum())
    for k in sorted({1, max(cnt - 1, 1), max(cnt, 1), cnt + 3, n + 5}):
        ids, count = tf.compact(_t(mask), k)
        jids, jcnt = jf.compact(jnp.asarray(mask), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        assert ids.dtype == torch.int32 and count.dtype == torch.int32
        assert int(count) == int(jcnt) == cnt


@pytest.mark.parametrize("case", ["random", "pad_values", "all_inactive", "empty_stream",
                                  "one_value"])
@pytest.mark.parametrize("n", [1, 33, 1007])
def test_compact_stream_edge_cases_match_jax(case, n):
    """Streams holding the pad value n (never taken), no active slot, no
    slot at all and one repeated value, at odd n, with k cut below the
    distinct count, at it and above it."""
    rng = np.random.default_rng(n + len(case))
    e = 0 if case == "empty_stream" else 3 * n + 1
    vals = rng.integers(0, n + 1, size=e).astype(np.int32)
    active = rng.random(e) < 0.5
    if case == "pad_values":
        vals[::2] = n
        active[::2] = True
    elif case == "all_inactive":
        active[:] = False
    elif case == "one_value":
        vals[:], active[:] = n - 1, True
    distinct = len(np.unique(vals[active & (vals < n)]))
    for k in sorted({1, max(distinct - 1, 1), max(distinct, 1), distinct + 4}):
        ids, count = tf.compact_stream(_t(vals), _t(active), k, n)
        jids, jcnt = jf.compact_stream(jnp.asarray(vals), jnp.asarray(active), k, n)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        assert int(count) == int(jcnt) == distinct


def test_compact_wrappers_refuse_bad_arguments():
    with pytest.raises(TypeError, match="bool"):
        tf.compact(torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="k"):
        tf.compact(torch.zeros(4, dtype=torch.bool), -1)
    active = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError, match="int32"):
        tf.compact_stream(torch.zeros(4, dtype=torch.int64), active, 2, 9)
    with pytest.raises(ValueError, match="one length"):
        tf.compact_stream(torch.zeros(4, dtype=torch.int32), active[:3], 2, 9)


# ------------------------------------------------- K7's residual test


def _csr(deg, rng, n):
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    neigh = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    return np.concatenate([deg, [0]]).astype(np.int32), indptr.astype(np.int32), neigh


@pytest.mark.parametrize("case", ["fits", "cut", "no_rows", "pad_slots_marked"])
def test_residual_hits_match_jax_cumsum(case):
    """BFS's residual rows test (K7 max_i32 over the clamped row starts and
    one closing segment) against the JAX package's cumsum of the valid hits
    differenced at the row starts, on a frontier whose edges fit the slots,
    are cut by them, on no rows, and with the pad slots' neighbour 0
    marked."""
    rng = np.random.default_rng(len(case))
    n, k = 400, 64
    e_cap = 128 if case == "cut" else 512
    deg_pad, indptr, neigh = _csr(rng.integers(0, 9, size=n), rng, n)
    cnt = {"fits": 30, "cut": 64, "no_rows": 0, "pad_slots_marked": 20}[case]
    ids = np.full(k, n, dtype=np.int32)
    ids[:cnt] = np.sort(rng.choice(n, size=cnt, replace=False))
    fmask = np.concatenate([rng.random(n) < 0.1, [0]]).astype(np.int32)
    fmask[0] = int(case == "pad_slots_marked")
    exp = tf.expand(_t(ids), _t(deg_pad), _t(indptr), _t(neigh), e_cap, with_row_ids=False)
    got = tf.residual_hits(_t(fmask), exp, e_cap)
    jexp = jf.expand(jnp.asarray(ids), jnp.asarray(deg_pad), jnp.asarray(indptr),
                     jnp.asarray(neigh), e_cap, with_row_ids=False)
    rhit = jexp.valid & (j_table_gather(jnp.asarray(fmask), jexp.neigh) == 1)
    cs = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(rhit.astype(jnp.int32))])
    starts = jnp.minimum(jexp.seg_starts, e_cap)
    want = (j_table_gather(cs, starts[1:]) - j_table_gather(cs, starts[:-1])) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.bool and got.shape == (k,)
    if case == "cut":
        assert int(exp.edge_count) > e_cap
    if case in ("fits", "cut"):
        assert got.any()


def test_bfs_bottom_up_residuals_match_jax():
    """One-device BFS from several sources with a probe of one in-neighbour
    and room for the residual rows, so that bottom-up steps claim rows
    through their full in-lists (held in the run by recording the residual
    tests, K17's plain version here): levels, iterations and per-phase steps equal the JAX
    package's."""
    jg = j_rmat_graph(9, 8, directed=True, seed=3)
    tg = _twin(jg)
    caps = dict(bfs_push_tiers="16,64", bfs_frontier_rows=8, bfs_trunc=1, bfs_bu_rows=256,
                bfs_bu_edges=4096)
    hits = []
    real = tbfs.residual_claim

    def record(*args):
        out = real(*args)
        hits.append(int((out != args[-1]).sum()))  # rows claimed, not pad
        return out

    tbfs.residual_claim = record
    try:
        for src in (0, 1, 5):
            jl, jn, js = jbfs.bfs_adaptive_run(jg, src, JConfig(**caps), with_stats=True)
            tl, tn, ts = tbfs.bfs_adaptive_run(tg, src, PlatformConfig(device="cpu", **caps),
                                               with_stats=True)
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
            assert (tn, ts) == (jn, js)
    finally:
        tbfs.residual_claim = real
    assert hits and max(hits) > 0, hits


# ---------------------------------------------------------------- K8 int32


@pytest.mark.parametrize("offset", [0, 37])
def test_relax_min_i32_matches_jax_scatter_min(offset):
    """The distributed WCC's active-step scatter-min (the JAX package's
    gather of the owners' labels and .at[].min into INT32_INF with the
    invalid slots dropped), on contended targets and a rank's row offset.
    The wrapper takes the expansion's real-slot count (its valid slots are
    the prefix [0, total)); the plain version fed that count equals it fed
    the mask."""
    rng = np.random.default_rng(offset)
    n_lab, n_out, e = 300, 120, 2000
    labels = rng.integers(0, n_lab, size=n_lab).astype(np.int32)
    row_ids = rng.integers(0, n_lab - offset, size=e).astype(np.int32)
    neigh = rng.integers(0, n_out, size=e).astype(np.int32)
    total = 1200 + 17 * offset
    valid = np.arange(e) < total
    total_t = torch.tensor(total, dtype=torch.int32)
    got = tf.relax_min_i32(n_out, _t(labels), _t(row_ids), _t(neigh), total_t, offset)
    assert torch.equal(got, tf.relax_min_i32_plain(n_out, _t(labels), _t(row_ids), _t(neigh),
                                                   _t(valid), offset))
    lab_u = j_table_gather(jnp.asarray(labels), jnp.where(valid, row_ids + offset, 0))
    want = (jnp.full((n_out,), INT32_INF, jnp.int32)
            .at[jnp.where(valid, neigh, n_out)]
            .min(jnp.where(valid, lab_u, INT32_INF), mode="drop"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and (got < INT32_INF).any()
    empty = tf.relax_min_i32(5, _t(labels), *(torch.zeros(0, dtype=torch.int32),) * 2,
                             torch.zeros((), dtype=torch.int32))
    assert torch.equal(empty, torch.full((5,), INT32_INF, dtype=torch.int32))


# ------------------------------------------------- K7 sum_i64 and K15


def test_aggregate_heads_matches_jax_and_is_exact_past_2_32():
    """LCC's credit sums per head (K7 sum_i64) against the JAX function on
    random credits within its precondition (row partials under 2^24), and
    against numpy's int64 sums where heads sum past 2^32."""
    rng = np.random.default_rng(8)
    n, m_flat, m = 500, 9000, 6000
    flat = rng.integers(0, 1000, size=m_flat).astype(np.int32)
    pos = rng.integers(0, m_flat, size=m).astype(np.int32)
    heads = np.sort(rng.integers(0, n, size=m))
    hip = np.searchsorted(heads, np.arange(n + 1)).astype(np.int32)
    got = ttri._aggregate_heads(_t(flat), _t(pos), _t(hip))
    want = jtri._aggregate_heads(jnp.asarray(flat), jnp.asarray(pos), None, jnp.asarray(hip))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    big = rng.integers(1 << 30, (1 << 31) - 1, size=m_flat).astype(np.int32)
    got = ttri._aggregate_heads(_t(big), _t(pos), _t(hip)).numpy()
    exact = np.zeros(n, dtype=np.int64)
    np.add.at(exact, heads, big[pos].astype(np.int64))
    np.testing.assert_array_equal(got, exact)
    assert got.max() > 1 << 32


def _jax_sweep_numerator(jg):
    """The JAX package's sweep numerators (its _lcc_sweep without the
    division): each bucket's chunks padded with -1, as it pads them."""
    s_indptr, s_dst, s_deg, c, o, dc = jlcc.prepare_lcc(jg)
    iters = max(1, int(np.ceil(np.log2(max(int(s_deg.max()), 2) + 1))))
    num = jnp.zeros((jg.n,), jnp.int32)
    for pad in jlcc._bucket_bounds(int(s_deg.max())):
        lo = 0 if pad == 16 else pad // 8
        sel = (dc > lo) & (dc <= pad) if pad > 16 else dc <= pad
        if not sel.any():
            continue
        padded = -(-int(sel.sum()) // jlcc._CHUNK) * jlcc._CHUNK
        cb, ob = np.full(padded, -1, np.int32), np.full(padded, -1, np.int32)
        cb[:sel.sum()], ob[:sel.sum()] = c[sel], o[sel]
        num = jlcc._lcc_bucket_sweep(num, jnp.asarray(s_indptr), jnp.asarray(s_dst),
                                     jnp.asarray(cb), jnp.asarray(ob), pad, iters)
    return np.asarray(num).astype(np.int64)


@pytest.mark.parametrize("directed", [True, False])
def test_sweep_numerators_match_jax(directed):
    """The port's sweep (K15's plain version per bucket) against the JAX
    package's on RMAT s9/ef8: pads 16 and 128, and in the directed graph
    718 edges whose reverse is stored too (multiplicity 2); and against the
    oriented numerators."""
    jg = j_rmat_graph(9, 8, directed=directed, seed=7)
    tg = _twin(jg)
    got, deg_s = tlcc.lcc_sweep_numerator(tg, "cpu")
    want = _jax_sweep_numerator(jg)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got.max() > 0
    np.testing.assert_array_equal(got, ttri.lcc_oriented_numerator(ttri.wedge_plan(tg,
                                                                                   device="cpu")))
    if directed:
        pairs = set(zip(tg.src.tolist(), tg.dst.tolist()))
        assert sum((b, a) in pairs for a, b in pairs) > 0


def test_sweep_wrapper_refuses_bad_arguments():
    z32 = torch.zeros(3, dtype=torch.int32)
    num = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(TypeError, match="int64 numerator"):
        tlcc._lcc_bucket_sweep(num.int(), z32, z32, z32, z32, 16, 2)
    with pytest.raises(ValueError, match="one length"):
        tlcc._lcc_bucket_sweep(num, z32, z32, z32, z32[:2], 16, 2)
