"""graphtpu_torch's frontier engine and vreg_shuffle against the JAX
package, on the CPU (where K4 and K5 run their plain PyTorch versions).

Inputs come from numpy with a seed and go to both packages. Every output
field must be bit-identical, pad slots included.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graphtpu.ops import frontier as jf

from graphtpu_torch.ops import frontier as tf
from graphtpu_torch.ops.pallas_gather import vreg_shuffle, vreg_shuffle_plain


def _t(a):
    return torch.from_numpy(np.array(a))


def _csr(deg, rng, n):
    """(deg_pad, indptr_pad, neigh) of a random CSR with degrees ``deg``."""
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    neigh = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    return np.concatenate([deg, [0]]).astype(np.int32), indptr.astype(np.int32), neigh


def _edges_csr(n, edges):
    """The CSR of tests/test_frontier.py's hand-made edge lists."""
    edges = sorted(edges)
    deg = np.bincount([e[0] for e in edges], minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    neigh = np.array([e[1] for e in edges], dtype=np.int32)
    return np.concatenate([deg, [0]]).astype(np.int32), indptr.astype(np.int32), neigh


def _assert_expansions_equal(got, want):
    for field in tf.Expansion._fields:
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None, field
            continue
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=field)
        assert str(g.dtype) == f"torch.{np.asarray(w).dtype}", field


def _both_expand(ids, deg_pad, indptr, neigh, e_cap, with_row_ids=True):
    want = jf.expand(jnp.asarray(ids), jnp.asarray(deg_pad), jnp.asarray(indptr),
                     jnp.asarray(neigh), e_cap, with_row_ids=with_row_ids)
    got = tf.expand(_t(ids), _t(deg_pad), _t(indptr), _t(neigh), e_cap,
                    with_row_ids=with_row_ids)
    _assert_expansions_equal(got, want)
    return got


@pytest.mark.parametrize("case", ["roundtrip", "empty_rows_between", "empty_frontier"])
def test_expand_matches_jax_on_the_jax_suite_cases(case):
    """The cases of tests/test_frontier.py, through both packages."""
    if case == "roundtrip":
        n = 10
        csr = _edges_csr(n, [(0, 3), (0, 7), (2, 1), (2, 4), (2, 9), (7, 0)])
        mask = np.zeros(n, dtype=bool)
        mask[[0, 2, 5, 7]] = True
        ids, cnt = tf.compact(_t(mask), 8)
        assert int(cnt) == 4
        got = _both_expand(ids.numpy(), *csr, 16)
        assert int(got.edge_count) == 6
        assert got.neigh[got.valid].tolist() == [3, 7, 1, 4, 9, 0]
        assert got.rows_local[got.valid].tolist() == [0, 0, 1, 1, 1, 3]
    elif case == "empty_rows_between":
        n = 6
        csr = _edges_csr(n, [(1, 0), (4, 2), (4, 5)])
        got = _both_expand(np.array([0, 1, 2, 4, n, n], dtype=np.int32), *csr, 8)
        assert got.neigh[got.valid].tolist() == [0, 2, 5]
        assert got.rows_local[got.valid].tolist() == [1, 3, 3]
    else:
        n = 4
        csr = _edges_csr(n, [(0, 1)])
        got = _both_expand(np.full(4, n, dtype=np.int32), *csr, 8)
        assert int(got.edge_count) == 0 and not got.valid.any()


@pytest.mark.parametrize("with_row_ids", [True, False])
@pytest.mark.parametrize("k,e_slack", [(64, 9), (64, 0), (64, -17), (64, None), (300, 5)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_matches_jax_on_random_frontiers(seed, k, e_slack, with_row_ids):
    """Random frontiers over rows with degree 0..5 (so empty rows at the
    start, between and at the end), K > n (300 > 200), exact fit, room to
    spare, truncation (negative slack) and a single slot (None)."""
    rng = np.random.default_rng(seed)
    n = 200
    deg = rng.integers(0, 6, size=n)
    deg[:3] = 0
    deg_pad, indptr, neigh = _csr(deg, rng, n)
    count = int(rng.integers(1, min(k, n)))
    ids = np.full(k, n, dtype=np.int32)
    ids[:count] = np.sort(rng.choice(n, size=count, replace=False))
    total = int(deg_pad[ids].sum())
    e_cap = 1 if e_slack is None else max(total + e_slack, 1)
    got = _both_expand(ids, deg_pad, indptr, neigh, e_cap, with_row_ids)
    assert int(got.edge_count) == total


def test_frontier_expand_checks_its_arguments():
    ids, starts = torch.zeros(4, dtype=torch.int32), torch.zeros(5, dtype=torch.int32)
    indptr, neigh = torch.zeros(3, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tf.frontier_expand(ids.long(), starts, indptr, neigh, 8)
    with pytest.raises(ValueError, match="K >= 1"):
        tf.frontier_expand(ids, starts[:4], indptr, neigh, 8)
    with pytest.raises(ValueError, match="e_cap"):
        tf.frontier_expand(ids, starts, indptr, neigh, -1)


@pytest.mark.parametrize("k", [1, 50, 500])
def test_compact_matches_jax(k):
    n = 300
    mask = np.random.default_rng(k).random(n) < 0.3
    ids, cnt = tf.compact(_t(mask), k)
    jids, jcnt = jf.compact(jnp.asarray(mask), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert int(cnt) == int(jcnt) and ids.dtype == torch.int32


def test_compact_stream_matches_jax():
    """The JAX suite's hand case (dedupe, truncation, padding), then seeded
    random streams at capacities below, at and above the unique count."""
    n = 10
    vals = np.array([7, 2, 7, 2, 9, 0, 4], dtype=np.int32)
    active = np.array([True, True, True, False, True, False, True])
    cases = [(vals, active, 8, n), (vals, active, 2, n), (vals[:2], active[:2], 5, n)]
    rng = np.random.default_rng(3)
    for k in (5, 40, 400):
        cases.append((rng.integers(0, 100, size=256).astype(np.int32),
                      rng.random(256) < 0.5, k, 100))
    for v, a, k, nn in cases:
        ids, cnt = tf.compact_stream(_t(v), _t(a), k, nn)
        jids, jcnt = jf.compact_stream(jnp.asarray(v), jnp.asarray(a), k, nn)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        assert int(cnt) == int(jcnt)


def test_mask_status_and_deg_sum_match_jax():
    rng = np.random.default_rng(4)
    n = 500
    deg = rng.integers(0, 50, size=n).astype(np.int32)
    for p in (0.0, 0.1, 1.0):
        mask = rng.random(n) < p
        cnt, es = jf.mask_status(jnp.asarray(mask), jnp.asarray(deg), int(deg.sum()))
        assert tf.mask_status(_t(mask), _t(deg)).tolist() == [int(cnt), int(es)]
    deg_pad = np.concatenate([deg, [0]]).astype(np.int32)
    ids = np.concatenate([np.sort(rng.choice(n, 40, replace=False)), np.full(10, n)])
    ids = ids.astype(np.int32)
    assert int(tf.frontier_deg_sum(_t(ids), _t(deg_pad))) == int(
        jf.frontier_deg_sum(jnp.asarray(ids), jnp.asarray(deg_pad)))


def test_scatter_frontier_matches_jax():
    rng = np.random.default_rng(5)
    neigh = rng.integers(0, 64, size=200).astype(np.int32)
    active = rng.random(200) < 0.4
    for cap in (64, 70):
        want = np.asarray(jf.scatter_frontier(cap, jnp.asarray(neigh), jnp.asarray(active)))
        np.testing.assert_array_equal(tf.scatter_frontier(cap, _t(neigh), _t(active)).numpy(),
                                      want)


# ---------------------------------------------------------------- K4


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_vreg_shuffle_matches_jax_interpret(dtype):
    from jax.experimental.pallas import tpu as pltpu
    from graphtpu.ops.pallas_gather import vreg_shuffle as j_vreg_shuffle

    rng = np.random.default_rng(6)
    tbl8 = (rng.integers(-(1 << 30), 1 << 30, size=(8, 128)) if dtype == np.int32
            else rng.standard_normal((8, 128))).astype(dtype)
    ind = rng.integers(0, 8, size=(8, 128)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_vreg_shuffle(jnp.asarray(tbl8), jnp.asarray(ind)))
    got = vreg_shuffle(_t(tbl8), _t(ind))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(tbl8, ind, axis=0))
    assert torch.equal(got, vreg_shuffle_plain(_t(tbl8), _t(ind)))


def test_vreg_shuffle_checks_its_arguments():
    ind = torch.zeros(8, 128, dtype=torch.int32)
    with pytest.raises(TypeError, match="tbl8"):
        vreg_shuffle(torch.zeros(8, 128, dtype=torch.float64), ind)
    with pytest.raises(TypeError, match="tbl8"):
        vreg_shuffle(torch.zeros(16, 128, dtype=torch.int32), ind)
    with pytest.raises(TypeError, match="ind"):
        vreg_shuffle(torch.zeros(8, 128, dtype=torch.int32), ind.long())


# ---------------------------------------------------------------- K5's rule


@pytest.mark.parametrize("with_row_ids", [True, False])
@pytest.mark.parametrize("e_cap", [1, 3, 1023, 1025])
@pytest.mark.parametrize("frontier", ["mixed", "one_row", "all_empty", "empty_run"])
def test_expand_owner_is_the_last_row_starting_at_or_before_the_slot(frontier, e_cap,
                                                                     with_row_ids):
    """The rule kernel K5 finds owners by, in numpy: slot s belongs to the
    LARGEST r with starts[r] <= min(s, edges - 1) (row 0 without edges), so
    empty rows own nothing and every pad slot has the last edge's owner.
    Against the JAX function on every slot, at slot counts around 1,024,
    k = 1, a frontier without edges, and a run of empty rows."""
    rng = np.random.default_rng(e_cap + len(frontier))
    n = 3000
    deg = rng.integers(0, 4, size=n)
    if frontier == "mixed":
        ids = np.concatenate([np.sort(rng.choice(n, size=700, replace=False)), np.full(68, n)])
    elif frontier == "one_row":
        deg[7] = 1500
        ids = np.array([7])
    elif frontier == "all_empty":
        deg[:500] = 0
        ids = np.concatenate([np.arange(500), np.full(12, n)])
    else:
        deg[100:1400] = 0
        deg[99], deg[1400] = 600, 700
        ids = np.concatenate([np.arange(99, 1401), np.full(5, n)])
    ids = ids.astype(np.int32)
    deg_pad, indptr, neigh = _csr(deg, rng, n)
    got = _both_expand(ids, deg_pad, indptr, neigh, e_cap, with_row_ids)
    starts = np.concatenate([[0], np.cumsum(deg_pad[ids])])
    total = int(starts[-1])
    slot = np.arange(e_cap)
    owner = np.zeros(e_cap, dtype=np.int64)
    if total:
        owner = np.searchsorted(starts[:-1], np.minimum(slot, total - 1), side="right") - 1
    np.testing.assert_array_equal(got.rows_local.numpy(), owner)
    valid = slot < total
    gpos = np.where(valid, indptr[ids[owner]] + slot - starts[owner], 0)
    np.testing.assert_array_equal(got.gpos.numpy(), gpos)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    if neigh.size:
        np.testing.assert_array_equal(got.neigh.numpy(), np.where(valid, neigh[gpos], 0))
