"""K7's mode sum on a sliced pull (``ops/spmv.py:PullSlices``), on the CPU.

The layout is held to the pull CSR it is built from: its real edges a
permutation of the CSR's, slice base + local id = src, each slice padded
to whole groups of 16 and the stream closed by one more, a head at every
run (one row of one slice, ascending by row inside a slice) and pad, a
row-major list of the real runs, tiles of whole groups that never cross a
slice, at most ``SLICE_ITEMS`` edges each, with the heads before each (and
in each group's word, those of its tile before it). Its reduction in plain
PyTorch (each run's sum, then each row's runs' sums in slice order) is
held to the JAX package's PageRank pull (``_pr_kernel``'s
``pull_reduce`` over ``table_gather``) and slab heavy rows on the same
seeded numpy inputs: within 1e-5 relative in float32 and 1e-12 in float64,
the tolerances of ``chip_smoke.py``'s kernel checks (the sums add in other
orders), beside what the JAX pull's differenced prefix sums can lose,
absolute (``_jax_pull_atol``). The JAX functions run eagerly, once per
case.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphtpu.algorithms.pr import _pr_kernel as j_pr_kernel
from graphtpu.ops.gather import table_gather as j_table_gather
from graphtpu.ops.spmv import build_pull_plan as j_build_pull_plan
from graphtpu.ops.spmv import pull_reduce as j_pull_reduce
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms.pr import _pr_loop
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.ops.spmv import (
    SLICE_GROUP, SLICE_ITEMS, SLICE_WIDTH, build_pull_slices, csr_pull_reduce,
    csr_pull_reduce_plain, memo_pull_slices, pull_csr, pull_slices_heads, pull_slices_sum_plain,
)

RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _csr(deg, src):
    indptr = np.zeros(len(deg) + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    return torch.from_numpy(np.asarray(src, dtype=np.int32)), torch.from_numpy(
        indptr.astype(np.int32))


def _hand(case, rng):
    """(src, indptr, width) of the hand cases."""
    if case == "n_below_width":  # one slice, shorter than a width
        deg = rng.integers(0, 5, size=100)
        return (*_csr(deg, np.sort(rng.integers(0, 100, size=deg.sum()))), None)
    if case == "n_not_a_multiple":  # 1,000 = 15 x 64 + 40: the last slice is short
        deg = rng.integers(0, 9, size=1000)
        return (*_csr(deg, rng.integers(0, 1000, size=deg.sum())), 64)
    if case == "hub_over_every_slice":  # row 3 reads every id, over all 25 slices
        deg = rng.integers(0, 3, size=800)
        deg[3] = 800
        src = rng.integers(0, 800, size=deg.sum())
        src[deg[:3].sum():deg[:4].sum()] = np.arange(800)
        return (*_csr(deg, src), 32)
    if case == "empty_slices_and_rows":  # ids skip slices 1 and 3; half the rows empty
        deg = rng.integers(0, 7, size=640)
        deg[rng.choice(640, size=320, replace=False)] = 0
        src = rng.choice(np.r_[0:128, 256:384, 512:640], size=deg.sum())
        return (*_csr(deg, src), 128)
    if case == "many_tiles":  # one slice whose stream spans several tiles
        deg = rng.integers(0, 12, size=4096)
        deg[17] = 3 * SLICE_ITEMS + 5
        return (*_csr(deg, rng.integers(0, 4096, size=deg.sum())), 4096)
    if case == "edgeless":
        return (*_csr(np.zeros(9, dtype=np.int64), []), None)
    raise ValueError(case)


def _rows_sorted(src, indptr):
    """The CSR with each row's ids ascending, as a pull CSR holds them."""
    s = src.numpy().copy()
    ip = indptr.numpy()
    for r in range(len(ip) - 1):
        s[ip[r]:ip[r + 1]].sort()
    return torch.from_numpy(s)


def _check_layout(src, indptr, sl):
    """Every invariant of a sliced pull against the CSR it came from."""
    n, m, grp = indptr.shape[0] - 1, src.shape[0], SLICE_GROUP
    width, total = sl.width, sl.lid.shape[0]
    lid = sl.lid.long().numpy() & 0xFFFF
    heads = pull_slices_heads(sl).numpy()
    row_runs = sl.row_runs.long().numpy()
    part_ptr = sl.part_ptr.long().numpy()
    se = sl.slice_edges.long().numpy()
    nslices = len(se) - 1
    assert sl.n_x == (int(src.max()) + 1 if m else 0) and sl.edges == m
    assert nslices == -(-sl.n_x // width) and se[0] == 0 and se[-1] == total
    assert total % grp == 0 and sl.head.shape[0] == total // grp
    assert sl.head.dtype == torch.int32
    assert (np.diff(se) % grp == 0).all()
    run = np.cumsum(heads) - 1
    assert total == 0 or heads[0]
    assert sl.runs == heads.sum() and part_ptr[-1] == row_runs.shape[0]
    # the real runs: each once in the row-major list; the others are pad
    assert np.unique(row_runs).shape[0] == row_runs.shape[0]
    row_of_run = np.full(sl.runs, -1)
    row_of_run[row_runs] = np.repeat(np.arange(n), np.diff(part_ptr))
    pad = row_of_run[run] < 0 if total else np.zeros(0, bool)
    edge_slice = np.repeat(np.arange(nslices), np.diff(se))
    # the real edges: a permutation of the CSR's (row, src) pairs, slice by
    # slice in the CSR's order; each slice's pad after them, under 16 of it
    # (16 more in the last: the group that closes the stream), each pad run
    # starting at a head
    assert (~pad).sum() == m
    rows = np.repeat(np.arange(n), np.diff(indptr.numpy()))
    want = np.lexsort((src.numpy(), rows, src.numpy() // width))
    np.testing.assert_array_equal((edge_slice * width + lid)[~pad], src.numpy()[want])
    np.testing.assert_array_equal(row_of_run[run[~pad]], rows[want])
    for s in range(nslices):
        p = pad[se[s]:se[s + 1]]
        k = int((~p).sum())
        assert not p[:k].any() and p[k:].all()
        assert p.sum() < grp + (grp if s == nslices - 1 else 0)
        if p.any():
            assert heads[se[s] + k]
        # each real run is one row of the slice; the runs ascend by row
        r = run[se[s]:se[s] + k]
        if k:
            starts = np.flatnonzero(heads[se[s]:se[s] + k])
            assert starts[0] == 0
            assert (np.diff(row_of_run[r[starts]]) > 0).all()
            np.testing.assert_array_equal(row_of_run[r], np.repeat(
                row_of_run[r[starts]], np.diff(np.r_[starts, k])))
    if total:
        assert pad[-grp:].all()  # the closing group, inside the last pad run
    # the list: row-major, a row's runs in slice order
    for r in range(n):
        runs_r = row_runs[part_ptr[r]:part_ptr[r + 1]]
        assert (np.diff(edge_slice[np.searchsorted(run, runs_r)]) > 0).all()
    # the tiles: whole groups of one slice, at most `items`, the heads before each
    te, tr = sl.tile_edge.long().numpy(), sl.tile_run.long().numpy()
    tsl = sl.tile_slice.long().numpy()
    assert te[0] == 0 and te[-1] == total and (te % grp == 0).all()
    assert ((np.diff(te) > 0) & (np.diff(te) <= sl.items)).all()
    np.testing.assert_array_equal(tr, np.r_[0, np.cumsum(heads)][te])
    # a group's word: above its heads, the heads of its tile before it
    groups = np.arange(0, total, grp)
    tile_of = np.searchsorted(te, groups, side="right") - 1
    np.testing.assert_array_equal((sl.head.long().numpy() >> grp) & 0xFFFF,
                                  np.r_[0, np.cumsum(heads)][groups] - tr[tile_of])
    for t in range(len(tsl)):
        assert se[tsl[t]] <= te[t] < te[t + 1] <= se[tsl[t] + 1]
    for s in range(nslices):  # a tile starts at every nonempty slice's start
        if se[s + 1] > se[s]:
            assert (te == se[s]).any()
    return sl


@pytest.mark.parametrize("case", ["n_below_width", "n_not_a_multiple", "hub_over_every_slice",
                                  "empty_slices_and_rows", "many_tiles", "edgeless"])
def test_pull_slices_layout_hand_cases(case):
    rng = np.random.default_rng(len(case))
    src, indptr, width = _hand(case, rng)
    src = _rows_sorted(src, indptr)
    sl = _check_layout(src, indptr, build_pull_slices(src, indptr, 4, width))
    assert sl.width == (width or SLICE_WIDTH[4])
    x = torch.from_numpy(rng.random(max(sl.n_x, 1)))
    want = csr_pull_reduce_plain("sum", x, src, indptr)
    torch.testing.assert_close(pull_slices_sum_plain(sl, x), want, rtol=1e-12, atol=0)
    if case == "empty_slices_and_rows":
        assert (sl.slice_edges.diff()[[1, 3]] == 0).all()


@pytest.mark.parametrize("scale,width", [(10, None), (10, 128), (11, 256), (12, 512)])
def test_pull_slices_layout_rmat(scale, width):
    jg = j_rmat_graph(scale, 8, directed=True, seed=scale)
    tg = Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, True, False)
    csr = pull_csr(tg, "cpu")
    for itemsize in (4, 8):
        sl = _check_layout(csr.src, csr.indptr,
                           build_pull_slices(csr.src, csr.indptr, itemsize, width))
        assert sl.itemsize == itemsize and sl.nbytes() > 0


def _jax_pull_atol(x, src, iters=1):
    """What the JAX pull's prefix sums can lose, absolute: it differences a
    float64 prefix of the whole stream at the row ends (8 units in the last
    place of the whole sum), and a float32 stream longer than a block adds
    its terms in float32 inside rows of 128 lanes first (7 roundings of up
    to 128 terms, at both ends of a row); ``iters`` pulls of PageRank add up."""
    tot = float(np.abs(np.asarray(x, np.float64)[src]).sum())
    atol = 8 * np.finfo(np.float64).eps * tot
    if x.dtype == np.float32:
        atol += 16 * 128 * np.finfo(np.float32).eps * float(np.abs(x).max())
    return iters * atol


def _j_pull(x, src, dst, indptr, n):
    """The JAX package's segment-sum pull as _pr_kernel calls it."""
    from graphtpu.ops.gather import EDGE_STREAM_CHUNK

    return np.asarray(j_pull_reduce("sum", j_table_gather(jnp.asarray(x), jnp.asarray(src),
                                                          chunk=EDGE_STREAM_CHUNK),
                                    jnp.asarray(dst), jnp.asarray(indptr), n,
                                    jnp.zeros((), x.dtype), "scan"))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("scale,width", [(10, 64), (11, None)])
def test_sliced_sum_matches_jax_pr_pull(scale, width, dtype):
    """The sliced reduction of the pull CSR against the JAX pull on x like
    PageRank's r / outdeg; then 20 PageRank iterations on it against the
    JAX _pr_kernel."""
    jg = j_rmat_graph(scale, 16, directed=False, seed=3)
    tg = Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, False, False)
    csr = pull_csr(tg, "cpu")
    sl = build_pull_slices(csr.src, csr.indptr, np.dtype(dtype).itemsize, width)
    x = (np.random.default_rng(scale).random(jg.n) / jg.n).astype(dtype)
    src, dst, _ = jg.pull_arrays()
    want = _j_pull(x, src, dst, jg.pull_indptr, jg.n)
    got = pull_slices_sum_plain(sl, torch.from_numpy(x))
    plain = csr_pull_reduce_plain("sum", torch.from_numpy(x), csr.src, csr.indptr)
    torch.testing.assert_close(got, plain, rtol=RTOL[dtype], atol=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dtype], atol=_jax_pull_atol(x, src))
    out_deg = jg.out_degree.astype(np.int32)
    damping = np.asarray(0.85, dtype)
    j_ranks = j_pr_kernel(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(jg.pull_indptr),
                          jnp.asarray(out_deg), jnp.asarray(damping), jg.n, 20)
    ranks = _pr_loop(lambda v: pull_slices_sum_plain(sl, v), torch.from_numpy(out_deg),
                     torch.from_numpy(damping), jg.n, 20)
    np.testing.assert_allclose(ranks.numpy(), np.asarray(j_ranks), rtol=RTOL[dtype],
                               atol=_jax_pull_atol(x, src, 20))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sliced_sum_matches_jax_slab_heavy_rows(dtype):
    """The slab plan's heavy rows (in-degree past the widest bucket), as
    the JAX slab SpMV reduces them, from the sliced layout of their CSR."""
    jg = j_rmat_graph(12, 16, directed=False, seed=5)
    plan = j_build_pull_plan(jg, buckets=(4, 16, 64))
    assert plan.heavy_rows is not None
    neigh, indptr = np.asarray(plan.heavy_neigh), np.asarray(plan.heavy_indptr)
    rows = indptr.shape[0] - 1
    src_t, ip_t = torch.from_numpy(neigh.astype(np.int32)), torch.from_numpy(
        indptr.astype(np.int32))
    sl = _check_layout(src_t, ip_t, build_pull_slices(src_t, ip_t, np.dtype(dtype).itemsize,
                                                      256))
    assert (sl.part_ptr.diff() == sl.slice_edges.shape[0] - 1).any()  # a hub in every slice
    x = np.random.default_rng(1).random(jg.n).astype(dtype)
    want = np.asarray(j_pull_reduce("sum", j_table_gather(jnp.asarray(x), plan.heavy_neigh),
                                    plan.heavy_centers, plan.heavy_indptr, rows,
                                    jnp.zeros((), x.dtype), "scan"))
    got = pull_slices_sum_plain(sl, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=_jax_pull_atol(x, neigh))


def test_csr_pull_reduce_sum_on_the_cpu_keeps_its_plain_version():
    """On a CPU tensor the wrapper takes the plain version, slices or none,
    and the memo builds nothing there."""
    rng = np.random.default_rng(2)
    src, indptr, width = _hand("n_not_a_multiple", rng)
    x = torch.from_numpy(rng.random(1000))
    sl = build_pull_slices(src, indptr, 8, width)
    want = csr_pull_reduce_plain("sum", x, src, indptr)
    assert torch.equal(csr_pull_reduce("sum", x, src, indptr), want)
    assert torch.equal(csr_pull_reduce("sum", x, src, indptr, slices=sl), want)
    memo = {}
    assert memo_pull_slices(memo, "k", src, indptr, torch.float64) is None and not memo
    with pytest.raises(ValueError, match="takes no slices"):
        csr_pull_reduce("min_i32", None, src, indptr, slices=sl)
    with pytest.raises(ValueError, match="width"):
        build_pull_slices(src, indptr, 4, 100)
