"""graphtpu_torch's GraphBLAS surface (core/spops.py, core/spgemm.py) against
the JAX package's, on the CPU.

Both packages get the same numpy inputs, made from a seed. Integer results,
and min, max, lor and pair results, must be bit-identical; plus over floats
sums in another order than JAX's, so it is held to rtol 1e-6 in float32 and
1e-12 in float64. ``masked_spgemm`` runs on the CPU through its plain
version (K11's reference), on hand-made CSRs with empty A-rows, a B-row
longer than A's longest and duplicate columns, for every semiring of
``semiring.BY_NAME`` and every value type, structural sides included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtpu.core import semiring as jsr
from graphtpu.core import spgemm as jspgemm
from graphtpu.core import spops as jspops
from graphtpu.ops.spmv import build_pull_plan as j_build_pull_plan
from graphtpu.utils.synth import rmat_graph as j_rmat_graph
from graphtpu.utils.synth import uniform_graph as j_uniform_graph

from graphtpu_torch.core import semiring as tsr
from graphtpu_torch.core import spgemm as tspgemm
from graphtpu_torch.core import spops as tspops
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.ops.spmv import build_pull_plan

DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64),
          "int32": (np.int32, torch.int32)}
RTOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_same(got: torch.Tensor, want, add: str):
    """Bit-identical, except plus over floats (another summation order)."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if add == "plus" and want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=RTOL[want.dtype], atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def _twin(jg, weighted):
    return Graph.from_arrays(jg.n, jg.src, jg.dst, jg.w if weighted else None, jg.mapping,
                             jg.directed, weighted)


# ---------------------------------------------------------------- spops


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("monoid", ["plus", "min", "max", "lor"])
def test_segment_reduce_matches_jax(monoid, dtype):
    """Unsorted ids and empty segments (which take what jax.ops.segment_*
    gives them: lor's empty segment is max's identity, not 0)."""
    ndt, _ = DTYPES[dtype]
    rng = np.random.default_rng(3)
    num = 40
    ids = rng.integers(0, num, 300).astype(np.int32)
    ids = ids[(ids % 7) != 3]  # segments 3, 10, 17, ... stay empty
    vals = (rng.integers(0, 2, ids.size) if monoid == "lor"
            else rng.random(ids.size) * 100 - 50).astype(ndt)
    want = jspops.segment_reduce(getattr(jsr, monoid.upper()), jnp.asarray(vals),
                                 jnp.asarray(ids), num, indices_are_sorted=False)
    got = tspops.segment_reduce(getattr(tsr, monoid.upper()), _t(vals), _t(ids), num,
                                indices_are_sorted=False)
    _assert_same(got, want, monoid)
    assert np.asarray(want)[3] == got[3].item()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["plus.times", "min.plus", "plus.second", "max.second",
                                  "min.first", "plus.pair", "lor.land"])
def test_spmv_matches_jax(name, dtype):
    ndt, tdt = DTYPES[dtype]
    jg = j_rmat_graph(8, 8, directed=True, weighted=True, seed=5)
    tg = _twin(jg, True)
    rng = np.random.default_rng(0)
    x = (rng.integers(0, 2, jg.n) if name == "lor.land" else rng.random(jg.n)).astype(ndt)
    jc = jg.device_pull(wdtype=ndt)
    tc = tg.device_pull("cpu", tdt)
    want = jspops.spmv(jsr.BY_NAME[name], jc.src, jc.dst, jc.w, jnp.asarray(x), jg.n)
    got = tspops.spmv(tsr.BY_NAME[name], tc.src, tc.dst, tc.w, _t(x), tg.n)
    _assert_same(got, want, tsr.BY_NAME[name].add.name)


def test_any_secondi_parents_match_jax():
    """any.secondi over the pull edges gives each vertex its smallest
    frontier in-neighbour (INT32_INF where it has none)."""
    jg = j_uniform_graph(40, 200, directed=True, seed=9)
    tg = _twin(jg, False)
    frontier = np.zeros(40, np.int32)
    frontier[[3, 7]] = 1
    inf = np.iinfo(np.int32).max
    x_idx = np.where(frontier == 1, np.arange(40, dtype=np.int32), inf).astype(np.int32)
    jc, tc = jg.device_pull(), tg.device_pull("cpu")
    want = jspops.spmv(jsr.ANY_SECONDI, jc.src, jc.dst, jc.w, jnp.asarray(x_idx), 40)
    got = tspops.spmv(tsr.ANY_SECONDI, tc.src, tc.dst, tc.w, _t(x_idx), 40)
    _assert_same(got, want, "min")
    assert (got.numpy() == inf).any() and (got.numpy() < inf).any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_assign_extract_masked_fill_match_jax(dtype):
    ndt, _ = DTYPES[dtype]
    rng = np.random.default_rng(1)
    v = (rng.random(30) * 20).astype(ndt)
    idx = np.array([2, 5, 7, 29, 0], dtype=np.int32)
    vals = (rng.random(5) * 20 + 100).astype(ndt)
    mask = np.array([True, False, True, True, False])
    for args, kw in (((vals,), {}), ((vals,), {"mask": mask}), ((ndt(7),), {}),
                     ((ndt(7),), {"mask": mask})):
        want = jspops.assign(jnp.asarray(v), jnp.asarray(idx), *map(jnp.asarray, args),
                             **{k: jnp.asarray(a) for k, a in kw.items()})
        got = tspops.assign(_t(v), _t(idx), *(_t(a) if isinstance(a, np.ndarray) else a.item()
                                              for a in args),
                            **{k: _t(a) for k, a in kw.items()})
        _assert_same(got, want, "min")
    _assert_same(tspops.extract(_t(v), _t(idx)), jspops.extract(jnp.asarray(v), jnp.asarray(idx)),
                  "min")
    upd = (rng.random(30) * 5).astype(ndt)
    m = rng.random(30) < 0.5
    _assert_same(tspops.masked_fill(_t(upd), _t(m), _t(v)),
                 jspops.masked_fill(jnp.asarray(upd), jnp.asarray(m), jnp.asarray(v)), "min")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("monoid", ["plus", "min", "max", "lor"])
def test_reduce_vector_matches_jax(monoid, dtype):
    ndt, _ = DTYPES[dtype]
    v = (np.random.default_rng(2).random(1000) * 50 - 10).astype(ndt)
    want = jspops.reduce_vector(getattr(jsr, monoid.upper()), jnp.asarray(v))
    got = tspops.reduce_vector(getattr(tsr, monoid.upper()), _t(v))
    _assert_same(got, want, monoid)


def test_degrees_and_packed_keys_match_jax():
    jg = j_rmat_graph(7, 6, directed=True, seed=4)
    for key in (jg.src, jg.dst):
        want = jspops.degrees(jnp.asarray(key.astype(np.int32)), jg.n + 3)  # 3 empty tails
        _assert_same(tspops.degrees(_t(key.astype(np.int32)), jg.n + 3), want, "plus")
    # keys outside [0, num_segments), negative ones too, are dropped as JAX drops them
    for keys, n in (([0, 2, 5, 2], 3), ([0, 2, 5, 2, -1, -7, 3], 3), ([-2, 9], 4), ([], 3)):
        key = np.asarray(keys, np.int32)
        got = tspops.degrees(_t(key), n)
        assert got.shape == (n,)
        _assert_same(got, jspops.degrees(jnp.asarray(key), n), "plus")
    want = jspops.pack_edge_keys_f64(jnp.asarray(jg.src), jnp.asarray(jg.dst), jg.n)
    _assert_same(tspops.pack_edge_keys_f64(_t(jg.src), _t(jg.dst), jg.n), want, "min")


# ---------------------------------------------------------------- spgemm


def _rand_csr(rng, degs, n_cols):
    """indptr and sorted columns with repeats (sorted, not distinct)."""
    indptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    col = np.concatenate([np.sort(rng.integers(0, n_cols, d)) for d in degs]).astype(np.int32)
    return indptr, col


def spgemm_case(seed=0):
    """(A's indptr, col; B's indptr, col; mask rows, cols) on 50 vertices:
    A's rows hold 0-12 entries (several empty), B's 0-8 but one of 45, longer
    than A's longest; repeated columns on both sides; the mask mixes random
    pairs with pairs that a product reaches."""
    rng = np.random.default_rng(seed)
    n = 50
    a_deg = rng.integers(0, 13, n)
    a_deg[[0, 9, 31]] = 0
    a_deg[5] = 6
    b_deg = rng.integers(0, 9, n)
    b_deg[17] = 45
    a_ip, a_col = _rand_csr(rng, a_deg, n)
    a_col[a_ip[5]:a_ip[6]] = 17  # a row of A whose every entry reaches B's long row
    b_ip, b_col = _rand_csr(rng, b_deg, n)
    rows = rng.integers(0, n, 300)
    cols = rng.integers(0, n, 300)
    # pairs (i, j) with j in B.row(k) for some k in A.row(i)
    reach_i = np.repeat(np.arange(n), a_deg)
    hit_rows, hit_cols = [], []
    for i, k in zip(reach_i, a_col):
        if b_ip[k + 1] > b_ip[k]:
            hit_rows.append(i)
            hit_cols.append(b_col[rng.integers(b_ip[k], b_ip[k + 1])])
    rows = np.concatenate([rows, hit_rows, [0, 9, 5, 5]]).astype(np.int64)
    cols = np.concatenate([cols, hit_cols, [3, 4, 17, int(b_col[b_ip[17]])]]).astype(np.int64)
    return (a_ip, a_col), (b_ip, b_col), rows, cols


def _values(rng, size, dtype, name):
    ndt, _ = DTYPES[dtype]
    if name == "lor.land":  # a logical semiring: values in {0, 1}
        return rng.integers(0, 2, size).astype(ndt)
    if dtype == "int32":
        return rng.integers(-9, 10, size).astype(ndt)
    return (rng.random(size) * 8 - 2).astype(ndt)


def _spgemm_both(name, a, b, rows, cols):
    """(port, JAX) results for CSR triples a, b of numpy arrays (val None =
    structural)."""
    ja = jspgemm.CSR(*(None if x is None else jnp.asarray(x) for x in a))
    jb = jspgemm.CSR(*(None if x is None else jnp.asarray(x) for x in b))
    want = jspgemm.masked_spgemm(jsr.BY_NAME[name], ja, jb, rows, cols, a_indptr_host=a[0])
    ta = tspgemm.CSR(*(None if x is None else _t(x) for x in a))
    tb = tspgemm.CSR(*(None if x is None else _t(x) for x in b))
    got = tspgemm.masked_spgemm(tsr.BY_NAME[name], ta, tb, rows, cols, a_indptr_host=a[0])
    return got, want


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(tsr.BY_NAME))
def test_masked_spgemm_matches_jax(name, dtype):
    (a_ip, a_col), (b_ip, b_col), rows, cols = spgemm_case()
    rng = np.random.default_rng(7)
    a = (a_ip, a_col, _values(rng, a_col.size, dtype, name))
    b = (b_ip, b_col, _values(rng, b_col.size, dtype, name))
    got, want = _spgemm_both(name, a, b, rows, cols)
    _assert_same(got, want, tsr.BY_NAME[name].add.name)
    ident = tsr.BY_NAME[name].add.identity(got.dtype)
    empty_a = np.isin(rows, [0, 9, 31])
    assert (got.numpy()[empty_a] == ident).all()          # empty A-rows give the identity
    assert (got.numpy() != ident).sum() > 20               # and many entries are reached
    assert got[-1].item() != ident                         # through B's long row


@pytest.mark.parametrize("structural", ["a", "b", "both"])
@pytest.mark.parametrize("name", ["plus.pair", "min.plus", "max.second", "lor.land",
                                  "plus.times"])
def test_masked_spgemm_structural_matches_jax(name, structural):
    """A side without values: its term is the other side's value (1 where
    neither has values, in float32)."""
    (a_ip, a_col), (b_ip, b_col), rows, cols = spgemm_case(1)
    rng = np.random.default_rng(8)
    a_val = None if structural in ("a", "both") else _values(rng, a_col.size, "float64", name)
    b_val = None if structural in ("b", "both") else _values(rng, b_col.size, "float64", name)
    got, want = _spgemm_both(name, (a_ip, a_col, a_val), (b_ip, b_col, b_val), rows, cols)
    _assert_same(got, want, tsr.BY_NAME[name].add.name)
    if structural == "both":
        assert got.dtype == torch.float32


def test_masked_spgemm_corner_cases_match_jax():
    """A without entries (every mask entry takes the identity), B without
    entries (the JAX package's search raises on an empty B: the port gives
    the identity), an empty mask, and the CSR of a Graph."""
    (a_ip, a_col), (b_ip, b_col), rows, cols = spgemm_case(2)
    empty_ip = np.zeros_like(a_ip)
    empty = np.zeros(0, np.int32)
    got, want = _spgemm_both("plus.pair", (empty_ip, empty, None), (b_ip, b_col, None), rows,
                             cols)
    _assert_same(got, want, "plus")
    assert not got.any()
    got = tspgemm.masked_spgemm(tsr.MIN_PLUS, tspgemm.CSR(_t(a_ip), _t(a_col), None),
                                tspgemm.CSR(_t(empty_ip), _t(empty), None), rows, cols)
    assert got.dtype == torch.float32 and bool(torch.isinf(got).all())
    got, want = _spgemm_both("min.plus", (a_ip, a_col, None), (b_ip, b_col, None),
                             rows[:0], cols[:0])
    assert got.shape == (0,) and np.asarray(want).shape == (0,)
    jg = j_uniform_graph(60, 500, directed=True, weighted=True, seed=1)
    tg = _twin(jg, True)
    jc = jspgemm.CSR.from_graph(jg, np.float64)
    tc = tspgemm.CSR.from_graph(tg, torch.float64, device="cpu")
    for x, y in zip(tc, jc):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    m = j_uniform_graph(60, 300, directed=True, seed=3)
    want = jspgemm.masked_spgemm(jsr.PLUS_TIMES, jc, jc, m.src, m.dst, a_indptr_host=jg.indptr)
    got = tspgemm.masked_spgemm(tsr.PLUS_TIMES, tc, tc, m.src, m.dst)  # indptr read from a
    _assert_same(got, want, "plus")


def test_masked_spgemm_rows_on_the_cpu_is_the_plain_version():
    """K11's wrapper on CPU tensors takes the plain version, for any
    semiring (only the card refuses one outside BY_NAME)."""
    (a_ip, a_col), (b_ip, b_col), rows, cols = spgemm_case(3)
    a = tspgemm.CSR(_t(a_ip), _t(a_col), None)
    b = tspgemm.CSR(_t(b_ip), _t(b_col), None)
    r, c = _t(rows.astype(np.int32)), _t(cols.astype(np.int32))
    got = tspgemm.masked_spgemm_rows(tsr.PLUS_PAIR, a, b, r, c)
    want = tspgemm.masked_spgemm_plain(tsr.PLUS_PAIR, a, b, rows, cols, a_indptr_host=a_ip)
    assert torch.equal(got, want)
    other = tsr.Semiring("max.pair", tsr.MAX, tsr.BY_NAME["plus.pair"].mul)
    assert tspgemm.masked_spgemm_rows(other, a, b, r, c).max().item() == 1.0


@pytest.mark.parametrize("case", ["plus.times-float64", "plus.second-float32",
                                  "min.plus-float32", "max.second-float64"])
def test_spmm_matches_jax(case):
    name, dtype = case.split("-")
    ndt, tdt = DTYPES[dtype]
    jg = j_uniform_graph(50, 400, directed=True, weighted=name != "plus.second", seed=4)
    tg = _twin(jg, jg.weighted)
    x = np.random.default_rng(0).random((jg.n, 4)).astype(ndt)
    want = jspgemm.spmm(jsr.BY_NAME[name], j_build_pull_plan(jg, wdtype=ndt), jnp.asarray(x),
                        jg.n)
    plan = build_pull_plan(tg, device="cpu", wdtype=ndt)
    got = tspgemm.spmm(tsr.BY_NAME[name], plan, _t(x), tg.n)
    _assert_same(got, want, tsr.BY_NAME[name].add.name)


# ---------------------------------------------------------------- K11's plan

_UFUNC = {"plus": np.add, "min": np.minimum, "max": np.maximum, "lor": np.maximum}


def _apply_k11_plan(plan, name, a, b, m):
    """K11's arithmetic per task of ``plan``, in numpy, for CSR triples a,
    b of numpy arrays: each task's mask columns (a table of distinct
    columns), the B rows that A.row(row) names walked once, a B entry
    counted where its column differs from the one before it in its row and
    lies in the task's window, its term reduced into its column's
    accumulator, and each mask entry given its column's value."""
    (a_ip, a_col, a_val), (b_ip, b_col, b_val) = a, b
    semiring = tsr.BY_NAME[name]
    dtype = b_val.dtype if b_val is not None else (a_val.dtype if a_val is not None
                                                   else np.dtype(np.float32))
    ident = semiring.add.identity(torch.from_numpy(np.zeros(0, dtype)).dtype)
    ufunc = _UFUNC[semiring.add.name]
    a_rows, b_rows = a_ip.size - 1, b_ip.size - 1
    b_first = np.ones(b_col.size, bool)
    b_first[1:] = b_col[1:] != b_col[:-1]
    b_first[b_ip[:-1][np.diff(b_ip) > 0]] = True
    out = np.full(m, ident, dtype)

    def run(tasks, cols, idx, windowed):
        for row, s, e, *window in tasks.numpy().astype(np.int64):
            entry_cols = cols[s:e]
            uniq, inv = np.unique(entry_cols, return_inverse=True)
            acc = np.full(uniq.size, ident, dtype)
            if 0 <= row < a_rows:
                p = np.arange(a_ip[row], a_ip[row + 1])
                p = p[(a_col[p] >= 0) & (a_col[p] < b_rows)]
                k = a_col[p]
                lens = b_ip[k + 1] - b_ip[k]
                owner = np.repeat(p, lens)
                q = np.repeat(b_ip[k], lens) + np.arange(lens.sum()) - np.repeat(
                    np.cumsum(lens) - lens, lens)
                c = b_col[q]
                sel = b_first[q] & np.isin(c, uniq)
                if windowed:
                    sel &= (c >= window[0]) & (c <= window[1])
                owner, q, c = owner[sel], q[sel], c[sel]
                if a_val is not None and b_val is not None:
                    av = torch.from_numpy(a_val[owner])
                    terms = semiring.mul(av, torch.from_numpy(b_val[q])).numpy()
                elif b_val is not None:
                    terms = b_val[q]
                elif a_val is not None:
                    terms = a_val[owner]
                else:
                    terms = np.ones(q.size, dtype)
                ufunc.at(acc, np.searchsorted(uniq, c), terms.astype(dtype))
            out[np.arange(s, e) if idx is None else idx[s:e]] = acc[inv]

    cols = plan.cols.numpy()
    idx = None if plan.idx is None else plan.idx.numpy()
    run(plan.warp_tasks, cols, idx, False)
    run(plan.block_tasks, cols, idx, False)
    run(plan.win_tasks, plan.win_cols.numpy(), plan.win_idx.numpy(), True)
    return out


def _k11_case(scale, seed):
    """(A, B, mask rows, cols) from RMAT graphs of ``scale``: A the graph's
    CSR with some rows emptied, B another graph's CSR with some columns
    doubled (duplicate B columns), the mask every stored edge of a third
    graph, shuffled (unsorted), with repeated entries, A's longest row
    holding every column and 1,100 more (longer than two windows) and its
    second longest 200 columns (a block's row)."""
    rng = np.random.default_rng(seed)
    ga = j_rmat_graph(scale, 8, directed=True, seed=seed)
    gb = j_rmat_graph(scale, 6, directed=False, seed=seed + 1)
    gm = j_rmat_graph(scale, 4, directed=True, seed=seed + 2)
    n = ga.n
    a_deg = np.diff(ga.indptr)
    keep = np.repeat(~np.isin(np.arange(n), rng.choice(n, n // 8, replace=False)), a_deg)
    a_ip = np.concatenate([[0], np.cumsum(np.bincount(ga.src[keep], minlength=n))])
    a_col = ga.dst[keep]
    times = rng.integers(1, 3, gb.dst.size)          # each B entry once or twice
    b_col = np.repeat(gb.dst, times)
    b_ip = np.concatenate([[0], np.cumsum(np.bincount(np.repeat(gb.src, times),
                                                      minlength=gb.n))])
    long_row = np.concatenate([np.arange(n), rng.integers(0, n, 1100)])
    by_deg = np.argsort(np.diff(a_ip), kind="stable")
    rows = np.concatenate([gm.src, gm.src[:50], np.full(long_row.size, by_deg[-1]),
                           np.full(200, by_deg[-2])])
    cols = np.concatenate([gm.dst, gm.dst[:50], long_row, rng.integers(0, n, 200)])
    order = rng.permutation(rows.size)
    return ((a_ip.astype(np.int32), a_col.astype(np.int32)),
            (b_ip.astype(np.int32), b_col.astype(np.int32)),
            rows[order].astype(np.int32), cols[order].astype(np.int32))


# per scale: together each add monoid, each value type, a structural product
_PLAN_CASES = {7: [("plus.times", "int32"), ("plus.pair", None)],
               8: [("min.plus", "float32"), ("lor.land", "int32")],
               9: [("max.second", "float32"), ("plus.times", "float64")]}


@pytest.mark.parametrize("small_classes", [False, True], ids=["k11-sizes", "tiny-sizes"])
@pytest.mark.parametrize("scale", [7, 8, 9])
def test_k11_plan_applied_matches_jax(scale, small_classes, monkeypatch):
    """K11's plan (row grouping of an unsorted mask, row work, warp, block
    and window tasks), applied with the kernel's per-task arithmetic on the
    CPU, gives the JAX package's masked_spgemm: duplicate mask entries each
    get the value, duplicate B columns count once, empty A-rows give the
    identity, and a row longer than a window is cut into windows. With
    ``tiny-sizes`` the class limits shrink so that every class is large."""
    if small_classes:
        monkeypatch.setattr(tspgemm, "K11_WARP_ENTRIES", 4)
        monkeypatch.setattr(tspgemm, "K11_WARP_WORK", 40)
        monkeypatch.setattr(tspgemm, "K11_WINDOW", 16)
    (a_ip, a_col), (b_ip, b_col), rows, cols = _k11_case(scale, scale)
    plan = tspgemm.plan_masked_spgemm(tspgemm.CSR(_t(a_ip), _t(a_col), None),
                                      tspgemm.CSR(_t(b_ip), _t(b_col), None), _t(rows), _t(cols))
    assert plan.idx is not None                               # the mask came unsorted
    assert plan.launches == 3 and plan.win_tasks.shape[0] >= 2
    window = tspgemm.K11_WINDOW
    assert int((plan.win_tasks[:, 2] - plan.win_tasks[:, 1]).max()) <= window
    assert int((plan.block_tasks[:, 2] - plan.block_tasks[:, 1]).max()) <= window
    assert int((plan.warp_tasks[:, 2] - plan.warp_tasks[:, 1]).max()) <= \
        tspgemm.K11_WARP_ENTRIES
    rng = np.random.default_rng(scale)
    for name, dtype in _PLAN_CASES[scale]:
        a_val = None if dtype is None else _values(rng, a_col.size, dtype, name)
        b_val = None if dtype is None else _values(rng, b_col.size, dtype, name)
        got = _apply_k11_plan(plan, name, (a_ip, a_col, a_val), (b_ip, b_col, b_val), rows.size)
        ja = jspgemm.CSR(jnp.asarray(a_ip), jnp.asarray(a_col),
                         None if a_val is None else jnp.asarray(a_val))
        jb = jspgemm.CSR(jnp.asarray(b_ip), jnp.asarray(b_col),
                         None if b_val is None else jnp.asarray(b_val))
        want = jspgemm.masked_spgemm(jsr.BY_NAME[name], ja, jb, rows, cols, a_indptr_host=a_ip)
        _assert_same(torch.from_numpy(got), want, tsr.BY_NAME[name].add.name)
        ident = tsr.BY_NAME[name].add.identity(torch.from_numpy(got).dtype)
        assert (got != ident).sum() > rows.size // 10


def test_k11_plan_grouping_and_work():
    """A mask sorted by row is used as it is (idx None), its groups starting
    where the row changes; row_work is the B entries a row-wise walk reads,
    0 outside A and for A columns outside B; rows without work are in no
    task; an empty mask has no task."""
    a_ip = np.array([0, 3, 3, 5], np.int32)
    a_col = np.array([0, 2, 9, 1, 1], np.int32)            # 9: outside B's rows
    b_ip = np.array([0, 2, 7, 8], np.int32)
    a = tspgemm.CSR(_t(a_ip), _t(a_col), None)
    b = tspgemm.CSR(_t(b_ip), _t(np.arange(8, dtype=np.int32) % 3), None)
    work = tspgemm.row_work(a, b, _t(np.array([0, 1, 2, -1, 3, 7], np.int32)))
    np.testing.assert_array_equal(work.numpy(), [2 + 1, 0, 5 + 5, 0, 0, 0])
    rows = _t(np.array([0, 0, 1, 2, 2, 2, 5], np.int32))
    cols = _t(np.array([1, 0, 0, 2, 2, 1, 0], np.int32))
    grouped = tspgemm.group_mask_rows(rows, cols)
    assert grouped[2] is None
    np.testing.assert_array_equal(grouped[3].numpy(), [0, 2, 3, 6])
    plan = tspgemm.plan_masked_spgemm(a, b, rows, cols)
    assert plan.idx is None and plan.launches == 1
    np.testing.assert_array_equal(plan.warp_tasks.numpy(), [[0, 0, 2], [2, 3, 6]])
    assert plan.block_tasks.shape == (0, 5) and plan.win_tasks.shape == (0, 5)
    empty = tspgemm.plan_masked_spgemm(a, b, rows[:0], cols[:0])
    assert empty.launches == 0 and empty.cols.shape == (0,)
    shuffled = tspgemm.group_mask_rows(rows.flip(0), cols.flip(0))
    np.testing.assert_array_equal(shuffled[0].numpy(), rows.numpy())
    np.testing.assert_array_equal(shuffled[2].numpy(),
                                  np.argsort(rows.flip(0).numpy(), kind="stable"))
    np.testing.assert_array_equal(shuffled[3].numpy(), [0, 2, 3, 6])
