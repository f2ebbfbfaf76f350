"""graphtpu_torch's kernel modules against the JAX package's functions, on
the CPU (where each wrapper runs its kernel's plain PyTorch version).

Inputs come from numpy with a seed and go to both packages. Integer
results must be bit-identical; float sums are held to rtol 1e-5 in
float32, because the two packages add in different orders.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graphtpu.core import semiring as jsr
from graphtpu.ops import gather as jgather
from graphtpu.ops import minmode as jmm
from graphtpu.ops import scan_reduce as jscan
from graphtpu.ops import spmv as jspmv
from graphtpu.ops.slab import build_slab_plan as j_build_slab_plan
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.core import semiring as tsr
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import gather as tgather
from graphtpu_torch.ops import kernels
from graphtpu_torch.ops import minmode as tmm
from graphtpu_torch.ops import scan_reduce as tscan
from graphtpu_torch.ops import spmv as tspmv
from graphtpu_torch.ops.pallas_gather import dma_row_gather
from graphtpu_torch.ops import slab as tslab
from graphtpu_torch.ops.slab import SlabPlan

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_plan(jplan) -> SlabPlan:
    """The port's plan from np.asarray of a JAX plan's arrays."""
    opt = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return SlabPlan.from_numpy(
        [(np.asarray(b.rows), np.asarray(b.slab), opt(b.values)) for b in jplan.slabs],
        *(opt(getattr(jplan, f)) for f in (
            "heavy_rows", "heavy_centers", "heavy_neigh", "heavy_values",
            "heavy_indptr", "rest_rows")),
        np.asarray(jplan.inv_perm), device=CPU,
    )


def _padded_slab(rng, w, r, n):
    slab = rng.integers(0, n, size=(w, r)).astype(np.int32)
    deg = rng.integers(0, w + 1, size=r)
    slab[np.arange(w)[:, None] >= deg[None, :]] = -1
    return slab


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize("idx_shape", [(777,), (33, 21)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64, np.int64])
def test_table_gather_matches_jax(dtype, idx_shape):
    rng = np.random.default_rng(1)
    x = (rng.random(1000) * 1e6).astype(dtype)
    if np.dtype(dtype).kind == "i":
        x = rng.integers(-(1 << 40), 1 << 40, size=1000).astype(dtype)
    idx = rng.integers(0, 1000, size=idx_shape).astype(np.int32)
    want = np.asarray(jgather.table_gather(jnp.asarray(x), jnp.asarray(idx)))
    got = tgather.table_gather(_t(x), _t(idx))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_dma_row_gather_matches_jax_interpret():
    from jax.experimental.pallas import tpu as pltpu
    from graphtpu.ops.pallas_gather import dma_row_gather as j_dma_row_gather

    rng = np.random.default_rng(2)
    table = rng.integers(0, 1 << 30, size=(64, 128)).astype(np.int32)
    idx = rng.integers(0, 64, size=512).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_dma_row_gather(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(dma_row_gather(_t(table), _t(idx)).numpy(), want)


def test_gather_rows_checks_its_arguments():
    x = torch.arange(10, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tgather.gather_rows(x, torch.arange(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="4- or 8-byte"):
        tgather.gather_rows(x.to(torch.int16), torch.arange(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        tgather.gather_rows(torch.zeros(10, 4)[:, 1:], torch.arange(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="128"):
        dma_row_gather(torch.zeros(10, 64), torch.arange(3, dtype=torch.int32))


def test_plain_torch_scope_restores_kernel_dispatch():
    t = torch.zeros(1)
    assert not kernels.use_kernel(t)  # a CPU tensor never launches
    with kernels.plain_torch():
        assert kernels._plain
    assert not kernels._plain


def test_kernel_library_name_tracks_sources():
    """An edited source or flag gives another library file, so a stale
    build is never loaded."""
    p = kernels.library_path()
    assert p.parent == kernels.BUILD_DIR
    assert p.name.startswith("libgraphtpu_torch_") and p.suffix == ".so"
    assert p == kernels.library_path()


# ---------------------------------------------------------------- K2


@pytest.mark.parametrize("w", [1, 7, 32, 33, 257])
def test_minmode_kernels_match_jax(w):
    rng = np.random.default_rng(w)
    n = 300
    slab = _padded_slab(rng, w, 500, n)
    labels = rng.integers(0, 25, size=n).astype(np.int32)
    jl, js = jnp.asarray(labels), jnp.asarray(slab)

    np.testing.assert_array_equal(
        tmm._slab_minmode(_t(labels), _t(slab)).numpy(),
        np.asarray(jmm._slab_minmode(jl, js)),
    )
    lab = np.where(slab >= 0, labels[np.maximum(slab, 0)], INT32_INF).astype(np.int32)
    np.testing.assert_array_equal(
        tmm._rowwise_minmode(_t(lab)).numpy(),
        np.asarray(jmm._rowwise_minmode(jnp.asarray(lab))),
    )


@pytest.mark.parametrize("directed", [True, False])
def test_iter0_kernels_match_jax(directed):
    """_iter0_mode / _iter0_minmode on one plan with buckets of widths 1,
    7, 32, 48 and 257 and a heavy tail beyond them."""
    from graphtpu.algorithms.cdlp import build_incidence

    g = j_rmat_graph(10, 16, directed=directed, seed=11)
    centers, neigh = build_incidence(g)
    deg = np.bincount(centers, minlength=g.n).astype(np.int64)
    jplan = j_build_slab_plan(centers, neigh, deg, g.n, (1, 7, 32, 48, 257))
    plan = _port_plan(jplan)
    assert [b.slab.shape[0] for b in plan.slabs] == [1, 7, 32, 48, 257]
    assert plan.heavy_rows is not None
    labels0 = np.arange(g.n, dtype=np.int32)
    for jfn, tfn in ((jmm._iter0_mode, tmm._iter0_mode),
                     (jmm._iter0_minmode, tmm._iter0_minmode)):
        np.testing.assert_array_equal(
            tfn(plan, _t(labels0)).numpy(), np.asarray(jfn(jplan, jnp.asarray(labels0)))
        )


def test_slab_minmode_tie_break():
    """Smallest label among the most frequent (LAGraph_cdlp.c:40-45)."""
    labels = torch.arange(10, dtype=torch.int32)
    slab = torch.tensor(
        [[3, 3, 5, 5, 1, -1], [7, -1, -1, -1, -1, -1], [-1, -1, -1, -1, -1, -1]],
        dtype=torch.int32,
    ).T.contiguous()
    out = tmm._slab_minmode(labels, slab)
    assert out.tolist() == [3, 7, INT32_INF]


def test_slab_minmode_checks_width_and_mode():
    with pytest.raises(ValueError, match="width"):
        tmm.slab_minmode(torch.full((4097, 2), -1, dtype=torch.int32), "min", 10)
    with pytest.raises(ValueError, match="mode"):
        tmm.slab_minmode(torch.full((4, 2), -1, dtype=torch.int32), "max", 10)


@pytest.mark.parametrize("identity", [False, True])
def test_stream_minmode_matches_jax(identity):
    rng = np.random.default_rng(5)
    h, n = 40, 200
    seg_len = rng.integers(1, 60, size=h)
    indptr = np.concatenate([[0], np.cumsum(seg_len)]).astype(np.int32)
    centers = np.repeat(np.arange(h, dtype=np.int32), seg_len)
    neigh = rng.integers(0, n // 4, size=centers.shape[0]).astype(np.int32)
    labels = rng.integers(0, 15, size=n).astype(np.int32)
    want = jmm.stream_minmode(
        None if identity else jnp.asarray(labels), jnp.asarray(centers),
        jnp.asarray(neigh), jnp.asarray(indptr), n, identity=identity,
    )
    got = tmm.stream_minmode(
        None if identity else _t(labels), _t(centers), _t(neigh), _t(indptr),
        identity=identity,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- scans


def test_seg_scans_match_jax():
    rng = np.random.default_rng(6)
    seg_len = rng.integers(0, 9, size=50)  # includes empty segments
    indptr = np.concatenate([[0], np.cumsum(seg_len)]).astype(np.int32)
    seg = np.repeat(np.arange(50, dtype=np.int32), seg_len)
    vf = (rng.random(seg.shape[0]) - 0.5).astype(np.float32)
    vi = rng.integers(-1000, 1000, size=seg.shape[0]).astype(np.int32)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    np.testing.assert_allclose(
        tscan.seg_sum_scan(_t(vf), _t(indptr)).numpy(),
        np.asarray(jscan.seg_sum_scan(j(vf), j(indptr))), rtol=1e-5, atol=1e-7,
    )
    for tf, jf, ident in ((tscan.seg_min_scan, jscan.seg_min_scan, INT32_INF),
                          (tscan.seg_max_scan, jscan.seg_max_scan, -INT32_INF)):
        np.testing.assert_array_equal(
            tf(_t(vi), _t(seg), _t(indptr), ident).numpy(),
            np.asarray(jf(j(vi), j(seg), j(indptr), jnp.int32(ident))),
        )
        np.testing.assert_array_equal(
            tf(_t(vf), _t(seg), _t(indptr), 0.0).numpy(),
            np.asarray(jf(j(vf), j(seg), j(indptr), jnp.float32(0.0))),
        )


# ---------------------------------------------------------------- K3


@pytest.mark.parametrize("buckets", [None, (2, 4)])
@pytest.mark.parametrize("sr", ["plus.second", "min.second"])
def test_slab_spmv_matches_jax(sr, buckets):
    """slab_spmv on a build_pull_plan plan; buckets=(2, 4) forces a heavy
    tail. plus sums differ in order: rtol 1e-5 at float32."""
    jg = j_rmat_graph(10, 8, directed=True, seed=3)
    tg = Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, True, False)
    jplan = jspmv.build_pull_plan(jg, buckets=buckets, with_values=False)
    plan = tspmv.build_pull_plan(tg, device=CPU, buckets=buckets, with_values=False)
    if buckets is not None:
        assert plan.heavy_rows is not None
    x = np.random.default_rng(4).random(jg.n).astype(np.float32)
    want = np.asarray(jspmv.slab_spmv(jsr.BY_NAME[sr], jplan, jnp.asarray(x), jg.n))
    got = tspmv.slab_spmv(tsr.BY_NAME[sr], plan, _t(x), jg.n).numpy()
    if sr == "plus.second":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- bucket tables


def _cdlp_like_plan(buckets, seed=21):
    """A CPU plan of a seeded RMAT incidence with a heavy tail and
    zero-degree rows, and the numpy arrays it was built from."""
    from graphtpu.algorithms.cdlp import build_incidence

    g = j_rmat_graph(9, 8, directed=False, seed=seed)
    centers, neigh = build_incidence(g)
    deg = np.bincount(centers, minlength=g.n).astype(np.int64)
    plan = tslab.build_slab_plan(centers, neigh, deg, g.n, buckets, device=CPU)
    return plan, g.n, deg


@pytest.mark.parametrize("buckets", [(2, 5, 32, 33, 60), tuple(range(1, 41, 2))])
def test_bucket_table_describes_the_plan(buckets):
    """Widths, rows and result offsets follow the plan's buckets; bucket
    rows, heavy rows and zero-degree rows fill the n results in order."""
    plan, n, deg = _cdlp_like_plan(buckets)
    table = plan.table
    assert table.widths == tuple(b.slab.shape[0] for b in plan.slabs)
    assert table.rows == tuple(b.slab.shape[1] for b in plan.slabs)
    assert table.rows == tuple(b.rows.shape[0] for b in plan.slabs)
    assert table.offsets == tuple(np.concatenate([[0], np.cumsum(table.rows)])[:-1].tolist())
    assert table.total == sum(table.rows) == int(((deg > 0) & (deg <= buckets[-1])).sum())
    heavy = 0 if plan.heavy_rows is None else plan.heavy_rows.shape[0]
    rest = 0 if plan.rest_rows is None else plan.rest_rows.shape[0]
    assert heavy > 0 and rest > 0 and table.total + heavy + rest == n
    # the result buffer in plan order, gathered by inv_perm, is vertex order
    order = torch.cat([b.rows for b in plan.slabs] + [plan.heavy_rows, plan.rest_rows])
    buf = tslab.result_buffer(plan, torch.int32)
    assert buf.shape == (n,) and buf.dtype == torch.int32
    buf[:table.total] = order[:table.total]
    got = tslab.assemble(plan, buf, plan.heavy_rows, plan.rest_rows)
    np.testing.assert_array_equal(got.numpy(), np.arange(n))


@pytest.mark.parametrize("row_major", [False, True])
def test_bucket_table_launches(row_major):
    """Descriptors: widest bucket first, at most 16 a launch, filtered by
    width, memoized; pointers are the slabs' own, or those of row-major
    copies kept with the table."""
    plan, _, _ = _cdlp_like_plan(tuple(range(1, 41)))
    table = plan.table
    nb = len(plan.slabs)
    assert 16 < nb <= 32
    launches = table.launches(row_major=row_major)
    assert [count for _, count in launches] == [16, nb - 16]
    assert table.launches(row_major=row_major) is launches
    desc = [d for arr, count in launches for d in arr[:count]]
    assert [d.width for d in desc] == sorted(table.widths, reverse=True)
    by_width = {w: k for k, w in enumerate(table.widths)}
    for d in desc:
        k = by_width[d.width]
        assert (d.rows, d.out_off, d.row_major) == (table.rows[k], table.offsets[k],
                                                    int(row_major))
        slab = plan.slabs[k].slab
        if row_major:
            copy = table._row_major[k]
            assert d.slab == copy.data_ptr()
            # a copy of its own, unless both layouts hold the same bytes
            assert (copy.data_ptr() != slab.data_ptr()) == (min(slab.shape) > 1)
            assert copy.is_contiguous() and torch.equal(copy, slab.t())
        else:
            assert d.slab == slab.data_ptr()
    narrow = table.launches(3, 7)
    assert len(narrow) == 1
    assert [d.width for d in narrow[0][0]] == sorted((w for w in table.widths if 3 <= w <= 7),
                                                     reverse=True)
    assert table.launches(1001) == []


def test_bucket_table_skips_empty_buckets():
    slabs = [torch.zeros((3, 5), dtype=torch.int32), torch.zeros((40, 0), dtype=torch.int32),
             torch.zeros((40, 7), dtype=torch.int32)]
    table = tslab.BucketTable(slabs)
    assert (table.widths, table.rows, table.offsets, table.total) == (
        (3, 40, 40), (5, 0, 7), (0, 5, 5), 12)
    (arr, count), = table.launches()
    assert count == 2 and [(d.width, d.rows, d.out_off) for d in arr] == [(40, 7, 5), (3, 5, 0)]
    assert tslab.BucketTable([]).launches() == [] and tslab.BucketTable([]).total == 0


@pytest.mark.parametrize("mode", ["gather", "identity", "min"])
def test_slab_minmode_buckets_matches_per_slab(mode):
    plan, n, _ = _cdlp_like_plan((2, 5, 32, 33, 60))
    labels = torch.from_numpy(np.random.default_rng(8).integers(0, 12, size=n).astype(np.int32))
    lab = labels if mode == "gather" else None
    buf = tslab.result_buffer(plan, torch.int32)
    buf.fill_(-7)
    tmm.slab_minmode_buckets(plan, mode, n, lab, buf)
    want = torch.cat([tmm.slab_minmode(b.slab, mode, n, lab) for b in plan.slabs])
    assert torch.equal(buf[:plan.table.total], want)
    assert (buf[plan.table.total:] == -7).all()  # heavy and rest places untouched


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_slab_spmv_buckets_match_per_slab(dtype):
    plan, n, _ = _cdlp_like_plan((2, 5, 32, 33, 60))
    rng = np.random.default_rng(9)
    buf = tslab.result_buffer(plan, dtype)
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(0, 1000, size=n).astype(np.int32))
        for xm in (x, None):
            tspmv.slab_spmv_min_buckets(plan, xm, n, buf)
            want = torch.cat([tspmv.slab_spmv_min(b.slab, xm, n) for b in plan.slabs])
            assert torch.equal(buf[:plan.table.total], want)
    else:
        x = torch.from_numpy(rng.random(n)).to(dtype)
        tspmv.slab_spmv_sum_buckets(plan, x, buf)
        want = torch.cat([tspmv.slab_spmv_sum(b.slab, x) for b in plan.slabs])
        assert torch.equal(buf[:plan.table.total], want)


def test_bucket_wrappers_check_the_result_buffer():
    plan, n, _ = _cdlp_like_plan((2, 5, 32, 33, 60))
    x = torch.zeros(n)
    with pytest.raises(TypeError, match="out"):
        tmm.slab_minmode_buckets(plan, "min", n, None, torch.zeros(n))
    with pytest.raises(ValueError, match="too short"):
        tmm.slab_minmode_buckets(plan, "min", n, None,
                                 torch.zeros(plan.table.total - 1, dtype=torch.int32))
    with pytest.raises(TypeError, match="out"):
        tspmv.slab_spmv_sum_buckets(plan, x, torch.zeros(n, dtype=torch.float64))
    with pytest.raises(ValueError, match="too short"):
        tspmv.slab_spmv_min_buckets(plan, None, n, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="results for"):
        tslab.assemble(plan, tslab.result_buffer(plan, torch.int32), None, None)


# ------------------------------------------------ K7's partition and scratch


def _k7_case(case, rng):
    """In-degrees of small graphs around the partition's corners."""
    if case == "empty_rows_at_both_ends":
        return np.array([0, 0, 0, 3, 1, 0, 4, 0, 0])
    if case == "one_row_holds_all_edges":
        return np.array([0, 0, 57, 0])
    if case == "single_row":
        return np.array([23])
    if case == "edgeless":
        return np.zeros(19, dtype=np.int64)
    if case == "long_empty_run":
        deg = np.zeros(40, dtype=np.int64)
        deg[[2, 33]] = 5, 9
        return deg
    deg = rng.integers(0, 7, size=60)
    deg[rng.random(60) < 0.4] = 0
    deg[17] = 40
    return deg


def _merged_list(indptr):
    """The merged list of row ends and edges, item by item: ('r', row) where
    a row ends, ('e', edge) for an edge; a row's end follows its last edge."""
    items = []
    for r in range(len(indptr) - 1):
        items += [("e", e) for e in range(indptr[r], indptr[r + 1])]
        items.append(("r", r))
    return items


@pytest.mark.parametrize("ipb", [1, 4, 7, 15, 1000])
@pytest.mark.parametrize("case", ["empty_rows_at_both_ends", "one_row_holds_all_edges",
                                  "single_row", "edgeless", "long_empty_run", "random"])
def test_merge_path_starts_matches_the_merged_list(case, ipb):
    """K7's partition (its plain version) against the merged list written
    out item by item: before diagonal d lie exactly starts[b] row ends and
    d - starts[b] edges, for blocks of 1 item up to more than the list."""
    rng = np.random.default_rng(ipb)
    deg = _k7_case(case, rng)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    n, m = len(deg), int(indptr[-1])
    items = _merged_list(indptr)
    assert len(items) == n + m
    starts = tspmv.merge_path_starts(_t(indptr), ipb)
    nb = -(-(n + m) // ipb)
    assert starts.dtype == torch.int32 and starts.shape == (nb + 1,)
    for b, got in enumerate(starts.tolist()):
        d = min(b * ipb, n + m)
        assert got == sum(kind == "r" for kind, _ in items[:d])
        assert d - got == sum(kind == "e" for kind, _ in items[:d])
    assert starts[0] == 0 and starts[-1] == n


@pytest.mark.parametrize("ipb", [3, 8, 15])
@pytest.mark.parametrize("case", ["empty_rows_at_both_ends", "one_row_holds_all_edges",
                                  "long_empty_run", "random"])
def test_merge_path_blocks_reduce_to_the_plain_result(case, ipb):
    """What K7 does with the partition, in numpy: each block reduces its
    edges by row, stores the rows that end in it and carries the row that
    runs past its end; carries folded into y give the plain version's
    result, identities of empty rows included."""
    rng = np.random.default_rng(ipb + len(case))
    deg = _k7_case(case, rng)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    n, m = len(deg), int(indptr[-1])
    src = rng.integers(0, n, size=m).astype(np.int32)
    x = rng.integers(-90, -1, size=n).astype(np.int32)
    starts = tspmv.merge_path_starts(_t(indptr), ipb).numpy()
    lowest = np.iinfo(np.int32).min
    y = np.full(n, 12345, dtype=np.int64)
    carries = []
    for b in range(len(starts) - 1):
        i0, i1 = int(starts[b]), int(starts[b + 1])
        j0, j1 = min(b * ipb, n + m) - i0, min((b + 1) * ipb, n + m) - i1
        assert 0 <= j0 <= j1 <= m and i0 <= i1 <= n
        acc, row = lowest, i0
        for e in range(j0, j1):
            while row < i1 and indptr[row + 1] <= e:  # rows that end before edge e
                y[row], acc, row = (0 if deg[row] == 0 else acc), lowest, row + 1
            assert indptr[row] <= e < indptr[row + 1]
            acc = max(acc, int(x[src[e]]))
        while row < i1:
            y[row], acc, row = (0 if deg[row] == 0 else acc), lowest, row + 1
        carries.append((i1, acc))
    for row, acc in carries:
        if row < n:
            y[row] = max(y[row], acc)
    want = tspmv.csr_pull_reduce_plain("max_i32", _t(x), _t(src), _t(indptr))
    np.testing.assert_array_equal(y, want.numpy())


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n,m", [(1, 0), (1, 10**6), (5000, 0), (1 << 20, 60_685_550)])
def test_csr_scratch_layout(n, m, itemsize):
    """Block starts, carry rows and carry values do not overlap, the values
    start on 8 bytes, and the items per block are the CUDA source's."""
    import re

    nb, val_off, nbytes = tspmv.csr_scratch_layout(n, m, itemsize)
    ipb = tspmv.CSR_ITEMS[itemsize]
    assert (nb - 1) * ipb < n + m <= nb * ipb
    assert val_off % 8 == 0 and val_off >= 4 * (nb + 1) + 4 * nb
    assert nbytes == val_off + itemsize * nb
    source = (kernels.CSRC_DIR / "csr_pull_reduce.cu").read_text()
    threads = int(re.search(r"#define K7_THREADS (\d+)", source).group(1))
    wide, narrow = re.search(r"sizeof\(T\) == 8 \? (\d+) : (\d+)", source).groups()
    assert tspmv.CSR_ITEMS == {4: threads * int(narrow), 8: threads * int(wide)}
