"""graphtpu_torch's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is absent, without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from graphtpu_torch.ops import kernels
from graphtpu_torch.ops.edgehash import (
    K9_BIN_MIN_PROBES, EdgeHash, _hash_rows, _probe_kernel, _probe_lanes, _U32, build_edge_hash,
    build_edge_hash_device, edgehash_bin, edgehash_probe, k9_bins, probe_edge_hash,
)
from graphtpu_torch.ops.frontier import (
    frontier_expand, frontier_expand_plain, relax_min, relax_min_plain,
)
from graphtpu_torch.ops.gather import gather_rows, gather_rows_plain
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops.minmode import (
    slab_minmode, slab_minmode_buckets, slab_minmode_plain,
)
from graphtpu_torch.ops.pallas_gather import vreg_shuffle, vreg_shuffle_plain
from graphtpu_torch.ops.slab import build_slab_plan, result_buffer
from graphtpu_torch.ops.triangles import ClosingCSR, wedge_rowblock
from graphtpu_torch.ops.spmv import (
    CSR_ITEMS, CSR_MODES, _csr_pull_reduce_launch, csr_pull_reduce, csr_pull_reduce_plain,
    csr_scratch_layout, merge_path_starts, slab_spmv_min, slab_spmv_min_buckets,
    slab_spmv_min_plain, slab_spmv_sum, slab_spmv_sum_buckets, slab_spmv_sum_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _padded_slab(rng, w, r, n):
    """A [W, R] int32 slab of ids in [0, n), each column padded (-1) past
    a random degree in [0, W]."""
    slab = rng.integers(0, n, size=(w, r)).astype(np.int32)
    deg = rng.integers(0, w + 1, size=r)
    slab[np.arange(w)[:, None] >= deg[None, :]] = -1
    return slab


@pytest.mark.parametrize("cols", [None, 1, 3, 128])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.int64, torch.float64])
def test_gather_rows_matches_plain(cuda, dtype, cols):
    rng = np.random.default_rng(0)
    rows = 5000
    shape = (rows,) if cols is None else (rows, cols)
    table = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, size=shape)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, rows, size=20001).astype(np.int32))
    before = kernels.launch_counts["gather_rows"]
    got = gather_rows(table.to(cuda), idx.to(cuda)).cpu()
    assert kernels.launch_counts["gather_rows"] == before + 1
    assert torch.equal(got, gather_rows_plain(table, idx))


@pytest.mark.parametrize("mode", ["gather", "identity", "min"])
@pytest.mark.parametrize("w", [1, 2, 3, 7, 8, 16, 31, 32, 33, 64, 100, 257, 1024, 4096])
def test_slab_minmode_matches_plain(cuda, mode, w):
    rng = np.random.default_rng(w)
    n = 200  # few distinct ids and labels, so rows hold ties and repeats
    r = 3000 if w <= 257 else 300
    slab = torch.from_numpy(_padded_slab(rng, w, r, n))
    labels = torch.from_numpy(rng.integers(0, 20, size=n).astype(np.int32))
    lab = labels if mode == "gather" else None
    before = kernels.launch_counts["slab_minmode"]
    got = slab_minmode(slab.to(cuda), mode, n, None if lab is None else lab.to(cuda)).cpu()
    assert kernels.launch_counts["slab_minmode"] == before + 1
    assert torch.equal(got, slab_minmode_plain(slab, mode, n, lab))


@pytest.mark.parametrize("mode", ["gather", "identity", "min"])
@pytest.mark.parametrize("r", [1, 3, 31, 33, 2049])
@pytest.mark.parametrize("w", [33, 38, 65, 1000, 2668, 4095, 4096])
def test_slab_minmode_odd_widths_and_rows(cuda, w, r, mode):
    """Widths next to a power of two or a tiling boundary, and row counts
    that are no multiple of 4 or of a tile."""
    rng = np.random.default_rng(w * 10007 + r)
    n = 5000
    slab = torch.from_numpy(_padded_slab(rng, w, r, n))
    labels = torch.from_numpy(rng.integers(0, 40, size=n).astype(np.int32))
    lab = labels if mode == "gather" else None
    got = slab_minmode(slab.to(cuda), mode, n, None if lab is None else lab.to(cuda)).cpu()
    assert torch.equal(got, slab_minmode_plain(slab, mode, n, lab))


@pytest.mark.parametrize("case", ["all_pad", "all_equal", "all_distinct", "tie", "largest_label"])
@pytest.mark.parametrize("w", [5, 32, 38, 300, 2668, 4096])
def test_slab_minmode_hand_cases(cuda, w, case):
    """Rows of pad only give INT32_INF; rows of one label give it; rows of
    distinct labels give the smallest; of two labels tied at the top count
    the smaller wins wherever they stand; INT32_INF - 1 is a label."""
    rng = np.random.default_rng(w)
    r, n = 37, 3 * w + 10
    labels = rng.permutation(n).astype(np.int32)  # distinct labels
    slab = np.stack([rng.permutation(n)[:w] for _ in range(r)], axis=1).astype(np.int32)
    want = None
    if case == "all_pad":
        slab[:, ::2] = -1
        slab[:, 1::2] = np.where(np.arange(w)[:, None] >= np.arange(r)[None, 1::2] % w, -1,
                                 slab[:, 1::2])
    elif case == "all_equal":
        labels[:] = 77
        want = np.full(r, 77, dtype=np.int32)
    elif case == "all_distinct":
        want = labels[slab].min(axis=0)
    elif case == "tie" and w >= 5:
        # labels a < b, each twice (b first and last), every other label once
        a, b = 3, 9
        labels = (np.arange(n) + 10).astype(np.int32)
        slab = np.stack([rng.permutation(n - 4)[:w] + 4 for _ in range(r)], axis=1).astype(np.int32)
        labels[[0, 1]], labels[[2, 3]] = a, b
        slab[0], slab[w // 2], slab[w // 2 + 1], slab[w - 1] = 2, 0, 1, 3
        want = np.full(r, a, dtype=np.int32)
    elif case == "largest_label":
        labels[:] = INT32_INF - 1
        labels[0] = 5
        slab[0] = 0  # one small label against w - 1 of INT32_INF - 1
        want = np.full(r, INT32_INF - 1 if w > 2 else 5, dtype=np.int32)
    slab_t, labels_t = torch.from_numpy(slab), torch.from_numpy(labels)
    got = slab_minmode(slab_t.to(cuda), "gather", n, labels_t.to(cuda)).cpu()
    assert torch.equal(got, slab_minmode_plain(slab_t, "gather", n, labels_t))
    if want is not None:
        assert np.array_equal(got.numpy(), want)
    if case == "all_pad":
        assert (got[::2] == INT32_INF).all()


def _random_plan(rng, n, buckets, device):
    """A slab plan of a random stream whose degrees spread over (and past)
    ``buckets``, with zero-degree rows."""
    deg = rng.integers(0, buckets[-1] + 40, size=n).astype(np.int64)
    deg[rng.choice(n, size=n // 5, replace=False)] = 0
    centers = np.repeat(np.arange(n, dtype=np.int64), deg)
    neigh = rng.integers(0, n, size=centers.shape[0]).astype(np.int32)
    return build_slab_plan(centers, neigh, deg, n, buckets, device=device)


@pytest.mark.parametrize("buckets", [(3, 20, 32, 33, 100, 700), tuple(range(2, 120, 4))])
def test_bucket_table_launches_match_plain(cuda, buckets):
    """K2, K3 and K6 over all buckets of a plan at once (six buckets on
    both sides of the narrow/wide boundary; thirty, 8 narrow and 22 wide,
    more than one launch holds) against the plain versions bucket by
    bucket."""
    rng = np.random.default_rng(len(buckets))
    n = 3000
    plan = _random_plan(rng, n, buckets, cuda)
    assert len(plan.slabs) == len(buckets) and plan.heavy_rows is not None
    labels = torch.from_numpy(rng.integers(0, 30, size=n).astype(np.int32)).to(cuda)
    x = torch.from_numpy(rng.random(n)).to(cuda)
    total = plan.table.total
    narrow = sum(w <= 32 for w in buckets)
    k2_launches = -(-narrow // 16) + -(-(len(buckets) - narrow) // 16)

    def plain(fn):
        return torch.cat([fn(b.slab) for b in plan.slabs])

    for mode in ("gather", "identity", "min"):
        lab = labels if mode == "gather" else None
        buf = result_buffer(plan, torch.int32)
        before = kernels.launch_counts["slab_minmode"]
        slab_minmode_buckets(plan, mode, n, lab, buf)
        assert kernels.launch_counts["slab_minmode"] - before == k2_launches
        assert torch.equal(buf[:total], plain(lambda s: slab_minmode_plain(s, mode, n, lab)))
    for xd, rtol in ((x.float(), 1e-5), (x, 1e-12)):
        buf = result_buffer(plan, xd.dtype)
        before = kernels.launch_counts["slab_spmv_sum"]
        slab_spmv_sum_buckets(plan, xd, buf)
        assert kernels.launch_counts["slab_spmv_sum"] - before == -(-len(buckets) // 16)
        torch.testing.assert_close(buf[:total], plain(lambda s: slab_spmv_sum_plain(s, xd)),
                                   rtol=rtol, atol=0)
    for xm in (labels, None):
        buf = result_buffer(plan, torch.int32)
        slab_spmv_min_buckets(plan, xm, n, buf)
        assert torch.equal(buf[:total], plain(lambda s: slab_spmv_min_plain(s, xm, n)))


def test_slab_minmode_refuses_unsupported_width(cuda):
    slab = torch.full((4097, 4), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="width"):
        slab_minmode(slab, "min", 10)


@pytest.mark.parametrize("w", [1, 5, 32, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slab_spmv_sum_matches_plain(cuda, dtype, w):
    rng = np.random.default_rng(w)
    n = 10000
    slab = torch.from_numpy(_padded_slab(rng, w, 4000, n))
    x = torch.from_numpy(rng.random(n)).to(dtype)
    before = kernels.launch_counts["slab_spmv_sum"]
    got = slab_spmv_sum(slab.to(cuda), x.to(cuda)).cpu()
    assert kernels.launch_counts["slab_spmv_sum"] == before + 1
    # the kernel sums each row in slab order, torch in its own order
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, slab_spmv_sum_plain(slab, x), rtol=rtol, atol=0)


@pytest.mark.parametrize("shape", [(2048, 5), (6, 100003), (908, 1021), (16, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slab_spmv_sum_wide_and_narrow(cuda, dtype, shape):
    """A wide bucket of few rows (each row split over many threads), a
    narrow one of many rows, and two between; two runs give the same bits
    (the partial sums are added in a fixed order, without atomics)."""
    rng = np.random.default_rng(shape[0])
    n = 50000
    slab = torch.from_numpy(_padded_slab(rng, *shape, n))
    x = torch.from_numpy(rng.random(n)).to(dtype)
    got = slab_spmv_sum(slab.to(cuda), x.to(cuda))
    again = slab_spmv_sum(slab.to(cuda), x.to(cuda))
    assert torch.equal(got, again)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got.cpu(), slab_spmv_sum_plain(slab, x), rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_vreg_shuffle_matches_plain(cuda, dtype):
    rng = np.random.default_rng(7)
    tbl8 = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, size=(8, 128))).to(dtype)
    ind = torch.from_numpy(rng.integers(0, 8, size=(8, 128)).astype(np.int32))
    before = kernels.launch_counts["vreg_shuffle"]
    got = vreg_shuffle(tbl8.to(cuda), ind.to(cuda)).cpu()
    assert kernels.launch_counts["vreg_shuffle"] == before + 1
    assert torch.equal(got, vreg_shuffle_plain(tbl8, ind))


def test_vreg_shuffle_out_of_range_gives_zero(cuda):
    tbl8 = torch.arange(1, 8 * 128 + 1, dtype=torch.int32).reshape(8, 128)
    ind = torch.zeros(8, 128, dtype=torch.int32)
    ind[0, :3] = torch.tensor([-1, 8, 1 << 30], dtype=torch.int32)
    got = vreg_shuffle(tbl8.to(cuda), ind.to(cuda)).cpu()
    assert got[0, :3].tolist() == [0, 0, 0]
    assert torch.equal(got[1:], tbl8[0].expand(7, 128))


def _frontier(rng, n, k, count, max_deg):
    """(ids [k] ascending, padded with n; starts [k+1]; indptr_pad; neigh)
    of a random CSR whose degrees 0..max_deg leave empty rows."""
    deg = rng.integers(0, max_deg + 1, size=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    neigh = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    ids = np.full(k, n, dtype=np.int32)
    ids[:count] = np.sort(rng.choice(n, size=count, replace=False))
    lens = np.concatenate([deg, [0]])[ids]
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return [torch.from_numpy(a) for a in (ids, starts, indptr.astype(np.int32), neigh)]


@pytest.mark.parametrize("with_row_ids", [True, False])
@pytest.mark.parametrize("case", ["fits", "truncated", "empty_frontier", "all_rows_empty",
                                  "single_slot", "zero_slots", "large"])
def test_frontier_expand_matches_plain(cuda, case, with_row_ids):
    """Empty rows at the start, between and at the end, an empty frontier,
    a frontier of empty rows only, truncation, and a 2^16-row, 2^18-slot
    frontier (the adaptive CDLP tier's shape)."""
    rng = np.random.default_rng(len(case))
    n, k, count, max_deg = 500, 128, 100, 6
    if case == "empty_frontier":
        count = 0
    if case == "large":
        n, k, count, max_deg = 1 << 18, 1 << 16, 40000, 8
    ids, starts, indptr, neigh = _frontier(rng, n, k, count, max_deg)
    if case == "all_rows_empty":
        starts = torch.zeros_like(starts)
    total = int(starts[-1])
    e_cap = {"truncated": max(total // 3, 1), "single_slot": 1, "zero_slots": 0,
             "large": 1 << 18}.get(case, total + 37)
    before = kernels.launch_counts["frontier_expand"]
    got = frontier_expand(*(t.to(cuda) for t in (ids, starts, indptr, neigh)), e_cap,
                          with_row_ids)
    assert kernels.launch_counts["frontier_expand"] == before + (1 if e_cap else 0)
    want = frontier_expand_plain(ids, starts, indptr, neigh, e_cap, with_row_ids)
    for name, g, w in zip(("rows_local", "row_ids", "gpos", "neigh", "valid"), got, want):
        if w is None:
            assert g is None, name
        else:
            assert torch.equal(g.cpu(), w), name


@pytest.mark.parametrize("mode", ["gather", "identity"])
@pytest.mark.parametrize("w", [1, 2, 7, 32, 100, 1000])
def test_slab_spmv_min_matches_plain(cuda, mode, w):
    """Columns without entries, and ids past n that count as pad."""
    rng = np.random.default_rng(w)
    n = 3000
    slab = _padded_slab(rng, w, 2000, n + 50)  # ids in [n, n + 50) are pad too
    x = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, size=n).astype(np.int32))
    xm = x if mode == "gather" else None
    before = kernels.launch_counts["slab_spmv_min"]
    got = slab_spmv_min(torch.from_numpy(slab).to(cuda), None if xm is None else xm.to(cuda), n)
    assert kernels.launch_counts["slab_spmv_min"] == before + 1
    assert torch.equal(got.cpu(), slab_spmv_min_plain(torch.from_numpy(slab), xm, n))


def _pull_csr(rng, n, hub_deg):
    """(src, indptr) of a random pull CSR with empty rows and one hub
    row of ``hub_deg`` in-edges."""
    deg = rng.integers(0, 6, size=n)
    deg[rng.choice(n, size=n // 4, replace=False)] = 0
    deg[n // 2] = hub_deg
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    src = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    return [torch.from_numpy(a) for a in (src, indptr.astype(np.int32))]


@pytest.mark.parametrize("case", ["max_i32", "max_i32_negative", "min_i32", "min_i32_ids",
                                  "min_plus_f32", "min_plus_f64", "min_plus_negative"])
def test_csr_pull_reduce_matches_plain(cuda, case):
    """0/1 frontiers, labels, the stored ids, distances in both dtypes, and
    negative values, whose max stays negative: the identity fills rows
    without in-edges only."""
    rng = np.random.default_rng(len(case))
    n = 20000
    src, indptr = _pull_csr(rng, n, 100000)
    mode = case[:8] if case.startswith("min_plus") else case[:7]
    x = w = None
    if case == "max_i32":
        x = torch.from_numpy(rng.integers(0, 2, size=n).astype(np.int32))
    elif case == "max_i32_negative":
        x = torch.from_numpy(rng.integers(-1000, -1, size=n).astype(np.int32))
    elif case == "min_i32":
        x = torch.from_numpy(rng.integers(0, n, size=n).astype(np.int32))
    elif mode == "min_plus":
        dt = np.float64 if case.endswith("f64") else np.float32
        x = np.where(rng.random(n) < 0.3, np.inf, rng.random(n) * 3).astype(dt)
        w = (rng.random(src.shape[0]) + 0.01).astype(dt)
        if case.endswith("negative"):
            x, w = x - 1.5, w - 0.5
        x, w = torch.from_numpy(x), torch.from_numpy(w)
    before = kernels.launch_counts["csr_pull_reduce"]
    on = lambda t: None if t is None else t.to(cuda)  # noqa: E731
    got = csr_pull_reduce(mode, on(x), src.to(cuda), indptr.to(cuda), on(w))
    assert kernels.launch_counts["csr_pull_reduce"] == before + 1
    assert torch.equal(got.cpu(), csr_pull_reduce_plain(mode, x, src, indptr, w))


K7_COMBOS = {  # name -> (mode, dtype, x is null)
    "max_i32": ("max_i32", torch.int32, False), "min_i32": ("min_i32", torch.int32, False),
    "min_i32_ids": ("min_i32", torch.int32, True),
    "min_plus_f32": ("min_plus", torch.float32, False),
    "min_plus_f64": ("min_plus", torch.float64, False),
}


def _k7_degrees(case, ipb, rng):
    """In-degrees per row of the hand cases, for blocks of ``ipb`` items of
    the merged list of row ends and edges."""
    if case == "row_ends_on_border":
        # row 0's end is block 0's last item; row 2's last edge is block 1's
        # last item, so its end opens block 2
        return np.array([ipb - 1, 0, ipb - 2, 5, 0, 2 * ipb - 8, 3])
    if case == "empty_run":  # runs of empty rows longer than a block, at both ends and between
        deg = np.zeros(4 * ipb + 11, dtype=np.int64)
        deg[ipb + 3] = 7
        deg[ipb + 4] = 3 * ipb
        deg[3 * ipb] = 1
        return deg
    if case == "one_row":
        return np.array([1_000_000])
    if case == "hubs_only":
        return rng.integers(4097, 12000, size=1351)
    if case == "single_empty_row":
        return np.array([0])
    if case == "edgeless":
        return np.zeros(2 * ipb + 5, dtype=np.int64)
    raise ValueError(case)


def _k7_inputs(case, combo, rng, device):
    mode, dtype, x_null = K7_COMBOS[combo]
    deg = _k7_degrees(case, CSR_ITEMS[torch.empty(0, dtype=dtype).element_size()], rng)
    indptr = np.zeros(deg.shape[0] + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    m, n_x = int(indptr[-1]), 50_000
    src = torch.from_numpy(rng.integers(0, n_x, size=m).astype(np.int32))
    x = w = None
    if mode == "max_i32":  # negative values: a max over them stays negative
        x = torch.from_numpy(rng.integers(-1000, -1, size=n_x).astype(np.int32))
    elif mode == "min_i32" and not x_null:
        x = torch.from_numpy(rng.integers(0, 1 << 30, size=n_x).astype(np.int32))
    elif mode == "min_plus":  # +inf distances among the finite ones
        x = torch.from_numpy(np.where(rng.random(n_x) < 0.3, np.inf, rng.random(n_x) * 9)).to(dtype)
        w = torch.from_numpy(rng.random(m) + 0.01).to(dtype)
    on = lambda t: None if t is None else t.to(device)  # noqa: E731
    return mode, on(x), src.to(device), torch.from_numpy(indptr.astype(np.int32)).to(device), on(w)


@pytest.mark.parametrize("combo", list(K7_COMBOS))
@pytest.mark.parametrize("case", ["row_ends_on_border", "empty_run", "one_row", "hubs_only",
                                  "single_empty_row", "edgeless"])
def test_csr_pull_reduce_hand_cases(cuda, case, combo):
    """K7 in its five (mode, dtype, x) combinations on: rows that end
    exactly on a block's border; runs of empty rows longer than a block; one
    row of 10^6 edges; 1,351 rows of more than 4,096 edges each and none
    else; n = 1 with m = 0; no edge at all. Against the plain version on the
    card, bit for bit, and twice with the same bits."""
    rng = np.random.default_rng(len(case) * 31 + len(combo))
    mode, x, src, indptr, w = _k7_inputs(case, combo, rng, cuda)
    before = kernels.launch_counts["csr_pull_reduce"]
    got = csr_pull_reduce(mode, x, src, indptr, w)
    again = csr_pull_reduce(mode, x, src, indptr, w)
    assert kernels.launch_counts["csr_pull_reduce"] == before + 2
    with kernels.plain_torch():
        want = csr_pull_reduce(mode, x, src, indptr, w)
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    empty = (indptr.diff() == 0).cpu()
    identity = CSR_MODES[mode][2]
    assert bool((got.cpu()[empty] == identity).all())
    if mode == "max_i32" and not bool(empty.all()):
        assert int(got.cpu()[~empty].max()) < 0


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64])
@pytest.mark.parametrize("case", ["row_ends_on_border", "empty_run", "hubs_only", "edgeless"])
def test_csr_pull_reduce_partition_matches_plain(cuda, case, dtype):
    """The row each block starts in, as the kernel's search leaves it in the
    scratch, against the plain partition; and each block's carry row is the
    row the next block starts in."""
    rng = np.random.default_rng(len(case))
    combo = "min_i32" if dtype == torch.int32 else "min_plus_f64"
    mode, x, src, indptr, w = _k7_inputs(case, combo, rng, cuda)
    _, scratch = _csr_pull_reduce_launch(CSR_MODES[mode][0][dtype], dtype, x, src, indptr, w)
    size = torch.empty(0, dtype=dtype).element_size()
    nb, _, nbytes = csr_scratch_layout(indptr.shape[0] - 1, src.shape[0], size)
    assert scratch.shape[0] == nbytes
    ints = scratch[: 4 * (2 * nb + 1)].view(torch.int32)
    want = merge_path_starts(indptr, CSR_ITEMS[size])
    assert torch.equal(ints[: nb + 1], want)
    assert torch.equal(ints[nb + 1:], want[1:])


def test_csr_pull_reduce_refuses_a_wrong_block_size(cuda):
    """The library checks the items per block its caller sized the scratch by."""
    indptr = torch.tensor([0, 2], dtype=torch.int32, device=cuda)
    src = torch.tensor([0, 0], dtype=torch.int32, device=cuda)
    y = torch.empty(1, dtype=torch.int32, device=cuda)
    scratch = torch.empty(1024, dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        kernels.launch("csr_pull_reduce", cuda, indptr.data_ptr(), src.data_ptr(), None, None,
                       y.data_ptr(), 1, 2, 1, CSR_ITEMS[4] + 1, scratch.data_ptr(), 1024)


def _k5_frontier(deg, ids, device):
    """(ids, starts, indptr_pad, neigh) on ``device`` for rows of degrees
    ``deg`` and a frontier ``ids`` (n = pad)."""
    n = deg.shape[0]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    neigh = np.arange(int(indptr[-1]), dtype=np.int32)[::-1].copy()
    lens = np.concatenate([deg, [0]])[ids]
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (ids.astype(np.int32), starts, indptr.astype(np.int32), neigh)]


def _k5_assert_matches_plain(args, e_cap, with_row_ids):
    got = frontier_expand(*args, e_cap, with_row_ids)
    again = frontier_expand(*args, e_cap, with_row_ids)
    with kernels.plain_torch():
        want = frontier_expand(*args, e_cap, with_row_ids)
    for name, g, a, w in zip(("rows_local", "row_ids", "gpos", "neigh", "valid"), got, again,
                             want):
        if w is None:
            assert g is None, name
        else:
            assert torch.equal(g, w), name
            assert torch.equal(g, a), name


@pytest.mark.parametrize("with_row_ids", [True, False])
@pytest.mark.parametrize("e_cap", [1, 3, 1023, 1025, 1 << 22])
@pytest.mark.parametrize("frontier", ["mixed", "one_row", "all_empty", "empty_run"])
def test_frontier_expand_slot_counts_and_frontiers(cuda, frontier, e_cap, with_row_ids):
    """Slot counts around a block's 1,024 slots and BFS's top tier, for: a
    frontier of rows of degree 0..40 (cut in the middle of a row wherever
    e_cap is smaller than its edges); k = 1; a frontier without any edge;
    and two rows of edges around 3,000 empty rows, more than a block keeps
    in shared memory."""
    rng = np.random.default_rng(e_cap % 1000 + len(frontier))
    n = 200_000
    deg = rng.integers(0, 41, size=n)
    if frontier == "mixed":
        ids = np.sort(rng.choice(n, size=150_000, replace=False))
        ids = np.concatenate([ids, np.full(1 << 18, n)[: (1 << 18) - ids.shape[0]]])
    elif frontier == "one_row":
        deg[7] = 5000
        ids = np.array([7])
    elif frontier == "all_empty":
        deg[:5000] = 0
        ids = np.concatenate([np.arange(5000), np.full(100, n)])
    else:
        deg[1000:4000] = 0
        deg[999], deg[4000] = 600, 700
        ids = np.concatenate([np.arange(999, 4001), np.full(50, n)])
    _k5_assert_matches_plain(_k5_frontier(deg, ids, cuda), e_cap, with_row_ids)


def test_frontier_expand_unaligned_outputs_take_the_scalar_stores(cuda):
    """Outputs that do not start on 16 bytes (views into larger buffers):
    the library launches the variant with scalar stores."""
    rng = np.random.default_rng(3)
    deg = rng.integers(0, 9, size=5000)
    ids = np.sort(rng.choice(5000, size=700, replace=False))
    args = _k5_frontier(deg, ids, cuda)
    e_cap = 2001
    with kernels.plain_torch():
        want = frontier_expand(*args, e_cap, True)
    bufs = [torch.empty(e_cap + 1, dtype=torch.int32, device=cuda)[1:] for _ in range(4)]
    valid = torch.empty(e_cap + 1, dtype=torch.bool, device=cuda)[1:]
    kernels.launch("frontier_expand", cuda, *(t.data_ptr() for t in args[:2]), args[0].shape[0],
                   args[2].data_ptr(), args[3].data_ptr(), *(b.data_ptr() for b in bufs),
                   valid.data_ptr(), e_cap)
    for g, w in zip(bufs + [valid], want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["random", "all_pad", "equal_candidates", "negative"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_push_relax_min_matches_plain(cuda, dtype, case):
    """Random slots whose targets repeat (contended atomics), a frontier of
    pad slots only, many slots with one equal candidate, and negative
    values (the sign-aware atomic)."""
    rng = np.random.default_rng(len(case))
    n, e_cap, m = 5000, 1 << 16, 40000
    dist = torch.from_numpy(np.where(rng.random(n) < 0.4, np.inf, rng.random(n) * 5)).to(dtype)
    w = torch.from_numpy(rng.random(m) + 0.01).to(dtype)
    row_ids = torch.from_numpy(rng.integers(0, n, size=e_cap).astype(np.int32))
    neigh = torch.from_numpy(rng.integers(0, 300, size=e_cap).astype(np.int32))
    gpos = torch.from_numpy(rng.integers(0, m, size=e_cap).astype(np.int32))
    valid = torch.from_numpy(rng.random(e_cap) < 0.7)
    if case == "all_pad":
        valid[:] = False
    if case == "equal_candidates":
        row_ids[:] = 7
        dist[7] = 1.0
        gpos[:] = 3
    if case == "negative":
        dist, w = dist - 2.5, w - 0.6
    args = (dist, row_ids, neigh, gpos, valid, w)
    before = kernels.launch_counts["push_relax_min"]
    got = relax_min(*(t.to(cuda) for t in args))
    assert kernels.launch_counts["push_relax_min"] == before + 1
    want = relax_min_plain(*args)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got.cpu(), dist) == (case == "all_pad")


# ---- K9 edgehash_probe and K10 wedge_rowblock ----

ID_BITS = 20


def _pair_hash(rng, slab, present_per_row=1500, absent=2000):
    """An edge hash that holds a sample of the out-out pairs of ``slab``'s
    rows (payload 1 or 2) and random other pairs: (EdgeHash on the CPU, the
    sorted int64 keys, their payloads)."""
    keys = [rng.integers(0, 1 << ID_BITS, size=absent).astype(np.int64) << ID_BITS
            | rng.integers(0, 1 << ID_BITS, size=absent)]
    for r in range(slab.shape[1]):
        ids = slab[:, r][slab[:, r] >= 0].astype(np.int64)
        if ids.size < 2:
            continue
        take = min(present_per_row, ids.size * (ids.size - 1) // 2)
        i = rng.integers(0, ids.size - 1, size=take)
        j = rng.integers(i + 1, ids.size)
        keys.append((ids[i] << ID_BITS) | ids[j])
    keys = np.unique(np.concatenate(keys))
    payload = rng.integers(1, 3, size=keys.shape[0])
    eh, spilled = build_edge_hash(keys, payload)
    assert not spilled.any()
    return eh, keys, payload


def _closing_from_keys(keys, payload, device):
    """The closing CSR of sorted int64 pair keys (x << ID_BITS | y) over
    2^ID_BITS tails: each x's heads ascending, with their payloads."""
    x, y = keys >> ID_BITS, keys & ((1 << ID_BITS) - 1)
    indptr = np.zeros((1 << ID_BITS) + 1, dtype=np.int64)
    np.cumsum(np.bincount(x, minlength=1 << ID_BITS), out=indptr[1:])
    return ClosingCSR(*(torch.from_numpy(a).to(device) for a in (
        indptr.astype(np.int32), y.astype(np.int32), payload.astype(np.uint8))))


def _check_wedge_rowblock(slab, mslab, keys, payload, cuda, plain=True):
    """K10 on ``slab`` against the credits of its real pairs looked up in
    ``keys``, twice for the same bits, with one launch each; against its
    plain version on the card too, unless ``plain`` is False."""
    eh, spilled = build_edge_hash(keys, payload)
    assert not spilled.any()
    want_u, want_e = _credits_by_real_pairs(slab, mslab, keys, payload)
    eh_d = EdgeHash(eh.table.to(cuda), eh.rows)
    closing = _closing_from_keys(keys, payload, cuda)
    slab_d, mslab_d = torch.from_numpy(slab).to(cuda), torch.from_numpy(mslab).to(cuda)
    r = slab.shape[1]
    before = kernels.launch_counts["wedge_rowblock"]
    u, e = wedge_rowblock(slab_d, mslab_d, eh_d, ID_BITS, r, closing)
    assert kernels.launch_counts["wedge_rowblock"] == before + 1
    np.testing.assert_array_equal(u.cpu().numpy(), want_u)
    np.testing.assert_array_equal(e.cpu().numpy(), want_e)
    u2, e2 = wedge_rowblock(slab_d, mslab_d, eh_d, ID_BITS, r, closing)
    assert torch.equal(u, u2) and torch.equal(e, e2)
    if plain:
        with kernels.plain_torch():
            u_pl, e_pl = wedge_rowblock(slab_d, mslab_d, eh_d, ID_BITS, r, closing)
        assert torch.equal(u, u_pl) and torch.equal(e, e_pl)
    return want_u, want_e


def _wedge_slab(rng, w, r, full_rows):
    """[W, R] slabs of a wedge bucket: rows of ascending distinct ids,
    left-packed; ``full_rows`` rows of W entries, a few of random length,
    the rest short (and some of one entry or of pad only); multiplicities
    1 and 2."""
    slab = np.full((w, r), -1, dtype=np.int32)
    for c in range(r):
        if c < full_rows:
            d = w
        elif c < full_rows + 3:
            d = int(rng.integers(0, w + 1))
        else:
            d = int(rng.integers(0, min(w, 24) + 1))
        slab[:d, c] = np.sort(rng.choice(1 << ID_BITS, size=d, replace=False))
    mslab = np.where(slab >= 0, rng.integers(1, 3, size=slab.shape), 0).astype(np.int32)
    return slab, mslab


def _credits_by_real_pairs(slab, mslab, keys, payload):
    """The credits from each row's real pairs, looked up in the sorted keys:
    a reference that uses neither the hash nor the padded pair list."""
    w, r = slab.shape
    u = np.zeros(r, dtype=np.int64)
    e = np.zeros((w, r), dtype=np.int64)
    for c in range(r):
        d = int((slab[:, c] >= 0).sum())
        if d < 2:
            continue
        ii, jj = np.triu_indices(d, k=1)
        k = (slab[ii, c].astype(np.int64) << ID_BITS) | slab[jj, c]
        pos = np.minimum(np.searchsorted(keys, k), keys.shape[0] - 1)
        hit = keys[pos] == k
        u[c] = payload[pos][hit].sum()
        np.add.at(e[:, c], ii[hit], mslab[jj[hit], c])
        np.add.at(e[:, c], jj[hit], mslab[ii[hit], c])
    return u.astype(np.int32), e.astype(np.int32)


@pytest.mark.parametrize("p", [1, 3, 4, 5, 1000, 100003])
def test_edgehash_probe_matches_plain(cuda, p):
    """Present and absent keys, the key of all-ones halves (which must not
    match an empty slot), and probe counts around a warp's four; too few
    probes to bin, so one launch a call. The binned path, forced at
    partitions of 4 rows: a histogram, a scatter, the probe and the unbin
    launch, the bin order a permutation whose partitions do not decrease."""
    rng = np.random.default_rng(p)
    keys = np.unique(rng.integers(0, 1 << 40, size=50000, dtype=np.int64))
    payload = rng.integers(1, 4, size=keys.shape[0])
    eh, spilled = build_edge_hash(keys, payload)
    assert not spilled.any()
    probes = np.where(rng.random(p) < 0.5, rng.choice(keys, size=p),
                      rng.integers(0, 1 << 40, size=p, dtype=np.int64))
    klo = (probes & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    khi = (probes >> 32).astype(np.int32)
    klo[-1], khi[-1] = -1, -1
    klo, khi = torch.from_numpy(klo), torch.from_numpy(khi)
    want_found, want_pay = _probe_lanes(eh, klo, khi)
    assert not bool(want_found[-1])
    eh_d = EdgeHash(eh.table.to(cuda), eh.rows)
    before = kernels.launch_counts["edgehash_probe"]
    found, pay = edgehash_probe(eh_d, klo.to(cuda), khi.to(cuda))
    assert kernels.launch_counts["edgehash_probe"] == before + 1
    assert torch.equal(found.cpu(), want_found) and torch.equal(pay.cpu(), want_pay)
    # the int64 entry point, and the plain version on the card
    f64, p64 = probe_edge_hash(eh_d, torch.from_numpy(probes[:-1]).to(cuda))
    assert torch.equal(f64.cpu(), want_found[:-1]) and torch.equal(p64.cpu(), want_pay[:-1])
    with kernels.plain_torch():
        f_pl, p_pl = edgehash_probe(eh_d, klo.to(cuda), khi.to(cuda))
    assert torch.equal(f_pl.cpu(), want_found) and torch.equal(p_pl.cpu(), want_pay)
    before = kernels.launch_counts["edgehash_probe"]
    f_bin, p_bin = _probe_kernel(eh_d, klo.to(cuda), khi.to(cuda), 2)
    assert kernels.launch_counts["edgehash_probe"] == before + 4
    assert torch.equal(f_bin.cpu(), want_found) and torch.equal(p_bin.cpu(), want_pay)
    bklo, bkhi, pos, starts = edgehash_bin(eh_d, klo.to(cuda), khi.to(cuda), 2)
    pos = pos.long().cpu()
    assert torch.equal(torch.sort(pos).values, torch.arange(p))
    assert torch.equal(bklo.cpu()[pos], klo) and torch.equal(bkhi.cpu()[pos], khi)
    part = _hash_rows(bklo.cpu().long() & _U32, bkhi.cpu().long() & _U32, eh.rows) >> 2
    assert bool((part.diff() >= 0).all())
    assert torch.equal(starts.cpu().long(), torch.searchsorted(part, torch.arange(starts.numel())))


@pytest.mark.parametrize("case", ["one-row", "one-probe", "under-the-rule", "at-the-rule"])
def test_edgehash_probe_bins_at_the_size_rule(cuda, case):
    """K9 on a table of 2^17 rows: a call of K9_BIN_MIN_PROBES - 1 probes
    takes one launch, one of K9_BIN_MIN_PROBES the four of the bins; every
    probe in one row (5,000 probes, more than a probe block's chunk) and a
    single probe, binned at partitions of 64 rows. All equal the plain
    version bit for bit."""
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(0, 1 << 40, size=1 << 20, dtype=np.int64))
    payload = rng.integers(1, 4, size=keys.shape[0]).astype(np.int32)
    eh, _ = build_edge_hash_device(torch.from_numpy(keys).to(cuda),
                                   torch.from_numpy(payload).to(cuda))
    assert eh.rows == 1 << 17 and k9_bins(eh.rows, K9_BIN_MIN_PROBES)
    if case == "one-row":  # the keys stored in key 0's row, probed over and over
        h = _hash_rows(torch.from_numpy(keys & 0xFFFFFFFF), torch.from_numpy(keys >> 32),
                       eh.rows).numpy()
        probes = rng.choice(keys[h == h[0]], size=5000)
    else:
        p = {"one-probe": 1, "under-the-rule": K9_BIN_MIN_PROBES - 1,
             "at-the-rule": K9_BIN_MIN_PROBES}[case]
        probes = np.where(rng.random(p) < 0.5, rng.choice(keys, size=p),
                          rng.integers(0, 1 << 40, size=p, dtype=np.int64))
    klo = torch.from_numpy((probes & 0xFFFFFFFF).astype(np.uint32).view(np.int32)).to(cuda)
    khi = torch.from_numpy((probes >> 32).astype(np.int32)).to(cuda)
    with kernels.plain_torch():
        want = edgehash_probe(eh, klo, khi)
    before = kernels.launch_counts["edgehash_probe"]
    if case in ("one-row", "one-probe"):  # 2048 partitions of 64 rows, K9's most
        got = _probe_kernel(eh, klo, khi, 6)
        expected = 4
    else:
        got = edgehash_probe(eh, klo, khi)
        expected = 4 if case == "at-the-rule" else 1
    assert kernels.launch_counts["edgehash_probe"] == before + expected
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "one-row":
        assert bool(got[0].all())


def test_edge_hash_device_build_matches_host_build(cuda):
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 1 << 40, size=300000, dtype=np.int64))
    payload = rng.integers(1, 3, size=keys.shape[0])
    for fill in (0.25, 8.0):
        want, want_sp = build_edge_hash(keys, payload, fill=fill)
        got, got_sp = build_edge_hash_device(
            torch.from_numpy(keys).to(cuda), torch.from_numpy(payload.astype(np.int32)).to(cuda),
            fill=fill)
        assert got.rows == want.rows and torch.equal(got.table.cpu(), want.table)
        np.testing.assert_array_equal(got_sp, want_sp)
        assert want_sp.any() == (fill == 8.0)


@pytest.mark.parametrize("r", [1, 127, 2049])
@pytest.mark.parametrize("w", [2, 3, 33, 625, 4096])
def test_wedge_rowblock_matches_plain(cuda, w, r):
    """K10 over bucket widths on both sides of the row split (W above and
    below a block's items) and row counts that are no multiple of a block's
    rows: rows of W entries, of one entry and of pad only, multiplicities 1
    and 2, present and absent pairs, the closing CSR built from the hash's
    keys. Held against the credits of the real pairs and, where the padded
    pair list is small enough, against the plain version on the card;
    twice for the same bits."""
    rng = np.random.default_rng(w * 10007 + r)
    slab, mslab = _wedge_slab(rng, w, r, full_rows=1 if w > 128 else min(r, 5))
    if r > 2:
        slab[:, 1], mslab[:, 1] = -1, 0                       # a row of pad only
        slab[1:, 2], mslab[1:, 2] = -1, 0                     # a row of one entry
    _, keys, payload = _pair_hash(rng, slab)
    want_u, want_e = _check_wedge_rowblock(slab, mslab, keys, payload, cuda,
                                           plain=w * (w - 1) // 2 * r <= 1 << 26)
    assert want_u.any() and want_e.any()


def test_wedge_rowblock_all_pad_and_width_one(cuda):
    rng = np.random.default_rng(3)
    slab, mslab = _wedge_slab(rng, 8, 40, full_rows=4)
    eh, keys, payload = _pair_hash(rng, slab)
    eh_d = EdgeHash(eh.table.to(cuda), eh.rows)
    closing = _closing_from_keys(keys, payload, cuda)
    pad = torch.full((8, 40), -1, dtype=torch.int32, device=cuda)
    u, e = wedge_rowblock(pad, torch.zeros_like(pad), eh_d, ID_BITS, 40, closing)
    assert not u.any() and not e.any()
    one = torch.from_numpy(slab[:1]).to(cuda)  # W = 1: no pair, no launch
    before = kernels.launch_counts["wedge_rowblock"]
    u, e = wedge_rowblock(one, torch.ones_like(one), eh_d, ID_BITS, 40, closing)
    assert kernels.launch_counts["wedge_rowblock"] == before
    assert not u.any() and not e.any()


@pytest.mark.parametrize("w", [40, 1500])
def test_wedge_rowblock_long_out_list(cuda, w):
    """An out(x) of 20,000 heads, far longer than a warp's pieces in
    flight and than a block's items, holding every other later entry of the
    rows whose first entry is x, and lists of other lengths beside it."""
    rng = np.random.default_rng(w)
    slab, mslab = _wedge_slab(rng, w, 600, full_rows=3)
    x = int(slab[0, 0])
    slab[0, :] = np.where(slab[0, :] >= 0, x, -1)             # x leads every row
    rest = np.arange(x + 1, 1 << ID_BITS)
    for c in range(slab.shape[1]):                             # rows stay ascending, distinct
        d = int((slab[:, c] >= 0).sum())
        if d:
            slab[1:d, c] = np.sort(rng.choice(rest, size=d - 1, replace=False))
    later = np.unique(slab[1:][slab[1:] >= 0])[::2].astype(np.int64)
    heads = np.union1d(later, rng.choice(rest, size=20000, replace=False))
    _, keys, _ = _pair_hash(rng, slab)
    keys = np.union1d(keys, (np.int64(x) << ID_BITS) | heads)
    assert (keys >> ID_BITS == x).sum() >= 20000
    payload = rng.integers(1, 3, size=keys.shape[0])
    want_u, _ = _check_wedge_rowblock(slab, mslab, keys, payload, cuda, plain=w < 1000)
    assert want_u.any()


def test_wedge_rowblock_no_later_entry_closes(cuda):
    """Every id of the slab has an out-list of 40 heads, none of them in the
    slab, so no later entry of the first 200 rows is in out(x) of an
    earlier one: those rows get no credit, beside 100 rows that close."""
    rng = np.random.default_rng(11)
    slab, mslab = _wedge_slab(rng, 24, 300, full_rows=20)
    ids = np.unique(slab[slab >= 0]).astype(np.int64)
    outside = np.setdiff1d(np.arange(1 << ID_BITS), ids)
    keys = (ids[:, None] << ID_BITS) | rng.choice(outside, size=(ids.shape[0], 40))
    _, own, _ = _pair_hash(rng, slab[:, 200:], absent=10)
    keys = np.unique(np.concatenate([keys.reshape(-1), own]))
    payload = rng.integers(1, 3, size=keys.shape[0])
    want_u, want_e = _check_wedge_rowblock(slab, mslab, keys, payload, cuda)
    assert not want_u[:200].any() and not want_e[:, :200].any()
    assert want_u[200:].any()


def test_wedge_rowblock_forced_spill_plan(cuda, monkeypatch):
    """A wedge plan on the card whose hash spilled: the closing CSR leaves
    the spilled keys out, so kernel = plain bucket by bucket, and the
    numerators (host patch included) = the sweep's."""
    from graphtpu_torch.algorithms.lcc import lcc_sweep_numerator
    from graphtpu_torch.ops import edgehash, triangles
    from graphtpu_torch.utils.synth import rmat_graph

    g = rmat_graph(11, 12, directed=False, seed=2)
    orig = edgehash.build_edge_hash_device
    monkeypatch.setattr(edgehash, "build_edge_hash_device",
                        lambda k, p, fill=0.25: orig(k, p, fill=64.0))
    plan = triangles.prepare_wedge_plan(g, device=cuda)
    assert plan.spilled.any()
    for b in plan.buckets:
        args = (b.slab, b.mslab, plan.ehash, plan.id_bits, b.chunk_cols, plan.closing)
        got, again = wedge_rowblock(*args), wedge_rowblock(*args)
        with kernels.plain_torch():
            want = wedge_rowblock(*args)
        for a, a2, c in zip(got, again, want):
            assert torch.equal(a, c) and torch.equal(a, a2)
    np.testing.assert_array_equal(triangles.lcc_oriented_numerator(plan),
                                  lcc_sweep_numerator(g, "cpu")[0])


def test_wedge_rowblock_real_plan_twice_same_bits(cuda):
    """Every bucket of an RMAT graph's plan on the card: two kernel runs
    give the same bits, and those of the plain version."""
    from graphtpu_torch.ops import triangles
    from graphtpu_torch.utils.synth import rmat_graph

    plan = triangles.prepare_wedge_plan(rmat_graph(13, 16, directed=False, seed=5), device=cuda)
    assert len(plan.buckets) > 4
    for b in plan.buckets:
        args = (b.slab, b.mslab, plan.ehash, plan.id_bits, b.chunk_cols, plan.closing)
        got, again = wedge_rowblock(*args), wedge_rowblock(*args)
        with kernels.plain_torch():
            want = wedge_rowblock(*args)
        for a, a2, c in zip(got, again, want):
            assert torch.equal(a, a2) and torch.equal(a, c)


@pytest.mark.parametrize("directed", [True, False])
def test_lcc_oriented_on_the_card_matches_sweep_and_cpu(cuda, directed):
    from graphtpu_torch.algorithms.common import run_algorithm
    from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    g = rmat_graph(11, 12, directed=directed, seed=4)
    runs = {(dev, impl): run_algorithm("lcc", g, AlgorithmParams(),
                                       PlatformConfig(device=dev, lcc_impl=impl)).values
            for dev in ("cuda", "cpu") for impl in ("oriented", "sweep")}
    for got in runs.values():
        np.testing.assert_array_equal(got, runs["cpu", "sweep"])
    assert runs["cpu", "sweep"].max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["random", "row_ends_on_border", "empty_run", "one_row",
                                  "hubs_only", "single_empty_row", "edgeless"])
def test_csr_pull_reduce_sum_matches_plain(cuda, case, dtype):
    """K7 in mode sum (PageRank's scan arm) on a random CSR with empty rows
    and a hub of 10^5 edges split over many blocks, and on the hand cases:
    within 1e-5 relative of the plain version's float64 row sums in float32
    (1e-12 in float64), twice with the same bits, counted as
    csr_pull_reduce_sum."""
    rng = np.random.default_rng(len(case) * 7 + dtype.itemsize)
    if case == "random":
        src, indptr = _pull_csr(rng, 20000, 100000)
        n_x = 20000
    else:
        deg = _k7_degrees(case, CSR_ITEMS[dtype.itemsize], rng)
        ip = np.zeros(deg.shape[0] + 1, dtype=np.int64)
        np.cumsum(deg, out=ip[1:])
        n_x = 50_000
        src = torch.from_numpy(rng.integers(0, n_x, size=int(ip[-1])).astype(np.int32))
        indptr = torch.from_numpy(ip.astype(np.int32))
    x = torch.from_numpy(rng.random(n_x)).to(dtype).to(cuda)
    src, indptr = src.to(cuda), indptr.to(cuda)
    before = dict(kernels.launch_counts)
    got = csr_pull_reduce("sum", x, src, indptr)
    again = csr_pull_reduce("sum", x, src, indptr)
    launched = indptr.shape[0] > 1
    sums = kernels.launch_counts["csr_pull_reduce_sum"] - before["csr_pull_reduce_sum"]
    assert sums == 2 * launched
    assert kernels.launch_counts["csr_pull_reduce"] == before["csr_pull_reduce"]
    want = csr_pull_reduce_plain("sum", x, src, indptr)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, again)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    assert bool(((got.double() - want.double()).abs() <= rtol * want.double().abs()).all())
    assert bool((got[(indptr.diff() == 0)] == 0).all())


def test_csr_pull_reduce_sum_refuses_a_null_x(cuda):
    """Mode sum gathers x: the library refuses a null x even without edges."""
    indptr = torch.zeros(2, dtype=torch.int32, device=cuda)
    y = torch.empty(1, dtype=torch.float32, device=cuda)
    scratch = torch.empty(1024, dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        kernels.launch("csr_pull_reduce", cuda, indptr.data_ptr(), None, None, None,
                       y.data_ptr(), 1, 0, 4, CSR_ITEMS[4], scratch.data_ptr(), 1024)


@pytest.mark.parametrize("directed", [True, False])
def test_pr_scan_on_the_card_matches_slab_and_cpu(cuda, directed):
    """pr-impl=scan launches K7 sum once an iteration; its ranks are within
    1e-4 of the slab arm's on the card and 1e-5 of its own on the CPU."""
    from graphtpu_torch.algorithms.common import run_algorithm
    from graphtpu_torch.entry import entry
    from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    g = rmat_graph(14, 16, directed=directed, seed=5)
    params = AlgorithmParams(damping_factor=0.85, num_iterations=20)
    before = kernels.launch_counts["csr_pull_reduce_sum"]
    scan = run_algorithm("pr", g, params, PlatformConfig(device="cuda", pr_impl="scan")).values
    assert kernels.launch_counts["csr_pull_reduce_sum"] == before + 20
    slab = run_algorithm("pr", g, params, PlatformConfig(device="cuda")).values
    cpu = run_algorithm("pr", g, params, PlatformConfig(device="cpu", pr_impl="scan")).values
    assert np.max(np.abs(scan - slab) / slab) <= 1e-4
    np.testing.assert_allclose(scan, cpu, rtol=1e-5, atol=0)
    step, args = entry()
    cpu_step, cpu_args = entry("cpu")
    np.testing.assert_allclose(step(*args).cpu().numpy(), cpu_step(*cpu_args).numpy(),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("prim_src", [True, False])
@pytest.mark.parametrize("dedup", [True, False])
def test_device_sort_on_the_card_matches_cpu(cuda, monkeypatch, prim_src, dedup):
    """The device ingest sort: the kernel on the card gives the CPU run's
    sort, positions and keep mask; _device_sort_edges gives the host
    lexsort's (src, dst, w) and records its three times; a Graph built
    with a card visible sorts there."""
    from graphtpu_torch.core import graph as G

    rng = np.random.default_rng(12)
    n, m = 5000, 300_000
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    src[m // 2:m // 2 + 500], dst[m // 2:m // 2 + 500] = src[:500], dst[:500]
    w = rng.random(m)
    got = G._device_sort_kernel(src, dst, prim_src, dedup, True, cuda)
    want = G._device_sort_kernel(src, dst, prim_src, dedup, True, "cpu")
    for a, b in zip(got, want):
        assert a.is_cuda and torch.equal(a.cpu(), b)

    primary = "src" if prim_src else "dst"
    monkeypatch.setattr(G, "DEVICE_SORT_MIN", 1)
    s, d, ws = G._device_sort_edges(src, dst, w, primary, dedup)
    perm = G._lexsort_edges(src, dst, primary)
    keep = np.ones(m, dtype=bool)
    if dedup:
        keep[1:] = (src[perm][1:] != src[perm][:-1]) | (dst[perm][1:] != dst[perm][:-1])
    for a, b in zip((s, d, ws), (src[perm][keep], dst[perm][keep], w[perm][keep])):
        assert np.array_equal(a, b)
    assert set(G.last_device_sort) == {"h2d_s", "sort_s", "d2h_s"}
    if prim_src and dedup:
        G.last_device_sort.clear()
        g = G.Graph(n, src, dst, w, np.arange(n), directed=True, weighted=True)
        assert set(G.last_device_sort) == {"h2d_s", "sort_s", "d2h_s"}
        assert np.array_equal(g.src, s) and np.array_equal(g.dst, d) and np.array_equal(g.w, ws)


def _spgemm_inputs(seed, n=300):
    """(A's indptr, col; B's indptr, col; mask rows, cols) as numpy: A's
    rows hold 0-40 sorted columns with repeats (some rows empty), B's 0-24
    but one of 700, longer than A's longest; the mask, in no order, mixes
    random pairs with pairs that a product reaches, columns outside B's
    (negative and past n), and row 5 with every column and 1,200 more,
    longer than K11's shared-memory table holds (column windows); row 3
    reaches B's long row (a block's row)."""
    rng = np.random.default_rng(seed)
    a_deg = rng.integers(0, 41, n)
    a_deg[::17] = 0
    b_deg = rng.integers(0, 25, n)
    b_deg[7] = 700

    def csr(deg):
        ip = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        return ip, np.concatenate([np.sort(rng.integers(0, n, d)) for d in deg]).astype(np.int32)

    (a_ip, a_col), (b_ip, b_col) = csr(a_deg), csr(b_deg)
    a_col[a_ip[3]:a_ip[4]] = 7
    rows = np.concatenate([rng.integers(0, n, 4000), np.repeat(np.arange(n), a_deg)])
    ks = a_col.astype(np.int64)
    reach = b_ip[ks] + (rng.random(ks.size) * np.maximum(b_ip[ks + 1] - b_ip[ks], 1)).astype(int)
    cols = np.concatenate([rng.integers(0, n, 4000), b_col[np.minimum(reach, b_col.size - 1)]])
    long_row = np.concatenate([np.arange(n), rng.integers(0, n, 1200)])
    rows = np.concatenate([rows, np.full(long_row.size, 5), rng.integers(0, n, 3)])
    cols = np.concatenate([cols, long_row, [-5, n + 10, 1 << 30]])
    order = rng.permutation(rows.size)
    return (a_ip, a_col), (b_ip, b_col), rows[order].astype(np.int32), cols[order].astype(np.int32)


def _spgemm_values(rng, size, dtype, name):
    if name == "lor.land":  # a logical semiring: values in {0, 1}
        return torch.from_numpy(rng.integers(0, 2, size)).to(dtype)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-9, 10, size)).to(dtype)
    # one sign, so that a float sum's relative error is bounded (no cancellation)
    return torch.from_numpy(rng.random(size) * 4 + 0.5).to(dtype)


@pytest.mark.parametrize("values", ["float32", "float64", "int32", "structural-a",
                                    "structural-b", "structural"])
@pytest.mark.parametrize("name", ["plus.times", "min.plus", "max.second", "lor.land",
                                  "plus.pair", "min.first", "any.secondi", "plus.second",
                                  "min.second"])
def test_masked_spgemm_matches_plain(cuda, name, values):
    """K11 against its plain version (the JAX package's bucketed slab) on
    the card and on the CPU: bit-identical, but plus over floats, which sums
    up to 40 terms of one sign in another order: rtol 1e-5 in float32 (40 x
    2^-24 = 2.4e-6 at worst) and 1e-12 in float64. Two calls give equal
    results, float plus too. The mask comes in no order and its plan holds
    all three task lists (warp rows, block rows, column windows of a row
    longer than the table): three launches a call."""
    from graphtpu_torch.core.semiring import BY_NAME
    from graphtpu_torch.core.spgemm import (
        CSR, masked_spgemm, masked_spgemm_rows, plan_masked_spgemm,
    )

    (a_ip, a_col), (b_ip, b_col), rows, cols = _spgemm_inputs(len(name) + len(values))
    rng = np.random.default_rng(5)
    dtype = getattr(torch, values) if not values.startswith("structural") else torch.float64
    a_val = None if values in ("structural-a", "structural") else \
        _spgemm_values(rng, a_col.size, dtype, name)
    b_val = None if values in ("structural-b", "structural") else \
        _spgemm_values(rng, b_col.size, dtype, name)
    t = torch.from_numpy
    a_cpu, b_cpu = CSR(t(a_ip), t(a_col), a_val), CSR(t(b_ip), t(b_col), b_val)
    a, b = (CSR(*(None if x is None else x.to(cuda) for x in c)) for c in (a_cpu, b_cpu))
    semiring = BY_NAME[name]
    plan = plan_masked_spgemm(a, b, t(rows).to(cuda), t(cols).to(cuda))
    assert plan.idx is not None and plan.launches == 3
    before = kernels.launch_counts["masked_spgemm"]
    got = masked_spgemm_rows(semiring, a, b, t(rows).to(cuda), t(cols).to(cuda))
    again = masked_spgemm(semiring, a, b, rows, cols)
    assert kernels.launch_counts["masked_spgemm"] == before + 2 * plan.launches
    with kernels.plain_torch():
        want = masked_spgemm(semiring, a, b, rows, cols)
    cpu = masked_spgemm(semiring, a_cpu, b_cpu, rows, cols)
    assert torch.equal(got, again)
    assert got.dtype == want.dtype == cpu.dtype and got.shape == (rows.size,)
    for x, y in ((got, want), (got, cpu)):  # the plain version on the card and on the CPU
        if semiring.add.name == "plus" and got.dtype.is_floating_point:
            rtol = 1e-5 if got.dtype == torch.float32 else 1e-12
            np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=rtol, atol=0)
        else:
            assert torch.equal(x.cpu(), y.cpu())
    ident = semiring.add.identity(got.dtype)
    empty_a = torch.from_numpy(np.isin(rows, np.flatnonzero(np.diff(a_ip) == 0)))
    assert bool(empty_a.any()) and bool((got.cpu()[empty_a] == ident).all())
    assert int((got.cpu() != ident).sum()) > 1000


def test_masked_spgemm_plan_reads_the_card_twice(cuda):
    """A K11 call reads the card twice where the mask comes in row order
    (the order check with the count of rows, then the task lists' sizes)
    and once more where it comes out of order; its windows add no read.
    Counted: the synchronizing calls made from the package's own lines."""
    import warnings

    from graphtpu_torch.core.semiring import PLUS_TIMES
    from graphtpu_torch.core.spgemm import CSR, masked_spgemm_rows, plan_masked_spgemm

    (a_ip, a_col), (b_ip, b_col), rows, cols = _spgemm_inputs(1)
    d = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    a = CSR(d(a_ip), d(a_col), torch.ones(a_col.size, device=cuda))
    b = CSR(d(b_ip), d(b_col), torch.ones(b_col.size, device=cuda))
    order = np.argsort(rows, kind="stable")
    r, c = d(rows[order]), d(cols[order])
    assert plan_masked_spgemm(a, b, r, c).launches == 3

    def reads(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return [f"{w.filename}:{w.lineno}" for w in seen
                if "synchroniz" in str(w.message) and "graphtpu_torch" in w.filename]

    got = reads(lambda: masked_spgemm_rows(PLUS_TIMES, a, b, r, c))
    assert len(got) == 2, got
    got = reads(lambda: masked_spgemm_rows(PLUS_TIMES, a, b, d(rows), d(cols)))
    assert len(got) == 3, got


def test_masked_spgemm_refusals_and_empty_mask(cuda):
    """On the card K11 refuses a semiring outside BY_NAME and values of two
    dtypes; an empty mask launches nothing; an index outside the CSRs
    matches nothing."""
    from graphtpu_torch.core import semiring as sr
    from graphtpu_torch.core.spgemm import CSR, masked_spgemm_rows

    (a_ip, a_col), (b_ip, b_col), rows, cols = _spgemm_inputs(0, n=50)
    d = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    a = CSR(d(a_ip), d(a_col), None)
    b = CSR(d(b_ip), d(b_col), None)
    r, c = d(rows), d(cols)
    other = sr.Semiring("max.pair", sr.MAX, sr.PLUS_PAIR.mul)
    with pytest.raises(ValueError, match="BY_NAME"):
        masked_spgemm_rows(other, a, b, r, c)
    mixed_a = CSR(a.indptr, a.col, torch.ones(a_col.size, device=cuda))
    mixed_b = CSR(b.indptr, b.col, torch.ones(b_col.size, device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError, match="one dtype"):
        masked_spgemm_rows(sr.PLUS_TIMES, mixed_a, mixed_b, r, c)
    before = kernels.launch_counts["masked_spgemm"]
    out = masked_spgemm_rows(sr.PLUS_PAIR, a, b, r[:0], c[:0])
    assert out.shape == (0,) and kernels.launch_counts["masked_spgemm"] == before
    # a mask row outside A, or a column of A outside B's rows, matches nothing
    far = torch.tensor([-1, 50, 1 << 30], dtype=torch.int32, device=cuda)
    assert not masked_spgemm_rows(sr.PLUS_PAIR, a, b, far, far).any()
    # ... also among rows inside, in every task list: the others keep their values
    mixed_r, mixed_c = torch.cat([r, far, far.flip(0)]), torch.cat([c, c[:3], c[:3]])
    got = masked_spgemm_rows(sr.PLUS_PAIR, a, b, mixed_r, mixed_c)
    assert torch.equal(got[:r.numel()], masked_spgemm_rows(sr.PLUS_PAIR, a, b, r, c))
    assert not got[r.numel():].any()
    outside = CSR(a.indptr, torch.full_like(a.col, 1 << 20), None)
    assert not masked_spgemm_rows(sr.PLUS_PAIR, outside, b, r, c).any()
    assert masked_spgemm_rows(sr.PLUS_PAIR, a, b, r, c).any()


@pytest.mark.parametrize("threshold", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("directed", [True, False])
def test_hybrids_on_the_card_match_cpu(cuda, directed, threshold):
    """bfs-impl=hybrid and sssp-impl=hybrid on the card: the CPU run's
    levels, distances and iteration counts, with K7 launched for the dense
    levels and rounds (none at threshold 1.0, where all run on the host)."""
    from graphtpu_torch.algorithms.bfs import bfs_hybrid_run
    from graphtpu_torch.algorithms.sssp import sssp_hybrid_run
    from graphtpu_torch.utils.config import PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    g = rmat_graph(13, 16, directed=directed, weighted=True, seed=6)
    over = dict(bfs_active_threshold=threshold, sssp_active_threshold=threshold)
    kernels.reset_launch_counts()
    got = (bfs_hybrid_run(g, 0, PlatformConfig(device=str(cuda), **over)),
           sssp_hybrid_run(g, 0, PlatformConfig(device=str(cuda), **over)))
    k7 = kernels.launch_counts["csr_pull_reduce"]
    want = (bfs_hybrid_run(g, 0, PlatformConfig(device="cpu", **over)),
            sssp_hybrid_run(g, 0, PlatformConfig(device="cpu", **over)))
    for (gv, gn), (wv, wn) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        assert gn == wn
    assert (k7 > 0) == (threshold < 1.0), k7


BENCH_COUNTS = ("cdlp_iters", "cdlp_full_steps", "cdlp_active_steps", "bfs_iters",
                "bfs_phase_steps", "wcc_iters", "wcc_full_steps", "wcc_active_steps",
                "sssp_rounds", "sssp_full_steps", "sssp_active_steps", "lcc_nonzero",
                "lcc_padded_probes", "ingest_rows", "n", "nnz_stored")


def test_bench_on_the_card_matches_its_cpu_counts(cuda, tmp_path, monkeypatch):
    """graphtpu_torch.bench at RMAT scale 12 on the card: backend cuda and the
    card's name, no error and only first rungs, every share in (0, 100], a
    CUDA-event span and a peak per section; its counts equal the same
    bench's on the CPU."""
    from graphtpu_torch import bench

    env = {"GRAPHTPU_BENCH_SCALE": "12", "GRAPHTPU_BENCH_EDGE_FACTOR": "16",
           "GRAPHTPU_BENCH_SSSP_SCALE": "12", "GRAPHTPU_BENCH_SSSP_EF": "8",
           "GRAPHTPU_BENCH_REPS": "2", "GRAPHTPU_BENCH_CACHE": str(tmp_path)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    runs = {}
    for platform in ("cuda", "cpu"):
        monkeypatch.setenv("GRAPHTPU_BENCH_PLATFORM", platform)
        runs[platform] = bench.run_bench()["details"]
    d = runs["cuda"]
    assert d["backend"] == "cuda" and d["card"] == torch.cuda.get_device_name(0)
    assert d["power_limit"].endswith("W")
    assert not [k for k in d if k.endswith(("_error", "_errors"))]
    assert (d["wcc_impl_used"], d["sssp_impl_used"], d["lcc_impl_used"],
            d["ingest_impl_used"]) == ("auto:slab-adaptive", "adaptive", "wedge", "text")
    for k in ("cdlp_sol_pct", "pr_sol_pct", "bfs_sol_pct_volume", "wcc_sol_pct",
              "sssp_sol_pct"):
        assert 0 < d[k] <= 100, k
    for p in ("cdlp_s", "pr_s", "bfs_s", "wcc_s", "sssp_s", "lcc_s", "ingest_s"):
        assert d[f"{p}_event_s"] > 0 and d[f"{p}_min"] <= d[p] <= d[f"{p}_max"], p
    for s in ("cdlp", "pr", "bfs", "wcc", "sssp", "lcc"):
        assert d[f"{s}_peak_device_bytes"] > 0, s
    # the native fused relabel sorts on the host: the section allocates nothing there
    assert d["ingest_peak_device_bytes"] >= 0
    assert {k: d[k] for k in BENCH_COUNTS} == {k: runs["cpu"][k] for k in BENCH_COUNTS}


@pytest.mark.parametrize("algo", ["pr", "bfs", "sssp", "wcc", "cdlp", "lcc"])
def test_naive_distributed_kernels_on_one_nccl_rank(cuda, algo):
    """Each naive distributed kernel over a one-rank NCCL group, through
    try_run_distributed with num-devices 1, against run_algorithm's
    one-device impl of the same loop on the card: bit for bit (PageRank
    within 1e-4 relative), with the kernels its shard routes to launched."""
    from graphtpu_torch.algorithms.common import run_algorithm
    from graphtpu_torch.parallel import dispatch
    from graphtpu_torch.parallel.mesh import current_mesh, make_mesh
    from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    runs = {"pr": ("segment", "scan", "csr_pull_reduce_sum"),
            "bfs": ("dense", "device", "csr_pull_reduce"),
            "sssp": ("dense", "device", "csr_pull_reduce"),
            "wcc": ("dense", "device", "csr_pull_reduce"),
            "cdlp": ("sort", "sort", "gather_rows"), "lcc": ("sweep", "sweep", "gather_rows")}
    dist_impl, one_impl, kernel = runs[algo]
    g = rmat_graph(12, 16, directed=True, weighted=algo == "sssp", seed=5)
    params = AlgorithmParams(source_vertex=0, damping_factor=0.85, num_iterations=10,
                             max_iterations=10)
    mesh = make_mesh(1, "cuda")
    assert (mesh.size, mesh.backend) == (1, "nccl")
    kernels.reset_launch_counts()
    res = dispatch.try_run_distributed(algo, g, params, PlatformConfig(
        device="cuda", num_devices=1, **{f"{algo}_impl": dist_impl}))
    assert kernels.launch_counts[kernel] > 0
    one = run_algorithm(algo, g, params, PlatformConfig(device="cuda",
                                                        **{f"{algo}_impl": one_impl}))
    assert res.iterations == one.iterations
    if algo == "pr":
        np.testing.assert_allclose(res.values, one.values, rtol=1e-4)
    else:
        np.testing.assert_array_equal(res.values, one.values)
    dispatch.purge_sharded(g)
    assert current_mesh() is None


@pytest.mark.parametrize("algo", ["pr", "bfs", "sssp", "wcc", "cdlp", "lcc"])
def test_default_distributed_loops_on_one_nccl_rank(cuda, algo, tmp_path):
    """Each of the JAX package's default distributed loops (slab PageRank
    and CDLP, adaptive BFS, SSSP and WCC, oriented-wedge LCC) over a
    one-rank NCCL group, through try_run_distributed with num-devices 1 and
    no impl set, against run_algorithm's one-device default on the card: bit
    for bit (PageRank within 1e-4 relative), with the kernels its rank
    routes to launched."""
    from graphtpu_torch.algorithms.common import run_algorithm
    from graphtpu_torch.parallel import dispatch
    from graphtpu_torch.parallel.mesh import current_mesh, make_mesh
    from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    needed = {"pr": ("gather_rows", "slab_spmv_sum"), "cdlp": ("slab_minmode",),
              "bfs": ("frontier_expand", "gather_rows"),
              "sssp": ("frontier_expand", "push_relax_min"),
              "wcc": ("slab_spmv_min",), "lcc": ("wedge_rowblock",)}[algo]
    g = rmat_graph(12, 16, directed=True, weighted=algo == "sssp", seed=5)
    params = AlgorithmParams(source_vertex=0, damping_factor=0.85, num_iterations=10,
                             max_iterations=10)
    mesh = make_mesh(1, "cuda")
    assert (mesh.size, mesh.backend) == (1, "nccl")
    kernels.reset_launch_counts()
    res = dispatch.try_run_distributed(algo, g, params, PlatformConfig(
        device="cuda", num_devices=1, intermediate_dir=str(tmp_path)))
    for k in needed:
        assert kernels.launch_counts[k] > 0, k
    one = run_algorithm(algo, g, params, PlatformConfig(device="cuda",
                                                        intermediate_dir=str(tmp_path)))
    if algo == "pr":
        np.testing.assert_allclose(res.values, one.values, rtol=1e-4)
    else:
        np.testing.assert_array_equal(res.values, one.values)
    dispatch.purge_sharded(g)
    assert current_mesh() is None


def test_default_distributed_loops_over_every_card(cuda, tmp_path):
    """The JAX package's default distributed loops over one NCCL rank a
    card, every card of the machine (skips with fewer than two), each
    through try_run_distributed with no impl set, against run_algorithm's
    one-device default on cuda:0: bit for bit, PageRank within 1e-4
    relative (RMAT scale 14, directed)."""
    from graphtpu_torch.algorithms.common import run_algorithm
    from graphtpu_torch.parallel import dispatch
    from graphtpu_torch.parallel.mesh import current_mesh, make_mesh
    from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs two or more cards, has {cards}")
    params = AlgorithmParams(source_vertex=0, damping_factor=0.85, num_iterations=10,
                             max_iterations=10)
    mesh = make_mesh(cards, "cuda:0")
    assert (mesh.size, mesh.backend) == (cards, "nccl")
    for weighted, algos in ((False, ("pr", "cdlp", "bfs", "wcc", "lcc")), (True, ("sssp",))):
        g = rmat_graph(14, 16, directed=True, weighted=weighted, seed=5)
        for algo in algos:
            res = dispatch.try_run_distributed(algo, g, params, PlatformConfig(
                device="cuda:0", num_devices=cards, intermediate_dir=str(tmp_path)))
            one = run_algorithm(algo, g, params, PlatformConfig(
                device="cuda:0", intermediate_dir=str(tmp_path)))
            if algo == "pr":
                np.testing.assert_allclose(res.values, one.values, rtol=1e-4)
            else:
                np.testing.assert_array_equal(res.values, one.values, err_msg=algo)
        dispatch.purge_sharded(g)
    assert current_mesh() is None
