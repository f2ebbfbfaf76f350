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
