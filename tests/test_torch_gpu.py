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
    bfs_trunc_probe, bfs_trunc_probe_plain, compact, compact_plain, compact_stream,
    compact_stream_plain, expand, frontier_expand, frontier_expand_plain, relax_min,
    relax_min_i32, relax_min_i32_plain, relax_min_plain, residual_claim, residual_claim_plain,
    residual_hits,
)
from graphtpu_torch.ops.gather import gather_rows, gather_rows_plain
from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops.minmode import (
    K12_MED_LEN, K12_SMEM_LEN, K12_WARP_LEN, _k12_launch, k12_work, slab_minmode,
    slab_minmode_buckets, slab_minmode_plain, stream_minmode, stream_minmode_plain,
)
from graphtpu_torch.ops.pallas_gather import vreg_shuffle, vreg_shuffle_plain
from graphtpu_torch.ops.slab import build_slab_plan, result_buffer
from graphtpu_torch.ops.triangles import (
    ClosingCSR, lcc_head_credits, lcc_head_credits_plain, wedge_rowblock,
)
from graphtpu_torch.ops.spmv import (
    CSR_ITEMS, CSR_MODES, SLICE_WIDTH, _csr_pull_reduce_launch, _pull_slices_launch,
    build_pull_slices, csr_pull_reduce, csr_pull_reduce_plain, csr_scratch_layout,
    merge_path_starts, slab_spmv_min, slab_spmv_min_buckets,
    slab_spmv_min_plain, slab_spmv_sum, slab_spmv_sum_buckets, slab_spmv_sum_plain,
)

from torch_dist_gather import residual_claims

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


@pytest.mark.parametrize("dtype, rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_slab_spmv_plus_heavy_rows_on_k7(cuda, dtype, rtol):
    """slab_spmv's plus.second pull (PageRank's) on the card: the buckets
    in one K3 launch, the heavy rows in one K7 ``sum`` launch, no other K7
    launch, against the same plan's plain pull on the CPU."""
    from graphtpu_torch.core.semiring import PLUS_SECOND
    from graphtpu_torch.ops.spmv import slab_spmv

    n, buckets = 3000, (3, 20, 32, 33, 100, 700)
    plan_c = _random_plan(np.random.default_rng(7), n, buckets, "cpu")
    plan_g = _random_plan(np.random.default_rng(7), n, buckets, cuda)
    heavy = int(plan_c.heavy_rows.shape[0])
    assert heavy > 0
    x = torch.from_numpy(np.random.default_rng(8).random(n)).to(dtype)
    before = dict(kernels.launch_counts)
    got = slab_spmv(PLUS_SECOND, plan_g, x.to(cuda), n).cpu()
    launched = {k: v - before.get(k, 0) for k, v in kernels.launch_counts.items()
                if v != before.get(k, 0)}
    assert launched["slab_spmv_sum"] == 1 and launched["csr_pull_reduce_sum"] == 1
    assert "csr_pull_reduce" not in launched
    torch.testing.assert_close(got, slab_spmv(PLUS_SECOND, plan_c, x, n), rtol=rtol, atol=0)


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
                                  "hubs_only", "single_empty_row", "edgeless",
                                  "hub_over_every_slice"])
def test_csr_pull_reduce_sum_matches_plain(cuda, case, dtype):
    """K7 in mode sum (PageRank's scan arm) on a random CSR with empty rows
    and a hub of 10^5 edges split over many blocks, on the hand cases, and
    on a hub of 10^5 edges over every slice of an x of 3 W + 17 entries:
    within 1e-5 relative of the plain version's float64 row sums in float32
    (1e-12 in float64), twice with the same bits, counted as
    csr_pull_reduce_sum. Every case runs through the wrapper (the sliced
    pull it builds, or the merge path where the runs are short), through
    it on a sliced pull built beforehand (the same bits), and on the sliced
    kernel itself, at the kernel's slice width and at 8,192 entries (more
    slices and tiles)."""
    rng = np.random.default_rng(len(case) * 7 + dtype.itemsize)
    if case == "random":
        src, indptr = _pull_csr(rng, 20000, 100000)
        n_x = 20000
    elif case == "hub_over_every_slice":
        n_x = 3 * SLICE_WIDTH[dtype.itemsize] + 17
        src, indptr = _pull_csr(rng, 5000, 100000)
        src = torch.from_numpy(rng.integers(0, n_x, size=src.shape[0]).astype(np.int32))
        src[indptr[2500]:indptr[2501]] = torch.from_numpy(
            np.sort(rng.integers(0, n_x, size=100000)).astype(np.int32))
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
    if case == "hub_over_every_slice":
        assert int(src[indptr[2500]:indptr[2501]].max()) >= 3 * SLICE_WIDTH[dtype.itemsize]
    built = build_pull_slices(src, indptr, dtype.itemsize)
    assert torch.equal(csr_pull_reduce("sum", x, src, indptr, slices=built), got)
    # the sliced kernel itself, whatever the rule picks for these runs, at
    # the kernel's slice width and a narrower one
    n, m = indptr.shape[0] - 1, src.shape[0]
    for sl in (built, build_pull_slices(src, indptr, dtype.itemsize, 8192)):
        got_s = _pull_slices_launch(x, sl, n, m)
        assert torch.equal(got_s, _pull_slices_launch(x, sl, n, m))
        assert bool(((got_s.double() - want.double()).abs()
                     <= rtol * want.double().abs()).all())
        assert bool((got_s[(indptr.diff() == 0)] == 0).all())


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
            "cdlp": ("sort", "sort", "segment_minmode"),
            "lcc": ("sweep", "sweep", "lcc_sweep_member")}
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
              "bfs": ("frontier_expand", "gather_rows", "frontier_compact"),
              "sssp": ("frontier_expand", "push_relax_min", "frontier_compact"),
              "wcc": ("slab_spmv_min",),
              "lcc": ("wedge_rowblock", "lcc_head_credits")}[algo]
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


def test_checkpoints_save_and_restore_over_every_card(cuda, tmp_path, monkeypatch):
    """shard-checkpoints over one NCCL rank a card (every card of the
    machine, one included): a named RMAT s14 graph's first distributed
    PageRank, CDLP, WCC and dense BFS save the slab plans and the pull
    partition; a freshly loaded twin restores them with every builder
    replaced by a trap, launches K1, K2, K3, K6 and K7 on them, and equals
    the first run bit for bit (PageRank within 1e-12 relative in
    float64)."""
    import dataclasses

    from graphtpu_torch.core.graph import Graph
    from graphtpu_torch.parallel import adaptive_wcc, checkpoint, dispatch, slab_cdlp, slab_pr
    from graphtpu_torch.parallel.mesh import current_mesh
    from graphtpu_torch.parallel.partition import ShardedGraph
    from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    cards = torch.cuda.device_count()
    src = rmat_graph(14, 16, directed=True, seed=5)
    params = AlgorithmParams(source_vertex=0, damping_factor=0.85, num_iterations=10,
                             max_iterations=10)
    cfg = PlatformConfig(device="cuda:0", num_devices=cards, precision="float64",
                         intermediate_dir=str(tmp_path))
    runs = (("pr", {}, ("gather_rows", "slab_spmv_sum")),
            ("cdlp", {}, ("gather_rows", "slab_minmode")),
            ("wcc", {}, ("gather_rows", "slab_spmv_min")),
            ("bfs", {"bfs_impl": "dense"}, ("csr_pull_reduce",)))

    def fresh():
        g = Graph.from_arrays(src.n, src.src, src.dst, None, src.mapping, True, False)
        g.name = "ckpt-s14"
        return g

    def run_all(g):
        out = []
        for algo, impl, needed in runs:
            kernels.reset_launch_counts()
            res = dispatch.try_run_distributed(algo, g, params, dataclasses.replace(cfg, **impl))
            for k in needed:
                assert kernels.launch_counts[k] > 0, (algo, k)
            out.append(res.values)
        dispatch.purge_sharded(g)
        return out

    first = run_all(fresh())
    for kind in ("pr-pull", "cdlp-incidence", "wcc-slab"):
        assert checkpoint.plan_exists(tmp_path, "ckpt-s14", cards, kind), kind
    assert checkpoint.exists(tmp_path, "ckpt-s14", cards)

    def trap(*args, **kwargs):
        raise AssertionError("rebuilt despite a saved checkpoint")

    monkeypatch.setattr(ShardedGraph, "_pull_of", trap)
    for mod in (slab_cdlp, slab_pr, adaptive_wcc):
        monkeypatch.setattr(mod, "build_dist_slab_plan_from", trap)
    monkeypatch.setattr(slab_cdlp, "build_dist_slab_plan", trap)
    second = run_all(fresh())
    np.testing.assert_allclose(second[0], first[0], rtol=1e-12, atol=0)
    for a, b in zip(second[1:], first[1:]):
        np.testing.assert_array_equal(a, b)
    assert current_mesh() is None


def test_scaling_mode_on_the_cards(cuda):
    """``python -m graphtpu_torch.bench --scaling`` on cuda (the default
    platform) at RMAT s12: one row per D in 1, 2, 4, 8 that the machine's
    cards hold, positive rates, the card's name, no TPU constant."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("GRAPHTPU_SCALING_")}
    env.update(GRAPHTPU_SCALING_SCALE="12", GRAPHTPU_BENCH_REPS="2",
               PYTHONPATH=os.pathsep.join(p for p in (str(root), env.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-m", "graphtpu_torch.bench", "--scaling"],
                          capture_output=True, text=True, cwd=root, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = proc.stdout.strip().splitlines()[-1]
    out = json.loads(line)
    d = out["details"]
    assert out["metric"] == "pr_scaling_efficiency" and d["backend"] == "cuda"
    assert d["card"] == torch.cuda.get_device_name(0)
    assert [r["devices"] for r in d["table"]] == [
        n for n in (1, 2, 4, 8) if n <= torch.cuda.device_count()]
    assert all(r[k] > 0 for r in d["table"] for k in ("pr_nnz_per_s", "cdlp_edges_per_s",
                                                       "bfs_teps"))
    assert d["table"][0]["pr_efficiency"] == 1.0 and "ici_gbps" not in line


# ---------------------------------------------------------------- K12, K13


def _k12_stream(rng, seg_len, n_ids):
    """(centers, neigh, indptr) of segments of the given lengths, neighbour
    ids in [0, n_ids)."""
    seg_len = np.asarray(seg_len, dtype=np.int64)
    indptr = np.concatenate([[0], np.cumsum(seg_len)]).astype(np.int32)
    centers = np.repeat(np.arange(seg_len.shape[0]), seg_len).astype(np.int32)
    neigh = rng.integers(0, n_ids, size=centers.shape[0]).astype(np.int32)
    return centers, neigh, indptr


def _k12_assert_matches_plain(labels, centers, neigh, indptr, identity, device):
    """K12 on the card = its plain version on the CPU, twice for the same
    bits; each call adds one launch (the warp kernel), two where a segment
    can be longer than a warp's (the persistent grid kernel too), none on
    no segment."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    lab = None if identity else t(labels)
    want = stream_minmode_plain(lab, t(centers), t(neigh), t(indptr), identity)
    args = (None if identity else lab.to(device), t(centers).to(device), t(neigh).to(device),
            t(indptr).to(device))
    before = kernels.launch_counts["segment_minmode"]
    got = stream_minmode(*args, identity=identity)
    again = stream_minmode(*args, identity=identity)
    h, m = indptr.shape[0] - 1, neigh.shape[0]
    per_call = 0 if h == 0 else 1 + (m > K12_WARP_LEN)
    assert kernels.launch_counts["segment_minmode"] == before + 2 * per_call
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want)
    return want


# one segment at each side of every class boundary: empty, a warp's in
# registers, a warp's table (K12_MED_LEN, at most 512), a block's table
# (K12_SMEM_LEN), then bins (a bin holds about 2,048 entries), vertex 0's
# segment on the bench graph (101,056) and one of 250,000
K12_LENGTHS = [0, 1, 2, 5, 31, 32, 33, 64, 100, K12_MED_LEN, K12_MED_LEN + 1, 512, 513, 1000,
               4095, 4096, 4097, 10000, 70000, 101056, 250000]


@pytest.mark.parametrize("identity", [False, True], ids=["gather", "identity"])
@pytest.mark.parametrize("n_labels", [3, 40, 1 << 20], ids=["ties", "some", "distinct"])
def test_segment_minmode_every_length_class(cuda, n_labels, identity):
    rng = np.random.default_rng(n_labels)
    n = 1 << 20
    seg_len = rng.permutation(np.repeat(K12_LENGTHS, 3))
    centers, neigh, indptr = _k12_stream(rng, seg_len, n)
    if identity and n_labels < n:
        neigh %= n_labels  # the ids are the labels: few of them make ties
    labels = rng.integers(0, n_labels, size=n).astype(np.int32)
    want = _k12_assert_matches_plain(labels, centers, neigh, indptr, identity, cuda)
    assert (want.numpy()[seg_len == 0] == INT32_INF).all()


@pytest.mark.parametrize("m", [0, 1, 31, 32, 33, K12_MED_LEN, K12_MED_LEN + 1, K12_SMEM_LEN,
                               K12_SMEM_LEN + 1])
def test_segment_minmode_streams_at_the_route_boundaries(cuda, m):
    """Streams whose length sits at a launch or table boundary, in segments
    of random lengths, empty ones among them."""
    rng = np.random.default_rng(m)
    cuts = np.sort(rng.integers(0, m + 1, size=7))
    seg_len = np.diff(np.concatenate([[0], cuts, [m]]))
    centers, neigh, indptr = _k12_stream(rng, seg_len, 300)
    labels = rng.integers(0, 9, size=300).astype(np.int32)
    for identity in (False, True):
        _k12_assert_matches_plain(labels, centers, neigh, indptr, identity, cuda)


@pytest.mark.parametrize("case", ["all_distinct_wide", "all_equal", "tie", "pads",
                                  "largest_label", "no_segment"])
def test_segment_minmode_hand_cases(cuda, case):
    """More distinct labels than the shared table holds (6,144) in a
    segment of 4,096 and one of 9,000; a segment of one label; two labels
    tied at the top; ids outside the labels and negative labels as pads;
    INT32_INF - 1 as a label; no segment at all."""
    rng = np.random.default_rng(7)
    n = 20000
    labels = rng.permutation(n).astype(np.int32)
    identity = False
    if case == "all_distinct_wide":
        seg_len = [4096, 9000, 0, 40]
        centers, _, indptr = _k12_stream(rng, seg_len, n)
        neigh = np.concatenate([rng.permutation(n)[:4096], rng.permutation(n)[:9000],
                                rng.permutation(n)[:40]]).astype(np.int32)
    elif case == "all_equal":
        centers, neigh, indptr = _k12_stream(rng, [5000, 20, 300], n)
        labels[:] = 77
    elif case == "tie":
        # labels 3 and 9 tie at 100 entries each, 50 others once
        seg = np.concatenate([np.full(100, 3), np.full(100, 9), np.arange(100, 150)])
        neigh = np.concatenate([rng.permutation(seg), rng.permutation(seg[:140])]).astype(
            np.int32)
        labels = np.arange(n, dtype=np.int32)
        centers, _, indptr = _k12_stream(rng, [250, 140], n)
        identity = True
    elif case == "pads":
        centers, neigh, indptr = _k12_stream(rng, [10, 40, 5000, 3], n)
        neigh[::3] = n + 5  # past the labels
        neigh[1::7] = -4
        labels[::5] = -1  # a negative label is a pad
    elif case == "largest_label":
        labels[:] = INT32_INF - 1
        labels[0] = 5
        centers, neigh, indptr = _k12_stream(rng, [3, 40, 5000], n)
        neigh[indptr[:-1]] = 0  # one 5 against many INT32_INF - 1
    else:
        centers = neigh = np.zeros(0, dtype=np.int32)
        indptr = np.zeros(1, dtype=np.int32)
    want = _k12_assert_matches_plain(labels, centers, neigh, indptr, identity, cuda).numpy()
    if case == "all_distinct_wide":
        assert want[0] == labels[neigh[:4096]].min() and want[2] == INT32_INF
    elif case == "all_equal":
        assert (want == 77).all()
    elif case == "tie":
        assert want.tolist() == [3, 3]
    elif case == "largest_label":
        assert want.tolist() == [INT32_INF - 1] * 3
    elif case == "no_segment":
        assert want.shape == (0,)


def _k12_bin_of(v, nb):
    """csrc/segment_minmode.cu's k12_bin_of: the bins among nb of labels v
    (an array)."""
    x = np.asarray(v, dtype=np.uint64) & np.uint64(0xFFFFFFFF)
    for shift, mul in ((16, 0x85EBCA6B), (13, 0xC2B2AE35), (16, None)):
        x ^= x >> np.uint64(shift)
        if mul is not None:
            x = (x * np.uint64(mul)) & np.uint64(0xFFFFFFFF)
    return (x * np.uint64(nb)) >> np.uint64(32)


K12_LONG_BINS = 49  # bins of a segment of 100,000 entries: ceil(100,000 / 2,048)


def _k12_long_case(case, rng):
    """(labels, centers, neigh, indptr, identity) of one long segment
    (100,000 entries, K12_LONG_BINS bins) and two short ones around it."""
    n, length = 1 << 20, 100000
    labels = rng.permutation(n).astype(np.int32)
    seg = rng.integers(0, n, size=length)
    identity = False
    if case == "hot_label":  # 90 % one label: one pair a chunk, no bin overflows
        seg[: 9 * length // 10] = 12345
        labels[12345] = 777
    elif case == "all_distinct":  # every id once, counted as the labels themselves
        seg = rng.permutation(n)[:length]
        identity = True
    else:
        bins = _k12_bin_of(np.arange(n), K12_LONG_BINS)
        identity = True
        labels = np.arange(n, dtype=np.int32)
        if case == "tie_across_bins":  # two labels at 700 entries each, in different bins
            a = 1000
            b = int(np.flatnonzero(bins[a + 1:] != bins[a])[0]) + a + 1
            others = rng.permutation(np.setdiff1d(np.arange(n), [a, b]))[:length - 1400]
            seg = np.concatenate([np.repeat([b, a], 700), others])
        else:  # 10,000 distinct ids of bin 0: a bin of 10,000 pairs, past the shared table
            seg = np.concatenate([rng.permutation(np.flatnonzero(bins == 0))[:10000],
                                  rng.permutation(np.flatnonzero(bins != 0))[:length - 10000]])
        seg = rng.permutation(seg)
    neigh = np.concatenate([rng.integers(0, n, size=40), seg, rng.integers(0, n, size=7)])
    seg_len = [40, length, 7]
    indptr = np.concatenate([[0], np.cumsum(seg_len)]).astype(np.int32)
    centers = np.repeat(np.arange(3), seg_len).astype(np.int32)
    return labels, centers, neigh.astype(np.int32), indptr, identity


@pytest.mark.parametrize("case", ["hot_label", "all_distinct", "tie_across_bins",
                                  "overflow_bin"])
def test_segment_minmode_long_segment_cases(cuda, case):
    """A long segment's bins: one hot label in 90 % of it (one pair a chunk),
    every id distinct in identity mode, two labels tied at the top count
    that fall in different bins (the smaller wins), and a bin of 10,000
    pairs, past the shared table's 4,096, counted by the global-memory
    fallback in 3 chunks. Twice the same bits as the plain version; the
    fallback taken by that bin alone."""
    labels, centers, neigh, indptr, identity = _k12_long_case(case, np.random.default_rng(5))
    want = _k12_assert_matches_plain(labels, centers, neigh, indptr, identity, cuda).numpy()
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    _, scratch = _k12_launch(None if identity else t(labels), t(neigh), t(indptr), identity)
    work = k12_work(scratch)
    assert (work["long"], work["bins"], work["long_chunks"]) == (1, K12_LONG_BINS, 25)
    overflow = case == "overflow_bin"
    assert (work["fallback_bins"], work["fallback_chunks"]) == (overflow, 3 * overflow)
    seg = neigh[40:100040]
    if case == "hot_label":
        assert want[1] == 777
    elif case == "tie_across_bins":
        assert want[1] == 1000
    else:  # every label once: the smallest
        assert want[1] == seg.min()


def test_segment_minmode_makes_no_host_read(cuda):
    """Under sync debug mode "error" a call that waits for the device
    raises: K12 must not (torch.unique_consecutive would)."""
    rng = np.random.default_rng(3)
    centers, neigh, indptr = _k12_stream(rng, [0, 7, 60, 5000, 9000, 2], 1000)
    args = [torch.from_numpy(a).to(cuda) for a in (centers, neigh, indptr)]
    labels = torch.from_numpy(rng.integers(0, 20, size=1000).astype(np.int32)).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = stream_minmode(labels, *args)
        ident = stream_minmode(None, *args, identity=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, stream_minmode_plain(labels, *args))
    assert torch.equal(ident, stream_minmode_plain(None, *args, identity=True))


@pytest.mark.parametrize("t", [1, 2, 4, 11])
@pytest.mark.parametrize("case", ["random", "sentinel_only", "rank_rows"])
def test_bfs_trunc_probe_matches_plain(cuda, t, case):
    rng = np.random.default_rng(t)
    n, level = 100003, 4
    levels = np.where(rng.random(n) < 0.5, rng.integers(0, level + 1, size=n),
                      INT32_INF).astype(np.int32)
    pdeg = rng.integers(0, 3 * t + 1, size=n).astype(np.int32)
    trunc = rng.integers(0, n, size=(t, n)).astype(np.int32)
    trunc[np.arange(t)[:, None] >= pdeg[None, :]] = n
    if case == "sentinel_only":
        trunc[:, ::2] = n  # rows that probe nothing
        trunc[:, 1::4] = -1
    off, rows = 0, n
    if case == "rank_rows":  # a rank's rows of the replicated levels
        off, rows = 40000, 30001
        trunc = trunc[:, off:off + rows]
        pdeg = pdeg[off:off + rows]
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(-1))  # noqa: E731
    args = (tt(levels), level, tt(trunc), tt(pdeg), t, off)
    want = bfs_trunc_probe_plain(*args)
    before = kernels.launch_counts["bfs_trunc_probe"]
    got = bfs_trunc_probe(*(a.to(cuda) if torch.is_tensor(a) else a for a in args))
    assert kernels.launch_counts["bfs_trunc_probe"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and torch.equal(g.cpu(), w)
    if case == "sentinel_only":
        assert not bool(want[0][::2].any())


# ---------------------------------------------------------------- K14


def _numpy_compact(mask, k):
    """The expected (ids, count) of compact, from numpy alone."""
    n = mask.shape[0]
    nz = np.nonzero(mask)[0].astype(np.int32)
    ids = np.full(k, n, dtype=np.int32)
    ids[:min(k, nz.shape[0])] = nz[:k]
    return ids, nz.shape[0]


@pytest.mark.parametrize("density", [0.0, 0.001, 0.3, 1.0])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 8193, 300007, (1 << 20) + 3])
def test_frontier_compact_matches_plain(cuda, n, density):
    """compact at n around a word and a block step, empty, sparse, dense
    and full masks, with k cut below the count, exact, above it and above
    n; one launch a call."""
    rng = np.random.default_rng(n)
    mask = rng.random(n) < density
    cnt = int(mask.sum())
    for k in sorted({1, max(cnt - 1, 1), max(cnt, 1), cnt + 5, n + 10}):
        before = kernels.launch_counts["frontier_compact"]
        ids, count = compact(torch.from_numpy(mask).to(cuda), k)
        assert kernels.launch_counts["frontier_compact"] == before + 1
        want_ids, want_cnt = _numpy_compact(mask, k)
        plain_ids, plain_cnt = compact_plain(torch.from_numpy(mask), k)
        assert ids.dtype == torch.int32 and count.dtype == torch.int32 and count.dim() == 0
        np.testing.assert_array_equal(ids.cpu().numpy(), want_ids)
        assert int(count) == want_cnt == int(plain_cnt)
        assert torch.equal(ids.cpu(), plain_ids)


def test_frontier_compact_on_a_slice_with_an_offset(cuda):
    """A rank's rows of a longer mask (a view with a storage offset that is
    no multiple of 4) compact like the copy."""
    rng = np.random.default_rng(11)
    full = torch.from_numpy(rng.random(100_001) < 0.2).to(cuda)
    for lo, hi in ((3, 50_004), (50_004, 100_001), (77, 78)):
        view = full[lo:hi]
        assert view.storage_offset() == lo
        for k in (1, 4096, hi - lo + 3):
            got, want = compact(view, k), compact_plain(view.cpu(), k)
            assert torch.equal(got[0].cpu(), want[0]) and int(got[1]) == int(want[1])


def _numpy_compact_stream(vals, active, k, n):
    u = np.unique(vals[active & (vals < n)]).astype(np.int32)
    ids = np.full(k, n, dtype=np.int32)
    ids[:min(k, u.shape[0])] = u[:k]
    return ids, u.shape[0]


@pytest.mark.parametrize("case", ["random", "with_pad_value", "all_inactive", "empty_stream",
                                  "one_value", "every_vertex"])
@pytest.mark.parametrize("n", [1, 33, 1000, 65537, 1 << 20])
def test_frontier_compact_stream_matches_plain(cuda, n, case):
    """compact_stream on streams with repeats, the pad value n among the
    values (never taken), no active slot, no slot, one repeated value and
    every vertex once (shuffled); k below, at and above the distinct
    count; one launch a call."""
    rng = np.random.default_rng(n + len(case))
    e = 0 if case == "empty_stream" else int(rng.integers(1, 4 * n + 2))
    vals = rng.integers(0, n + 1, size=e).astype(np.int32)
    active = rng.random(e) < 0.6
    if case == "with_pad_value":
        vals[::3] = n
    elif case == "all_inactive":
        active[:] = False
    elif case == "one_value":
        vals[:], active[:] = n // 2, True
    elif case == "every_vertex":
        vals, active = rng.permutation(n).astype(np.int32), np.ones(n, dtype=bool)
    distinct = _numpy_compact_stream(vals, active, 1, n)[1]
    for k in sorted({1, max(distinct - 1, 1), max(distinct, 1), distinct + 7}):
        tv, ta = torch.from_numpy(vals), torch.from_numpy(active)
        before = kernels.launch_counts["frontier_compact"]
        ids, count = compact_stream(tv.to(cuda), ta.to(cuda), k, n)
        assert kernels.launch_counts["frontier_compact"] == before + 1
        want_ids, want_cnt = _numpy_compact_stream(vals, active, k, n)
        np.testing.assert_array_equal(ids.cpu().numpy(), want_ids)
        assert int(count) == want_cnt
        plain = compact_stream_plain(tv, ta, k, n)
        assert torch.equal(ids.cpu(), plain[0]) and int(plain[1]) == want_cnt


def test_frontier_compact_makes_no_host_read(cuda):
    """Under sync debug mode "error" a call that waits for the device
    raises: K14's launch sizes come from shapes alone."""
    rng = np.random.default_rng(2)
    mask = torch.from_numpy(rng.random(70_000) < 0.1).to(cuda)
    vals = torch.from_numpy(rng.integers(0, 70_000, size=200_000).astype(np.int32)).to(cuda)
    active = torch.from_numpy(rng.random(200_000) < 0.5).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = compact(mask, 4096)
        b = compact_stream(vals, active, 1 << 16, 70_000)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pa, pb = compact_plain(mask, 4096), compact_stream_plain(vals, active, 1 << 16, 70_000)
    assert torch.equal(a[0], pa[0]) and torch.equal(a[1], pa[1])
    assert torch.equal(b[0], pb[0]) and torch.equal(b[1], pb[1])


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 70_001])
def test_frontier_compact_at_every_byte_offset(cuda, n):
    """compact of a slice that starts at each byte offset 0-31 of a longer
    mask (the lanes' 16-byte loads start below it and shift), at n that is
    no multiple of 32, with k below and above the count."""
    rng = np.random.default_rng(n)
    full = torch.from_numpy(rng.random(n + 64) < 0.4).to(cuda)
    for off in range(32):
        view = full[off:off + n]
        assert view.storage_offset() == off
        for k in (max(int(view.sum()) // 2, 1), n + 3):
            got, want = compact(view, k), compact_plain(view.cpu(), k)
            assert torch.equal(got[0].cpu(), want[0]) and int(got[1]) == int(want[1]), (off, k)


@pytest.mark.parametrize("case", ["one_value", "all_distinct", "slots_2_22"])
def test_frontier_compact_stream_matches_plain_on_hard_streams(cuda, case):
    """compact_stream's bitmap marks on a stream of one repeated value, one
    of all distinct values, and 2^22 slots of hub-heavy values over n =
    2^20, bit for bit against the plain version, twice the same bits."""
    rng = np.random.default_rng(len(case))
    n = 1 << 20
    if case == "one_value":
        vals = np.full(1 << 18, 12_345, dtype=np.int32)
    elif case == "all_distinct":
        vals = rng.permutation(n).astype(np.int32)
    else:
        vals = (n * rng.random(1 << 22) ** 4).astype(np.int32)  # low ids repeat most
    active = rng.random(vals.shape[0]) < 0.9
    tv, ta = torch.from_numpy(vals).to(cuda), torch.from_numpy(active).to(cuda)
    for k in (1 << 16, 1 << 18):
        want = compact_stream_plain(tv, ta, k, n)
        got, again = compact_stream(tv, ta, k, n), compact_stream(tv, ta, k, n)
        for a, a2, b in zip(got, again, want):
            assert torch.equal(a, b) and torch.equal(a, a2), (case, k)


# ------------------------------------------------- K7 sum_i64, max_i32 residual


@pytest.mark.parametrize("case", ["random", "row_ends_on_border", "empty_run", "one_row",
                                  "hubs_only", "single_empty_row", "edgeless"])
def test_csr_pull_reduce_sum_i64_matches_plain_and_numpy(cuda, case):
    """K7 in mode sum_i64: int32 values near 2^31 (and negative ones), so
    rows sum past 2^32; bit for bit against the plain version and numpy's
    int64 sums, twice the same bits, counted as csr_pull_reduce_sum_i64."""
    rng = np.random.default_rng(len(case) * 13)
    if case == "random":
        src, indptr = _pull_csr(rng, 20000, 100000)
        n_x = 20000
    else:
        deg = _k7_degrees(case, CSR_ITEMS[8], rng)
        ip = np.zeros(deg.shape[0] + 1, dtype=np.int64)
        np.cumsum(deg, out=ip[1:])
        n_x = 50_000
        src = torch.from_numpy(rng.integers(0, n_x, size=int(ip[-1])).astype(np.int32))
        indptr = torch.from_numpy(ip.astype(np.int32))
    x = rng.integers(-(1 << 20), (1 << 31) - 1, size=n_x).astype(np.int32)
    ip_h, src_h = indptr.numpy().astype(np.int64), src.numpy()
    want = np.add.reduceat(np.concatenate([x[src_h].astype(np.int64), [0]]), ip_h[:-1]) \
        if ip_h.shape[0] > 1 else np.zeros(0, np.int64)
    want[np.diff(ip_h) == 0] = 0
    xd, src_d, ip_d = torch.from_numpy(x).to(cuda), src.to(cuda), indptr.to(cuda)
    before = dict(kernels.launch_counts)
    got = csr_pull_reduce("sum_i64", xd, src_d, ip_d)
    again = csr_pull_reduce("sum_i64", xd, src_d, ip_d)
    launched = indptr.shape[0] > 1
    assert (kernels.launch_counts["csr_pull_reduce_sum_i64"]
            - before["csr_pull_reduce_sum_i64"]) == 2 * launched
    assert kernels.launch_counts["csr_pull_reduce"] == before["csr_pull_reduce"]
    assert got.dtype == torch.int64 and torch.equal(got, again)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert torch.equal(got.cpu(), csr_pull_reduce_plain("sum_i64", torch.from_numpy(x), src,
                                                        indptr))
    if case == "hubs_only":
        assert int(got.abs().max()) > 1 << 32


@pytest.mark.parametrize("case", ["fits", "cut", "no_residual"])
def test_residual_hits_match_the_cumsum_on_the_card(cuda, case):
    """BFS's residual test on K7 max_i32 against the JAX package's
    formulation (a cumsum of the valid hits differenced at the clamped row
    starts), on a random expansion whose edges fit the slots, are cut by
    them, or are none; the pad slots' neighbour 0 is marked."""
    rng = np.random.default_rng(len(case))
    n, k, e_cap = 30000, 4096, 1 << 16
    deg = rng.integers(0, 40, size=n).astype(np.int32)
    deg_pad = np.concatenate([deg, [0]]).astype(np.int32)
    ip = np.concatenate([[0], np.cumsum(deg_pad)]).astype(np.int32)
    neigh = rng.integers(0, n, size=int(ip[-2])).astype(np.int32)
    cnt = {"fits": 1000, "cut": 4000, "no_residual": 0}[case]
    ids = np.full(k, n, dtype=np.int32)
    ids[:cnt] = np.sort(rng.choice(n, size=cnt, replace=False))
    fmask = np.concatenate([rng.random(n) < 0.05, [0]]).astype(np.int32)
    fmask[0] = 1
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    exp = expand(t(ids), t(deg_pad), t(ip), t(neigh), e_cap, with_row_ids=False)
    before = kernels.launch_counts["csr_pull_reduce"]
    got = residual_hits(t(fmask), exp, e_cap)
    assert kernels.launch_counts["csr_pull_reduce"] == before + 1
    rhit = (exp.valid & (t(fmask)[exp.neigh.long()] == 1)).to(torch.int64)
    cs = torch.cat([rhit.new_zeros(1), torch.cumsum(rhit, 0)])
    starts = torch.clamp(exp.seg_starts, max=e_cap).long()
    want = (cs[starts[1:]] - cs[starts[:-1]]) > 0
    assert got.shape == (k,) and torch.equal(got, want)
    assert case == "no_residual" or bool(got.any())
    if case == "cut":
        assert int(exp.edge_count) > e_cap


# ------------------------------------------------- K16 head credits, K17 residual


@pytest.mark.parametrize("case", ["hubs_near_2_31", "outside_window", "few_heads", "unaligned",
                                  "edge_part_only", "all_pad"])
def test_lcc_head_credits_matches_plain(cuda, case):
    """K16 against its plain version: 16 buckets of LCC-like slabs (left
    packed, -1 pad, heads drawn with RMAT-like skew to the top ids, where the
    kernel's shared-memory window lies, or away from it), credits near 2^31
    so that hub sums pass 2^32, apex credits on the real rows (off in one
    case), slabs 4 bytes off a 16-byte boundary; two runs give the same
    bits, one launch counted a call, none read back to the host."""
    rng = np.random.default_rng(len(case) + 160)
    n = 1 << 18
    hubs = kernels.query("lcc_head_credits_hubs")
    assert 0 < hubs < n // 4
    slabs, creds, us, rows, off = [], [], [], [], 0
    order = rng.permutation(n)
    for w, r in [(3, 40000)] + [(4 + 6 * j, 3000 + 997 * j) for j in range(15)]:
        deg = rng.integers(0, w + 1, size=r)
        if case == "few_heads":
            heads = rng.integers(n - 40, n, size=(w, r))
        elif case == "outside_window":
            heads = rng.integers(0, n - hubs, size=(w, r))
        else:  # most entries on the top ids, the rest anywhere
            top = n - 1 - (rng.pareto(1.2, size=(w, r)) * 50).astype(np.int64)
            heads = np.where(rng.random((w, r)) < 0.7, np.maximum(top, 0),
                             rng.integers(0, n, size=(w, r)))
        slab = np.where(np.arange(w)[:, None] < deg[None, :], heads, -1)
        if case == "all_pad":
            slab[:] = -1
        hi = (1 << 31) - 1 if case == "hubs_near_2_31" else 8
        cred = np.where(slab >= 0, rng.integers(0, hi, size=(w, r)), 0)
        if case == "unaligned":
            buf = torch.zeros(2 * w * r + 1, dtype=torch.int32, device=cuda)
            s_t = buf[1:w * r + 1].view(w, r)
            c_t = buf[w * r + 1:].view(w, r)
            s_t.copy_(torch.from_numpy(slab.astype(np.int32)))
            c_t.copy_(torch.from_numpy(cred.astype(np.int32)))
        else:
            s_t = torch.from_numpy(slab.astype(np.int32)).to(cuda)
            c_t = torch.from_numpy(cred.astype(np.int32)).to(cuda)
        slabs.append(s_t)
        creds.append(c_t)
        r_real = int(r * 0.9)
        us.append(torch.from_numpy(rng.integers(0, hi, size=r_real).astype(np.int32)).to(cuda))
        rows.append(order[off:off + r_real])
        off += r_real
    apex = None if case == "edge_part_only" else (
        us, torch.from_numpy(np.concatenate(rows).astype(np.int64)).to(cuda))
    before = kernels.launch_counts["lcc_head_credits"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = lcc_head_credits(n, slabs, creds, apex)
        again = lcc_head_credits(n, slabs, creds, apex)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.launch_counts["lcc_head_credits"] == before + 2
    want = lcc_head_credits_plain(n, slabs, creds, apex)
    assert got.dtype == torch.int64 and torch.equal(got, again) and torch.equal(got, want)
    if case == "hubs_near_2_31":
        assert int(got.max()) > 1 << 32
    if case == "all_pad" and apex is not None:
        assert int(got.count_nonzero()) <= off


@pytest.mark.parametrize("case", ["fits", "cut", "no_residual"])
def test_residual_claim_matches_plain_on_the_card(cuda, case):
    """K17 against its plain version (the frontier mask, K7's plain max_i32
    over the clamped row starts, a where) on a random expansion whose edges
    fit the slots, are cut by them, or are none; the pad slots' neighbour 0
    is at the level; one launch a call, two calls the same bits, no host
    read."""
    rng = np.random.default_rng(len(case) + 170)
    n, k, e_cap = 30000, 4096, 1 << 16
    deg = rng.integers(0, 40, size=n).astype(np.int32)
    deg_pad = np.concatenate([deg, [0]]).astype(np.int32)
    ip = np.concatenate([[0], np.cumsum(deg_pad)]).astype(np.int32)
    neigh = rng.integers(0, n, size=int(ip[-2])).astype(np.int32)
    cnt = {"fits": 1000, "cut": 4000, "no_residual": 0}[case]
    ids = np.full(k, n, dtype=np.int32)
    ids[:cnt] = np.sort(rng.choice(n, size=cnt, replace=False))
    levels = rng.choice([0, 1, 2, INT32_INF], size=n, p=[0.02, 0.03, 0.1, 0.85])
    levels = levels.astype(np.int32)
    levels[0] = 1
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    exp = expand(t(ids), t(deg_pad), t(ip), t(neigh), e_cap, with_row_ids=False)
    lv, rids = t(levels), t(ids)
    before = kernels.launch_counts["bfs_residual_claim"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = residual_claim(lv, 1, exp, e_cap, rids, n)
        again = residual_claim(lv, 1, exp, e_cap, rids, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.launch_counts["bfs_residual_claim"] == before + 2
    want = residual_claim_plain(lv, 1, exp, e_cap, rids, n)
    fmask = torch.cat([(lv == 1).to(torch.int32), lv.new_zeros(1)])
    assert torch.equal(want, torch.where(residual_hits(fmask, exp, e_cap), rids, n))
    assert got.dtype == torch.int32 and got.shape == (k,)
    assert torch.equal(got, again) and torch.equal(got, want)
    assert (case == "no_residual") == (not bool((got != n).any()))
    if case == "cut":
        assert int(exp.edge_count) > e_cap


def test_residual_claim_on_one_nccl_rank(cuda):
    """K17 in the distributed BFS's per-rank form over a one-rank NCCL group
    (the replicated levels, the rank's pull CSR as adaptive_bfs installs
    it, the pad r) against its plain version on the same inputs."""
    from graphtpu_torch.algorithms.bfs import BFS_TRUNC
    from graphtpu_torch.parallel.adaptive_bfs import bfs_adaptive_dist
    from graphtpu_torch.parallel.mesh import close_mesh, make_mesh
    from graphtpu_torch.parallel.partition import ShardedGraph
    from graphtpu_torch.utils.synth import rmat_graph

    g = rmat_graph(12, 16, directed=True, seed=5)
    close_mesh()
    mesh = make_mesh(1, "cuda")
    assert (mesh.size, mesh.backend) == (1, "nccl")
    try:
        sg = ShardedGraph(g, mesh)
        bfs_adaptive_dist(sg, 0)
        key = (sg.key, f"bfs-adaptive-{BFS_TRUNC}")
        r = sg.rows_per_dev
        rng = np.random.default_rng(17)
        levels = rng.choice([0, 1, INT32_INF], size=r, p=[0.1, 0.1, 0.8]).astype(np.int32)
        rids = np.full(1 << 12, r, dtype=np.int32)
        rids[:2000] = np.sort(rng.choice(r, size=2000, replace=False))
        for e_cap in (1 << 16, 1 << 10):
            before = kernels.launch_counts["bfs_residual_claim"]
            got = mesh.call(residual_claims, [(key, levels, 1, rids, e_cap)])
            assert kernels.launch_counts["bfs_residual_claim"] == before + 1
            with kernels.plain_torch():
                want = mesh.call(residual_claims, [(key, levels, 1, rids, e_cap)])
            np.testing.assert_array_equal(got, want)
            assert (got != r).any()
        sg.release()
    finally:
        close_mesh()


# ---------------------------------------------------------------- K8 int32


@pytest.mark.parametrize("total", [0, 1, 160, (1 << 17) + 3, 1 << 18, (1 << 18) + 5])
@pytest.mark.parametrize("case", ["random", "equal_candidates", "rank_offset"])
def test_relax_min_i32_matches_plain(cuda, case, total):
    """K8's int32 mode at the active step's 2^18 slots, the real ones a
    prefix [0, total) from none to all (a total past the slots counts as
    all): contended targets, one candidate for every slot, and a rank's row
    offset into the replicated labels; one launch a call, no host read of
    the total (sync debug mode "error")."""
    rng = np.random.default_rng(len(case) + 40)
    n_lab, n_out, e_cap = 50000, 20000, 1 << 18
    labels = rng.integers(0, n_lab, size=n_lab).astype(np.int32)
    row_ids = rng.integers(0, 10000, size=e_cap).astype(np.int32)
    neigh = rng.integers(0, 300, size=e_cap).astype(np.int32)
    offset = 0
    if case == "equal_candidates":
        row_ids[:] = 7
    elif case == "rank_offset":
        offset, neigh = 40000, rng.integers(0, n_out, size=e_cap).astype(np.int32)
    valid = np.arange(e_cap) < total
    tt = [torch.from_numpy(a) for a in (labels, row_ids, neigh)]
    total_t = torch.tensor(total, dtype=torch.int32)
    want = relax_min_i32_plain(n_out, *tt, total_t, offset)
    assert torch.equal(want, relax_min_i32_plain(n_out, *tt, torch.from_numpy(valid), offset))
    args = [a.to(cuda) for a in tt + [total_t]]
    before = kernels.launch_counts["push_relax_min_i32"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = relax_min_i32(n_out, *args, offset)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.launch_counts["push_relax_min_i32"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    hit = np.full(n_out, INT32_INF, dtype=np.int64)
    np.minimum.at(hit, neigh[valid], labels[row_ids[valid] + offset])
    np.testing.assert_array_equal(want.numpy(), hit)


# ---------------------------------------------------------------- K15


def _k15_graph(kind, directed):
    """An RMAT graph, or a star glued to a clique: a 300-clique whose
    vertices also join a hub of 2,000 leaves, so the c-rows run long (a
    clique vertex's row holds up to 300 o's: several items a tile) over
    many tiles (d(c) = 300), against a hub row of 2,300 entries."""
    from graphtpu_torch.core.graph import Graph
    from graphtpu_torch.utils.synth import rmat_graph

    if kind.startswith("rmat"):
        return rmat_graph(int(kind[4:]), 16, directed=directed, seed=int(kind[4:]))
    q, leaves = 300, 2000
    a, b = np.triu_indices(q, 1)
    hub = q
    src = np.concatenate([a, np.full(q + leaves, hub)])
    dst = np.concatenate([b, np.arange(q), np.arange(q + 1, q + 1 + leaves)])
    if directed:  # each edge one way, chosen at random
        flip = np.random.default_rng(5).random(src.shape[0]) < 0.5
        src, dst = np.where(flip, dst, src), np.where(flip, src, dst)
    n = q + 1 + leaves
    return Graph.from_original_ids(np.arange(n), src, dst, None, directed, False)


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("kind", ["rmat8", "rmat11", "star_clique"])
def test_lcc_sweep_member_matches_plain(cuda, directed, kind):
    """The c-row sweep on the card against its plain version on the CPU,
    bucket by bucket (numerators bit for bit) under every unit of threads
    an item the kernel takes (a warp, the path's, up to a block), each at 1
    and 4 searches a lane in step; one launch per nonempty bucket,
    counted."""
    from graphtpu_torch.algorithms import lcc as L

    g = _k15_graph(kind, directed)
    plan = L.sweep_plan(g)
    iters = L.search_iters_of(plan.s_deg)
    t = lambda a, dev: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    buckets = L.plan_buckets(plan)
    for pad, sel in buckets:
        c, o = plan.c[sel], plan.o[sel]
        want = L._lcc_bucket_sweep(torch.zeros(g.n, dtype=torch.int64), t(plan.s_indptr, "cpu"),
                                   t(plan.s_dst, "cpu"), t(c, "cpu"), t(o, "cpu"), pad, iters,
                                   plan.weight)
        items = t(L.sweep_items(c, plan.s_deg), cuda)
        for kw in [{}] + [dict(unit=u, ilp=i) for u in (32, 64, 128, 256) for i in (1, 4)]:
            before = kernels.launch_counts["lcc_sweep_member"]
            got = L._lcc_bucket_sweep(torch.zeros(g.n, dtype=torch.int64, device=cuda),
                                      t(plan.s_indptr, cuda), t(plan.s_dst, cuda), t(c, cuda),
                                      t(o, cuda), pad, iters, plan.weight, items, **kw)
            assert kernels.launch_counts["lcc_sweep_member"] == before + 1
            assert torch.equal(got.cpu(), want), (pad, kw)
    before = kernels.launch_counts["lcc_sweep_member"]
    num, _ = L.lcc_sweep_numerator(g, cuda)
    assert kernels.launch_counts["lcc_sweep_member"] == before + len(buckets)
    np.testing.assert_array_equal(num, L.lcc_sweep_numerator(g, "cpu")[0])
    assert num.max() > 0
    if kind == "star_clique":  # many tiles, and rows cut into full items
        items = L.sweep_items(plan.c, plan.s_deg)
        tiles = np.unique(plan.c[items[:, 0]].astype(np.int64) << 32 | items[:, 2])
        assert items[:, 2].max() >= 256 and tiles.shape[0] < items.shape[0]


def test_lcc_sweep_member_takes_a_list_in_any_order(cuda):
    """Entries that are not grouped by c (prepare_lcc's A-edge lists, one
    per A-edge) give the items of their runs: the same numerators. A launch
    without items is refused."""
    from graphtpu_torch.algorithms import lcc as L
    from graphtpu_torch.utils.synth import rmat_graph

    g = rmat_graph(9, 16, directed=False, seed=3)
    s_indptr, s_dst, s_deg, c, o, dc = L.prepare_lcc(g)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    got = torch.zeros(g.n, dtype=torch.int64, device=cuda)
    for pad, sel in ((16, dc <= 16), (128, (dc > 16) & (dc <= 128)), (1024, dc > 128)):
        L._lcc_bucket_sweep(got, t(s_indptr), t(s_dst), t(c[sel]), t(o[sel]), pad, 10, 1,
                            t(L.sweep_items(c[sel], s_deg)))
    np.testing.assert_array_equal(got.cpu().numpy(), L.lcc_sweep_numerator(g, "cpu")[0])
    with pytest.raises(ValueError, match="items"):
        L._lcc_bucket_sweep(got, t(s_indptr), t(s_dst), t(c), t(o), 1024, 10)


def test_sweep_plan_checks_symmetry_on_the_card(cuda):
    """The plan's symmetry check on the card gives the CPU's answer: an
    undirected RMAT's stored edges, the same with one edge's reverse
    dropped, and with one edge listed twice."""
    from graphtpu_torch.algorithms.lcc import is_symmetric
    from graphtpu_torch.utils.synth import rmat_graph

    g = rmat_graph(10, 16, directed=False, seed=4)
    keep = g.src != g.dst
    u, w = g.src[keep], g.dst[keep]
    back = np.flatnonzero((u == w[0]) & (w == u[0]))[0]
    cases = {"stored": (u, w, True), "one_way": (np.delete(u, back), np.delete(w, back), False),
             "doubled": (np.append(u, u[0]), np.append(w, w[0]), False)}
    for name, (a, b, want) in cases.items():
        assert is_symmetric(a, b, g.n, cuda) == is_symmetric(a, b, g.n) == want, name


@pytest.mark.parametrize("unit,ilp", [(16, 1), (48, 1), (512, 1), (32, 2), (32, 8)])
def test_lcc_sweep_member_refuses_other_units(cuda, unit, ilp):
    """A unit that is not a power of two from a warp to a block, or a count
    of searches in step other than 1 or 4, is refused by the launch, not
    run."""
    from graphtpu_torch.algorithms.lcc import _lcc_bucket_sweep

    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda)  # noqa: E731
    items = torch.tensor([[0, 1, 0]], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="lcc_sweep_member"):
        _lcc_bucket_sweep(torch.zeros(2, dtype=torch.int64, device=cuda), i32([0, 1, 2]),
                          i32([1, 0]), i32([0]), i32([1]), 16, 2, 1, items, unit, ilp=ilp)


@pytest.mark.parametrize("k", [1, 2, 1023, 1024, 16385, 1 << 16, 1 << 18, 300_001])
def test_frontier_starts_matches_plain(cuda, k):
    """K18 against its plain version: ascending ids padded with n (degree
    0), ids past the table read degree 0 as K1 gives, one launch; degrees
    whose sum passes 2^31 wrap as the int32 cumsum does."""
    from graphtpu_torch.ops.frontier import frontier_starts, frontier_starts_plain

    rng = np.random.default_rng(k)
    n = 1 << 20
    deg_pad = np.concatenate([rng.integers(0, 200, size=n), [0]]).astype(np.int32)
    ids = np.sort(rng.integers(0, n, size=k)).astype(np.int32)
    ids[k - k // 4:] = n  # the pad
    for table in (deg_pad, np.full(n + 1, 1 << 20, dtype=np.int32)):
        table[n] = 0
        td, ti = torch.from_numpy(table), torch.from_numpy(ids)
        before = kernels.launch_counts["frontier_starts"]
        got = frontier_starts(ti.to(cuda), td.to(cuda))
        assert kernels.launch_counts["frontier_starts"] == before + 1
        assert torch.equal(got.cpu(), frontier_starts_plain(ti, td))


def _expansion(cuda, rng, n, k, e_cap, count):
    from graphtpu_torch.ops.frontier import expand

    deg = rng.integers(0, 40, size=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    neigh = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    ids = np.full(k, n, dtype=np.int32)
    ids[:count] = np.sort(rng.choice(n, size=count, replace=False))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(cuda)  # noqa: E731
    deg_pad = t(np.concatenate([deg, [0]]))
    return expand(t(ids), deg_pad, t(indptr), t(neigh), e_cap, with_row_ids=False), deg_pad


@pytest.mark.parametrize("share", [0.0, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("k_out", [16, 4096, 1 << 16])
def test_frontier_compact_rows_matches_plain(cuda, share, k_out):
    """K14's row-flag mode and the valid-mask mode's degree sum against
    their plain versions on random expansions (a cut expansion included):
    ids, count and degree sum bit for bit, one launch a call each."""
    from graphtpu_torch.ops.frontier import (
        compact_rows_into, compact_rows_plain, compact_stream_into,
    )

    rng = np.random.default_rng(int(share * 100) + k_out)
    n = 100_000
    for k, e_cap, count in ((4096, 1 << 18, 3000), (1 << 16, 1 << 16, 20_000)):
        exp, deg_pad = _expansion(cuda, rng, n, k, e_cap, count)
        flags = torch.from_numpy(rng.random(k) < share).to(cuda)
        out, status = (torch.empty(k_out, dtype=torch.int32, device=cuda),
                       torch.full((2,), -1, dtype=torch.int32, device=cuda))
        before = dict(kernels.launch_counts)
        compact_rows_into(exp, flags, n, deg_pad, out, status)
        assert kernels.launch_counts["frontier_compact_rows"] == \
            before["frontier_compact_rows"] + 1
        cpu = lambda e: type(e)(*(None if f is None else f.cpu() for f in e))  # noqa: E731
        p_out, p_status = torch.empty(k_out, dtype=torch.int32), torch.empty(2, dtype=torch.int32)
        compact_rows_plain(cpu(exp), flags.cpu(), n, deg_pad.cpu(), p_out, p_status)
        assert torch.equal(out.cpu(), p_out) and torch.equal(status.cpu(), p_status)
        compact_stream_into(exp.neigh, exp.valid, n, deg_pad, out, status)
        assert kernels.launch_counts["frontier_compact"] == before["frontier_compact"] + 1
        p_out, p_status = p_out.to(cuda), p_status.to(cuda)
        with kernels.plain_torch():
            compact_stream_into(exp.neigh, exp.valid, n, deg_pad, p_out, p_status)
        assert torch.equal(out, p_out) and torch.equal(status, p_status)


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
def test_cdlp_tier_apply_and_status_match_plain(cuda, share):
    """K19 (labels in place, row flags, any) and K20's status (mask,
    labels, acnt, ch, count and degree sum) against their plain versions."""
    from graphtpu_torch.ops import active as A

    rng = np.random.default_rng(int(share * 10))
    n, k = 1 << 20, 1 << 16
    labels = rng.integers(0, n, size=n + 1).astype(np.int32)
    ids = np.full(k, n, dtype=np.int32)
    ids[:50_000] = np.sort(rng.choice(n, size=50_000, replace=False))
    winners = np.where(rng.random(k) < share, rng.integers(0, n, size=k),
                       labels[np.minimum(ids, n - 1)]).astype(np.int32)
    bufs = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        buf, flags = t(labels.copy()), torch.zeros(k, dtype=torch.bool, device=dev)
        ctl = torch.zeros(A.ctl_words(1), dtype=torch.int32, device=dev)
        A.cdlp_tier_apply(buf, t(ids), t(winners), flags, ctl[A.CTL_CH])
        bufs[str(dev)[:4]] = (buf[:n].cpu(), flags.cpu(), ctl.cpu())
    (b0, f0, c0), (b1, f1, c1) = bufs["cpu"], bufs["cuda"]
    assert torch.equal(b0, b1) and torch.equal(f0, f1) and int(c0[A.CTL_CH]) == int(c1[A.CTL_CH])
    deg_pad = np.concatenate([rng.integers(0, 100, size=n), [0]]).astype(np.int32)
    new = np.where(rng.random(n) < share * 0.01, rng.integers(0, n, size=n),
                   labels[:n]).astype(np.int32)
    for k_max, e_max in ((1 << 16, 1 << 18), (1 << 18, 1 << 30)):
        got = []
        for dev in ("cpu", cuda):
            t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            lab, mask = t(labels[:n].copy()), torch.zeros(n, dtype=torch.bool, device=dev)
            ctl = torch.zeros(A.ctl_words(1), dtype=torch.int32, device=dev)
            A.cdlp_status(lab, t(new), t(deg_pad), mask, ctl, k_max, e_max)
            got.append((lab.cpu(), mask.cpu(), ctl.cpu()))
        assert all(torch.equal(a, b) for a, b in zip(*got))


def test_cdlp_route_matches_plain(cuda):
    """K20's route at every stage over a grid of control words, the
    sentinels included, against its plain version."""
    from graphtpu_torch.ops import active as A

    tiers = ((16, 64), (64, 256), (128, 4096))
    t = len(tiers)
    rng = np.random.default_rng(0)
    itermax = torch.tensor([7], dtype=torch.int32).pin_memory()
    words = [-1, 0, 1, 15, 16, 17, 64, 65, 128, 256, 4096, 4097, INT32_INF]
    for stage in range(A.STAGE_TIER + t):
        for _ in range(40):
            ctl = torch.from_numpy(rng.choice(words, size=A.ctl_words(t)).astype(np.int32))
            ctl[A.CTL_CH] = int(rng.integers(0, 2))
            ctl[A.CTL_IT], ctl[A.CTL_ITERMAX] = int(rng.integers(0, 9)), 7
            tiers_c = torch.tensor(tiers, dtype=torch.int32)
            want = ctl.clone()
            A.cdlp_route(want, tiers_c, stage, itermax)
            got = ctl.to(cuda)
            A.cdlp_route(got, tiers_c.to(cuda), stage, itermax)
            assert torch.equal(got.cpu(), want), stage


def _cdlp_inputs(scale, directed, seed=5):
    from graphtpu_torch.algorithms.cdlp import build_incidence
    from graphtpu_torch.utils.synth import rmat_graph

    g = rmat_graph(scale, 16, directed=directed, seed=seed)
    centers, neigh = build_incidence(g)
    return g, centers, neigh, np.bincount(centers, minlength=g.n).astype(np.int32)


def test_captured_tier_step_replays_like_the_plain_step(cuda):
    """A tier step captured into a CUDA graph, replayed 50 times from the
    same state, gives the plain step's labels, ids and control words every
    time: the per-call state of K12 and K14 (work queues, counters, the
    bitmap) is reset inside the captured body."""
    from graphtpu_torch.ops import active as A
    from graphtpu_torch.utils.config import PlatformConfig

    g, centers, neigh, deg = _cdlp_inputs(13, False)
    cfg = PlatformConfig(device="cuda", cdlp_frontier_rows=1 << 12, cdlp_frontier_edges=1 << 16)
    prep = A.prepare_cdlp_adaptive(g, centers, neigh, deg, cfg)
    tiers = A.cdlp_tiers(1 << 12, 1 << 16, int(deg.sum()), cfg)
    st = A._loop_state(prep, g.n, tiers, handles=False)
    st.itermax[0] = 10
    A._step_init(prep, st, g.directed)
    A._step_full(prep, st)
    A._step_full(prep, st)
    A._step_derive(prep, st)
    saved = [t.clone() for t in (st.labels_buf, st.ids, st.ctl, st.rowflag)]
    with kernels.plain_torch():
        A._step_tier(prep, st, 0)
    want = [t.clone() for t in (st.labels, st.ids, st.ctl)]
    assert not torch.equal(want[0], saved[0][:g.n]), "the tier step changed no label"

    def restore():
        for t, s in zip((st.labels_buf, st.ids, st.ctl, st.rowflag), saved):
            t.copy_(s)

    restore()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        A._step_tier(prep, st, 0)
    for _ in range(50):
        restore()
        graph.replay()
        got = (st.labels, st.ids, st.ctl)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("scale, directed, caps", [
    (12, False, {}), (13, True, {"cdlp_frontier_rows": 256, "cdlp_frontier_edges": 4096}),
    (14, False, {"cdlp_tiers": "4096,16384,65536"}), (14, True, {})])
def test_cdlp_graph_run_matches_host_run(cuda, scale, directed, caps, monkeypatch):
    """The CDLP loop as one CUDA graph (cold: built and launched; warm:
    launched, at other itermax values) against the host loop under
    plain_torch() on the card: labels, iterations and steps; one graph
    launch a run, counted where it is called, and none of the loop's own
    kernels counted from Python (the build takes its counts back out)."""
    from graphtpu_torch.ops import active as A
    from graphtpu_torch.utils.config import PlatformConfig

    g, centers, neigh, deg = _cdlp_inputs(scale, directed)
    cfg = PlatformConfig(device="cuda", **caps)
    graph_calls = []
    call = kernels.graph_call
    monkeypatch.setattr(kernels, "graph_call",
                        lambda name, *a: (graph_calls.append(name), call(name, *a))[1])
    own = ("frontier_starts", "cdlp_tier_apply", "cdlp_route", "cdlp_route_status",
           "frontier_compact_rows")
    for itermax in (10, 1, 4, 30):
        kernels.reset_launch_counts()
        graph_calls.clear()
        lab, it, stats = A.cdlp_adaptive_device_run(g, centers, neigh, deg, itermax, cfg,
                                                    with_stats=True)
        run = dict(A.last_run)
        assert run["driver"] == "graph" and graph_calls.count("graph_launch") == 1
        assert not any(kernels.launch_counts[k] for k in own), kernels.launch_counts
        assert kernels.replayed_counts["cdlp_route"] >= 1
        with kernels.plain_torch():
            p_lab, p_it, p_stats = A.cdlp_adaptive_device_run(g, centers, neigh, deg, itermax,
                                                              cfg, with_stats=True)
        assert torch.equal(lab, p_lab) and (it, stats) == (p_it, p_stats), itermax
        loop_keys = ("derives", "outer_iterations", "tier_steps")
        assert {k: run[k] for k in loop_keys} == {k: A.last_run[k] for k in loop_keys}


def test_cdlp_graph_run_makes_no_host_read_but_its_last(cuda):
    """A warm run under sync debug mode "error": the launch waits for
    nothing; only the read of the control words at its end syncs."""
    from graphtpu_torch.ops import active as A
    from graphtpu_torch.utils.config import PlatformConfig

    g, centers, neigh, deg = _cdlp_inputs(12, False)
    cfg = PlatformConfig(device="cuda")
    prep = A.prepare_cdlp_adaptive(g, centers, neigh, deg, cfg)
    tiers = A.cdlp_tiers(1 << 16, 1 << 18, int(deg.sum()), cfg)
    want = A.cdlp_adaptive_device_run(g, centers, neigh, deg, 10, cfg, prep)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        labels, ctl, loop, reads = A._launch_loop(prep, g.n, 10, g.directed, tiers)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert loop is not None and reads == 0
    assert torch.equal(labels, want[0]) and int(ctl[A.CTL_IT]) == want[1]


@pytest.mark.parametrize("n", [1, 1000, (1 << 20) + 7])
def test_wcc_jump_and_jump_status_match_plain(cuda, n):
    """K21 (the first pointer jump) and K20's status in its jump mode (the
    second jump, mask, labels, acnt, ch, count and degree sum) against their
    plain versions, on labels that point at smaller ids."""
    from graphtpu_torch.algorithms import wcc as W
    from graphtpu_torch.ops import active as A

    rng = np.random.default_rng(n % 97)
    labels = np.minimum(np.arange(n), rng.integers(0, n, size=n)).astype(np.int32)
    labels = labels[labels]
    neigh_min = np.where(rng.random(n) < 0.3, rng.integers(0, n, size=n),
                         INT32_INF).astype(np.int32)
    deg_pad = np.concatenate([rng.integers(0, 50, size=n), [0]]).astype(np.int32)
    got = []
    for dev in ("cpu", cuda):
        t = lambda a: torch.tensor(a, device=dev)  # noqa: E731 - a copy
        jumped = torch.empty(n, dtype=torch.int32, device=dev)
        before = kernels.launch_counts["wcc_jump"]
        W.wcc_jump(t(labels), t(neigh_min), jumped)
        lab, mask = t(labels.copy()), torch.zeros(n, dtype=torch.bool, device=dev)
        ctl = torch.zeros(A.ctl_words(1), dtype=torch.int32, device=dev)
        A.cdlp_status(lab, jumped, t(deg_pad), mask, ctl, 1 << 16, 1 << 18, jump=True)
        if dev != "cpu":
            assert kernels.launch_counts["wcc_jump"] == before + 1
        got.append((jumped.cpu(), lab.cpu(), mask.cpu(), ctl.cpu()))
    assert all(torch.equal(a, b) for a, b in zip(*got))


@pytest.mark.parametrize("k", [0, 1, 300, 1 << 16])
def test_cdlp_tier_apply_min_mode_matches_plain(cuda, k):
    """K19's min mode against its plain version, called again and again on
    one control word (its any is written by the last block, with no memset:
    a call that changes nothing after one that did must give 0)."""
    from graphtpu_torch.ops import active as A

    rng = np.random.default_rng(k)
    n = 1 << 20
    labels = rng.integers(0, n, size=n + 1).astype(np.int32)
    ids = np.full(k, n, dtype=np.int32)
    real = k * 3 // 4
    ids[:real] = np.sort(rng.choice(n, size=real, replace=False))
    for share in (0.5, 0.0, 1.0, 0.0):
        old = labels[np.minimum(ids, n - 1)]
        mins = np.where(rng.random(k) < share, old - rng.integers(1, 5, size=k),
                        old + rng.integers(0, 5, size=k)).astype(np.int32)
        out = []
        for dev in ("cpu", cuda):
            t = lambda a: torch.tensor(a, device=dev)  # noqa: E731 - a copy
            buf, flags = t(labels.copy()), torch.zeros(k, dtype=torch.bool, device=dev)
            ch = torch.full((), 7, dtype=torch.int32, device=dev)
            A.cdlp_tier_apply(buf, t(ids), t(mins), flags, ch, mode="min")
            out.append((buf[:n].cpu(), flags.cpu(), ch.cpu()))  # slot n: the plain one's spare
        assert all(torch.equal(a, b) for a, b in zip(*out)), share
        labels[:n] = out[0][0].numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sssp_apply_matches_plain(cuda, dtype):
    """K22 at every stage (iteration 0 from a pinned source, a full round,
    a tier round's mask) against its plain version: dist, mask and every
    control word."""
    from graphtpu_torch.algorithms import sssp as S

    rng = np.random.default_rng(3)
    n = (1 << 20) + 5
    tiers = torch.tensor([(1 << 13, 1 << 15), (1 << 16, 1 << 18)], dtype=torch.int32)
    deg_pad = np.concatenate([rng.integers(0, 40, size=n), [0]]).astype(np.int32)
    dist = (rng.random(n) * 9).astype(np.float64)
    dist[rng.random(n) < 0.4] = np.inf
    for stage, share in ((S.STAGE_INIT, 0), (S.STAGE_FULL, 0.001), (S.STAGE_FULL, 0.2),
                         (S.STAGE_TIER + 1, 0.01), (S.STAGE_TIER, 0.0)):
        relaxed = np.where(rng.random(n) < share, dist - 0.5, dist + 1)
        mask = rng.random(n) < share
        got = []
        for dev in ("cpu", cuda):
            t = lambda a: torch.tensor(a, device=dev)  # noqa: E731 - a copy
            d, m = t(dist).to(dtype), t(mask)
            ctl = torch.zeros(S.ctl_words(2), dtype=torch.int32, device=dev)
            ctl[S.SCTL_IT], ctl[S.SCTL_ITERMAX] = 3, n
            source = torch.tensor([12345], dtype=torch.int32).pin_memory()
            S.sssp_apply(d, t(relaxed).to(dtype) if stage == S.STAGE_FULL else None, m,
                         t(deg_pad), source, ctl, tiers.to(dev), stage, n)
            got.append((d.cpu(), m.cpu(), ctl.cpu()))
        assert all(torch.equal(a, b) for a, b in zip(*got)), (stage, share)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("count", [0, 1, 2000, 1 << 13])
def test_relax_min_into_matches_plain(cuda, dtype, count):
    """K8's in-place mode against its plain version on a frontier whose
    vertices are also targets of the same round: dist and the mask."""
    from graphtpu_torch.ops.frontier import relax_min_into, relax_min_into_plain

    rng = np.random.default_rng(count)
    n, k, e_cap = 1 << 16, 1 << 13, 1 << 17
    deg = rng.integers(0, 12, size=n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    ids = np.full(k, n, dtype=np.int32)
    ids[:count] = np.sort(rng.choice(n, size=count, replace=False))
    dst = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    if count:
        dst[::4] = ids[rng.integers(0, count, size=dst[::4].shape[0])]
    w = rng.random(int(indptr[-1])) * 3
    dist = rng.random(n) * 20
    dist[rng.random(n) < 0.3] = np.inf
    deg_pad = np.concatenate([deg, [0]]).astype(np.int32)
    got = []
    for dev in ("cpu", cuda):
        t = lambda a: torch.tensor(a, device=dev)  # noqa: E731 - a copy
        exp = expand(t(ids), t(deg_pad), t(indptr), t(dst), e_cap, with_row_ids=False)
        d, m = t(dist).to(dtype), torch.ones(n, dtype=torch.bool, device=dev)
        (relax_min_into if dev != "cpu" else relax_min_into_plain)(
            d, t(ids), exp, t(w).to(dtype), m)
        got.append((d.cpu(), m.cpu()))
    assert all(torch.equal(a, b) for a, b in zip(*got))


def _wcc_graph(scale, directed, seed=5):
    from graphtpu_torch.utils.synth import rmat_graph

    return rmat_graph(scale, 8, directed=directed, seed=seed)


@pytest.mark.parametrize("scale, directed, impl, caps", [
    (12, False, "auto", {}), (13, True, "adaptive", {}),
    (14, False, "auto", {"wcc_frontier_rows": 256, "wcc_frontier_edges": 4096}),
    (14, True, "adaptive", {"wcc_frontier_rows": 64, "wcc_frontier_edges": 1024}),
    ("walk", False, "auto", {"wcc_frontier_rows": 16, "wcc_frontier_edges": 512}),
    ("walk", False, "adaptive", {"wcc_frontier_rows": 16, "wcc_frontier_edges": 512})])
def test_wcc_graph_run_matches_host_run(cuda, scale, directed, impl, caps, monkeypatch):
    """The WCC loop as one CUDA graph (cold: built and launched; warm:
    launched again) against the host loop under plain_torch() on the card:
    labels, iterations and steps; one graph launch a run, counted where it
    is called, and none of the loop's own kernels counted from Python."""
    from graphtpu_torch.algorithms import wcc as W
    from graphtpu_torch.utils.config import PlatformConfig

    g = _wcc_walk_graph() if scale == "walk" else _wcc_graph(scale, directed)
    cfg = PlatformConfig(device="cuda", wcc_impl=impl, **caps)
    graph_calls = []
    call = kernels.graph_call
    monkeypatch.setattr(kernels, "graph_call",
                        lambda name, *a: (graph_calls.append(name), call(name, *a))[1])
    own = ("wcc_jump", "cdlp_route", "cdlp_route_status_jump", "cdlp_tier_apply_min",
           "frontier_starts")
    for _ in range(3):
        kernels.reset_launch_counts()
        graph_calls.clear()
        lab, it, stats = W.wcc_adaptive_run(g, cfg, with_stats=True)
        run = dict(W.last_run)
        assert run["driver"] == "graph" and graph_calls.count("graph_launch") == 1
        assert not any(kernels.launch_counts[k] for k in own), kernels.launch_counts
        assert kernels.replayed_counts["wcc_jump"] == stats["full_steps"]
        with kernels.plain_torch():
            p_lab, p_it, p_stats = W.wcc_adaptive_run(g, cfg, with_stats=True)
        assert torch.equal(lab, p_lab) and (it, stats) == (p_it, p_stats)
        assert {k: run[k] for k in ("derives", "outer_iterations")} == \
            {k: W.last_run[k] for k in ("derives", "outer_iterations")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tiers", ["", "64,1024,16384"])
def test_sssp_graph_run_matches_host_run(cuda, dtype, tiers, monkeypatch):
    """The SSSP loop as one CUDA graph against the host loop under
    plain_torch() on the card, from several sources (the source is read
    from pinned memory, so one graph serves all): distances bit for bit,
    rounds and rounds by phase; one graph launch a run."""
    from graphtpu_torch.algorithms import sssp as S
    from graphtpu_torch.utils.config import PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    g = rmat_graph(14, 8, directed=True, weighted=True, seed=3)
    cfg = PlatformConfig(device="cuda", sssp_tiers=tiers)
    graph_calls = []
    call = kernels.graph_call
    monkeypatch.setattr(kernels, "graph_call",
                        lambda name, *a: (graph_calls.append(name), call(name, *a))[1])
    for src in (0, 5, 77, 0):
        kernels.reset_launch_counts()
        graph_calls.clear()
        dist, it, stats = S.sssp_adaptive_run(g, src, cfg, dtype, with_stats=True)
        assert S.last_run["driver"] == "graph" and graph_calls.count("graph_launch") == 1
        assert not kernels.launch_counts["sssp_apply"]
        assert kernels.replayed_counts["sssp_apply"] == it + 1
        with kernels.plain_torch():
            p_dist, p_it, p_stats = S.sssp_adaptive_run(g, src, cfg, dtype, with_stats=True)
        assert torch.equal(dist, p_dist) and (it, stats) == (p_it, p_stats), src


def _wcc_walk_graph():
    """An undirected RMAT s12 graph and a path of 40 vertices from its
    component's smallest id into a hub of 100 leaves (the smallest id but
    one a leaf): the smallest label walks the path in active steps, one hop
    a step, each step changing a label."""
    from graphtpu_torch.core.graph import Graph

    rmat = _wcc_graph(12, False)
    rng = np.random.default_rng(12)
    m, d = 40, 100
    ids = rmat.n + np.concatenate([[0], 2 + rng.permutation(m + d - 1)])
    leaves = np.concatenate([[rmat.n + 1], ids[m + 1:]])[:d]
    s2 = np.concatenate([ids[:m - 1], [ids[m - 1]], np.full(d, ids[m])])
    t2 = np.concatenate([ids[1:m], [ids[m]], leaves])
    src = np.concatenate([rmat.src, s2, t2])
    dst = np.concatenate([rmat.dst, t2, s2])
    order = np.lexsort((dst, src))
    n = rmat.n + m + 1 + d
    return Graph.from_arrays(n, src[order], dst[order], None, np.arange(n, dtype=np.uint64),
                             False, False)


def test_captured_wcc_active_step_replays_like_the_plain_step(cuda):
    """A WCC active step captured into a CUDA graph, replayed 50 times from
    the same state, gives the plain step's labels, ids and control words
    every time (K19's any, written by its last block, included)."""
    from graphtpu_torch.algorithms import wcc as W
    from graphtpu_torch.ops import active as A

    g = _wcc_walk_graph()
    prep = W.wcc_prep(g, "cuda")
    st = W._loop_state(prep, None, g.n, ((16, 512),), handles=False)
    st.itermax[0] = g.n
    steps = dict(W._steps(prep, None, st))
    cond = lambda c: bool(st.ctl[A.CTL_COND + c])  # noqa: E731
    steps["init"]()
    while cond(A.COND_OUTER) and not cond(A.COND_TIER):  # the host loop up to an active step
        while cond(A.COND_FULL):
            steps["full"]()
        if cond(A.COND_DERIVE):
            steps["derive"]()
        steps["boundary"]()
    assert cond(A.COND_TIER), "the run reached no active step"
    bufs = (st.labels_buf, st.ids, st.ctl, st.rowflag)
    saved = [t.clone() for t in bufs]
    with kernels.plain_torch():
        W._step_active(prep, st)
    want = [t.clone() for t in (st.labels, st.ids, st.ctl)]
    assert int(want[2][A.CTL_CH]) == 1, "the active step changed no label"

    def restore():
        for t, s in zip(bufs, saved):
            t.copy_(s)

    restore()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        W._step_active(prep, st)
    for _ in range(50):
        restore()
        graph.replay()
        assert all(torch.equal(a, b) for a, b in zip((st.labels, st.ids, st.ctl), want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_captured_sssp_tier_step_replays_like_the_plain_step(cuda, dtype):
    """An SSSP tier round captured into a CUDA graph, replayed 50 times from
    the same state, gives the plain round's distances, mask, ids and
    control words every time."""
    from graphtpu_torch.algorithms import sssp as S
    from graphtpu_torch.utils.synth import rmat_graph

    g = rmat_graph(14, 8, directed=False, weighted=True, seed=2)
    prep = S.sssp_prep(g, dtype, "cuda")
    st = S._loop_state(prep, g.n, ((1 << 12, 1 << 16),), handles=False)
    st.source[0] = 0
    S._step_init(prep, st)
    S._step_tier(prep, st, 0)
    bufs = (st.dist, st.mask, st.ids, st.ctl)
    saved = [t.clone() for t in bufs]
    with kernels.plain_torch():
        S._step_tier(prep, st, 0)
    want = [t.clone() for t in bufs]

    def restore():
        for t, s in zip(bufs, saved):
            t.copy_(s)

    restore()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        S._step_tier(prep, st, 0)
    for _ in range(50):
        restore()
        graph.replay()
        assert all(torch.equal(a, b) for a, b in zip(bufs, want))


def test_wcc_and_sssp_graph_runs_make_no_host_read_but_their_last(cuda):
    """Warm runs under sync debug mode "error": the launch waits for nothing;
    only the read of the control words at their end syncs."""
    from graphtpu_torch.algorithms import sssp as S
    from graphtpu_torch.algorithms import wcc as W
    from graphtpu_torch.ops import active as A
    from graphtpu_torch.utils.config import PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    g = _wcc_graph(13, False)
    cfg = PlatformConfig(device="cuda")
    want = W.wcc_adaptive_run(g, cfg)
    sym = g.symmetrized()
    prep, plan = W.wcc_prep(sym, "cuda"), W.wcc_slab_plan(sym, "cuda")
    gw = rmat_graph(13, 8, directed=False, weighted=True, seed=1)
    s_want = S.sssp_adaptive_run(gw, 0, cfg)
    s_prep = S.sssp_prep(gw, torch.float32, "cuda")
    tiers = S.sssp_tiers(1 << 16, 1 << 18, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        labels, ctl, loop, reads = W._launch_loop(sym, prep, plan, ((1 << 16, 1 << 18),))
        dist, s_ctl, s_loop, s_reads = S._launch_loop(gw, s_prep, 0, tiers)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert loop is not None and reads == 0 and s_loop is not None and s_reads == 0
    assert torch.equal(labels, want[0]) and int(ctl[A.CTL_IT]) == want[1]
    assert torch.equal(dist, s_want[0]) and int(s_ctl[S.SCTL_IT]) == s_want[1]


# ------------------------------------------------- BFS's device loops (K23)


def _bfs_state(rng, n, level):
    """Levels of a BFS at ``level`` (about half the vertices reached) and
    out-degrees [n+1]."""
    levels = np.where(rng.random(n) < 0.5, rng.integers(0, level + 1, size=n),
                      INT32_INF).astype(np.int32)
    return levels, np.concatenate([rng.integers(0, 40, size=n), [0]]).astype(np.int32)


def test_bfs_apply_matches_plain(cuda):
    """K23 at every stage (the source from pinned memory, a tier step applied
    and aborted, a bottom-up ok and aborted on rows and on edges, a dense
    step, the dense nest without degrees) against its plain version at n =
    2^20 + 5: levels, the dense frontier and every control word."""
    from graphtpu_torch.algorithms import bfs as B

    rng = np.random.default_rng(5)
    n, level, k_bu, e_bu = (1 << 20) + 5, 3, 1 << 15, 1 << 18
    budgets = ((1 << 16, 1 << 16), (1 << 18, 1 << 18), (1 << 18, 1 << 22))
    levels, deg_pad = _bfs_state(rng, n, level)
    unvis = np.flatnonzero(levels == INT32_INF)
    fmask = (rng.random(n) < 0.1).astype(np.int32)
    cases = [("init", B.STAGE_INIT, {})]
    for i, over in ((0, 0), (1, 0), (1, 5), (2, 1)):
        k = budgets[i][0]
        ids = np.full(k, n, dtype=np.int32)
        take = np.sort(rng.choice(unvis, size=k - 100 * (i + 1), replace=False))
        ids[:take.shape[0]] = take
        cnt = take.shape[0] + over * k
        cases.append((f"tier{i}+{over}", B.STAGE_TIER + i,
                      dict(ids=ids, stat=np.array([cnt, int(deg_pad[ids].sum())], np.int32))))
    claim = np.zeros(n, bool)
    claim[unvis[::7]] = True
    claimed = np.full(k_bu, n, dtype=np.int32)
    rest = np.setdiff1d(unvis, unvis[::7])
    claimed[:3000] = rest[:3000]
    for rcnt, fe_r in ((3000, 12000), (k_bu + 1, 100), (3000, e_bu + 1)):
        cases.append((f"bu {rcnt} {fe_r}", B.STAGE_BU,
                      dict(claim=claim, ids=claimed, stat=np.array([rcnt, fe_r], np.int32))))
    cases.append(("dense", B.STAGE_DENSE, dict(reached=(rng.random(n) < 0.2).astype(np.int32))))
    for what, stage, kw in cases + [("dense nest", B.STAGE_DENSE, dict(cases[-1][2], no_deg=1))]:
        got = []
        for dev in ("cpu", cuda):
            t = lambda a: torch.tensor(a, device=dev)  # noqa: E731 - a copy
            tiers = torch.zeros((0, 2), dtype=torch.int32) if "no_deg" in kw else \
                torch.tensor(budgets, dtype=torch.int32)
            ctl = torch.zeros(B.ctl_words(tiers.shape[0]), dtype=torch.int32, device=dev)
            ctl[:B.BCTL_COND] = t([7, 99, level, 1, n])
            lev, fm = t(levels), t(fmask)
            args = {k: t(v) for k, v in kw.items() if k != "no_deg"}
            source = torch.tensor([12345], dtype=torch.int32).pin_memory()
            B.bfs_apply(lev, fm, ctl, tiers.to(dev), stage, n,
                        deg_pad=None if "no_deg" in kw else t(deg_pad), source=source,
                        k_bu=k_bu, e_bu=e_bu, **args)
            got.append((lev.cpu(), fm.cpu(), ctl.cpu()))
        assert all(torch.equal(a, b) for a, b in zip(*got)), what


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 300007, (1 << 20) + 3])
def test_frontier_compact_level_and_into_match_plain(cuda, n):
    """K14's level mode (the level read on the card) and the mask entry with
    its degree sum against their plain versions: ids cut below the count,
    exact and padded; one launch a call, each under its own counter."""
    from graphtpu_torch.ops.frontier import compact_into, compact_level_into

    rng = np.random.default_rng(n)
    levels = np.where(rng.random(n) < 0.5, rng.integers(0, 4, size=n), INT32_INF).astype(np.int32)
    deg_pad = np.concatenate([rng.integers(0, 40, size=n), [0]]).astype(np.int32)
    mask = rng.random(n) < 0.2
    for level in (0, 2, 9):
        cnt = int((levels == level).sum())
        for k in sorted({1, max(cnt - 1, 1), max(cnt, 1), cnt + 5}):
            got = []
            for dev in ("cpu", cuda):
                t = lambda a: torch.tensor(a, device=dev)  # noqa: E731 - a copy
                ids = torch.full((k,), -1, dtype=torch.int32, device=dev)
                count = torch.full((1,), -1, dtype=torch.int32, device=dev)
                before = dict(kernels.launch_counts)
                compact_level_into(t(levels), t([level]).to(torch.int32), ids, count)
                if dev != "cpu":
                    assert kernels.launch_counts["frontier_compact_level"] == \
                        before["frontier_compact_level"] + 1
                out, status = torch.full((k,), -1, dtype=torch.int32, device=dev), \
                    torch.full((2,), -1, dtype=torch.int32, device=dev)
                compact_into(t(mask), t(deg_pad), out, status)
                if dev != "cpu":
                    assert kernels.launch_counts["frontier_compact"] == \
                        before["frontier_compact"] + 1
                got.append([x.cpu() for x in (ids, count, out, status)])
            assert all(torch.equal(a, b) for a, b in zip(*got)), (level, k)
            assert int(got[0][1]) == cnt


@pytest.mark.parametrize("k_out", [16, 4096, 1 << 18])
def test_frontier_compact_unvisited_matches_plain(cuda, k_out):
    """K14's unvisited mode against its plain version on random expansions
    (a cut one included): ids, count and degree sum bit for bit, one
    launch a call."""
    from graphtpu_torch.ops.frontier import compact_unvisited_into, compact_unvisited_plain

    rng = np.random.default_rng(k_out)
    n = 100_000
    levels = np.where(rng.random(n) < 0.6, 1, INT32_INF).astype(np.int32)
    for k, e_cap, count in ((4096, 1 << 18, 3000), (1 << 16, 1 << 16, 20_000)):
        exp, deg_pad = _expansion(cuda, rng, n, k, e_cap, count)
        got = []
        for plain in (False, True):
            out = torch.full((k_out,), -1, dtype=torch.int32, device=cuda)
            status = torch.full((2,), -1, dtype=torch.int32, device=cuda)
            before = kernels.launch_counts["frontier_compact_unvisited"]
            (compact_unvisited_plain if plain else compact_unvisited_into)(
                exp, torch.from_numpy(levels).to(cuda), n, deg_pad, out, status)
            assert kernels.launch_counts["frontier_compact_unvisited"] == before + (not plain)
            got.append((out.cpu(), status.cpu()))
        assert all(torch.equal(a, b) for a, b in zip(*got)), (k, e_cap)


def test_trunc_probe_and_residual_claim_read_the_level_on_the_card(cuda):
    """K13 and K17 given the level as a one-element tensor on the card (their
    device-level modes) against their scalar forms and plain versions, each
    counted under its own name."""
    from graphtpu_torch.ops.frontier import expand

    rng = np.random.default_rng(13)
    n, t, level, k, e_cap = 100003, 2, 3, 1 << 12, 1 << 16
    levels, deg_pad = _bfs_state(rng, n, 4)
    trunc = rng.integers(0, n + 1, size=t * n).astype(np.int32)
    pdeg = rng.integers(0, 6, size=n).astype(np.int32)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    lev, at = tt(levels), tt(np.array([level], np.int32))
    before = dict(kernels.launch_counts)
    got = bfs_trunc_probe(lev, at, tt(trunc), tt(pdeg), t)
    assert kernels.launch_counts["bfs_trunc_probe_at"] == before["bfs_trunc_probe_at"] + 1
    want = bfs_trunc_probe(lev, level, tt(trunc), tt(pdeg), t)
    plain = bfs_trunc_probe_plain(lev.cpu(), at.cpu(), tt(trunc).cpu(), tt(pdeg).cpu(), t)
    assert all(torch.equal(a, b) and torch.equal(a.cpu(), c) for a, b, c in zip(got, want, plain))
    indptr = np.concatenate([[0], np.cumsum(deg_pad[:-1])]).astype(np.int32)
    neigh = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    rids = np.full(k, n, dtype=np.int32)
    rids[:3000] = np.sort(rng.choice(n, size=3000, replace=False))
    exp = expand(tt(rids), tt(deg_pad), tt(indptr), tt(neigh), e_cap, with_row_ids=False)
    before = dict(kernels.launch_counts)
    claimed = residual_claim(lev, at, exp, e_cap, tt(rids), n)
    assert kernels.launch_counts["bfs_residual_claim_at"] == before["bfs_residual_claim_at"] + 1
    assert torch.equal(claimed, residual_claim(lev, level, exp, e_cap, tt(rids), n))
    assert torch.equal(claimed, residual_claim_plain(lev, at, exp, e_cap, tt(rids), n))


def _bfs_graph(scale, directed, seed=4):
    from graphtpu_torch.utils.synth import rmat_graph

    return rmat_graph(scale, 8, directed=directed, seed=seed)


# (scale, directed, caps): the defaults; rows capped at 64 (tier aborts climb
# through the 2^18, 2^20 and 2^22 tiers' captures to bottom-up); small edge
# tiers and bottom-up budgets (aborted bottom-ups, dense steps)
BFS_GRAPH_CASES = [
    (13, False, {}), (14, True, {"bfs_frontier_rows": 64}),
    (14, False, {"bfs_frontier_rows": 64}),
    (12, True, {"bfs_push_tiers": "64,512,4096", "bfs_frontier_rows": 32, "bfs_bu_rows": 16,
                "bfs_bu_edges": 256}),
    (12, False, {"bfs_push_tiers": "64,512", "bfs_frontier_rows": 64, "bfs_bu_rows": 64,
                 "bfs_bu_edges": 1024, "bfs_trunc": 1}),
]


@pytest.mark.parametrize("case", range(len(BFS_GRAPH_CASES)))
def test_bfs_graph_run_matches_host_run(cuda, case, monkeypatch):
    """BFS auto as one CUDA graph (cold: built and launched; warm: launched
    again) against the host loop under plain_torch() on the card, from
    several sources (one graph serves all: the source is read from pinned
    memory): levels bit for bit, levels done and every step count; one
    graph launch a run, none of the loop's kernels counted from Python, K23
    once a step and once more at init. Then bfs-impl=device's graph the
    same way."""
    from graphtpu_torch.algorithms import bfs as B
    from graphtpu_torch.utils.config import PlatformConfig

    scale, directed, caps = BFS_GRAPH_CASES[case]
    g = _bfs_graph(scale, directed)
    cfg = PlatformConfig(device="cuda", **caps)
    graph_calls = []
    call = kernels.graph_call
    monkeypatch.setattr(kernels, "graph_call",
                        lambda name, *a: (graph_calls.append(name), call(name, *a))[1])
    own = ("bfs_apply", "frontier_compact_level", "frontier_compact_unvisited",
           "bfs_trunc_probe_at", "bfs_residual_claim_at", "frontier_starts")
    seen = np.zeros(3, dtype=np.int64)  # tier, bottom-up, dense steps
    tier_seen = {e: 0 for _, e in B.bfs_ladder(g.n, cfg)[1]}  # steps by edge budget
    for src in (0, 5, 77, 0):
        kernels.reset_launch_counts()
        graph_calls.clear()
        lev, it, stats = B.bfs_adaptive_run(g, src, cfg, with_stats=True)
        assert B.last_run["driver"] == "graph" and graph_calls.count("graph_launch") == 1
        assert not any(kernels.launch_counts[k] for k in own), kernels.launch_counts
        steps = sum(stats["tier_steps"].values()) + stats["bu_steps"] + stats["dense_steps"]
        assert kernels.replayed_counts["bfs_apply"] == steps + 1
        assert kernels.replayed_counts["bfs_trunc_probe_at"] == stats["bu_steps"]
        seen += [steps - stats["bu_steps"] - stats["dense_steps"], stats["bu_steps"],
                 stats["dense_steps"]]
        for e, c in stats["tier_steps"].items():
            tier_seen[e] += c
        with kernels.plain_torch():
            p_lev, p_it, p_stats = B.bfs_adaptive_run(g, src, cfg, with_stats=True)
        assert torch.equal(lev, p_lev) and (it, stats) == (p_it, p_stats), src
        kernels.reset_launch_counts()
        d_lev, d_it = B._bfs_kernel(g, src, "cuda")
        assert B.last_run["driver"] == "graph"
        assert kernels.replayed_counts["csr_pull_reduce"] == d_it
        with kernels.plain_torch():
            p_lev, p_it = B._bfs_kernel(g, src, "cuda")
        assert torch.equal(d_lev, p_lev) and d_it == p_it and torch.equal(d_lev, lev), src
    assert seen[0] > 0, seen
    if caps == {"bfs_frontier_rows": 64}:  # tier aborts reach the top tiers' captures
        assert tier_seen[1 << 20] > 0 and tier_seen[1 << 22] > 0, tier_seen
    if case == 3:
        assert seen[1] > 0 and seen[2] > 0, seen


def test_captured_bfs_steps_replay_like_the_plain_steps(cuda):
    """A BFS tier step, bottom-up step and dense step, each captured into a
    CUDA graph and replayed 20 times from the same state, give the plain
    step's levels, frontier, ids and control words every time."""
    import functools

    from graphtpu_torch.algorithms import bfs as B

    g = _bfs_graph(13, False, seed=2)
    t_trunc, budgets, k_bu, e_bu = 2, ((1 << 12, 1 << 16),), 1 << 12, 1 << 16
    prep = B.bfs_adaptive_prep(g, t_trunc, "cuda")
    st = B._loop_state("cuda", g.n, budgets, k_bu, e_bu, B.loop_nest(1), handles=False)
    st.source[0] = 0
    B._step_init(prep.deg_pad, st)
    B._step_tier(prep, st, 0)  # level 1
    bufs = (st.levels, st.fmask, st.ids, st.ids2, st.rids, st.stat, st.ctl)
    saved = [x.clone() for x in bufs]

    def restore():
        for x, s in zip(bufs, saved):
            x.copy_(s)

    for step in (functools.partial(B._step_tier, prep, st, 0),
                 functools.partial(B._step_bu, prep, st),
                 functools.partial(B._step_dense, prep.pull, prep.deg_pad, st)):
        restore()
        with kernels.plain_torch():
            step()
        want = [x.clone() for x in bufs]
        restore()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for _ in range(20):
            restore()
            graph.replay()
            assert all(torch.equal(a, b) for a, b in zip(bufs, want)), step.func.__name__


def test_bfs_graph_runs_make_no_host_read_but_their_last(cuda):
    """Warm runs of BFS auto's and bfs-impl=device's graphs under sync debug
    mode "error": the launch waits for nothing; only the read of the control
    words at their end syncs."""
    from graphtpu_torch.algorithms import bfs as B
    from graphtpu_torch.utils.config import PlatformConfig

    g = _bfs_graph(13, False)
    cfg = PlatformConfig(device="cuda")
    want = B.bfs_adaptive_run(g, 0, cfg)  # cold: each graph built and memoized on g
    d_want = B._bfs_kernel(g, 0, "cuda")
    spec, d_spec = B._auto_loop(g, cfg)[1], B._dense_loop(g, "cuda")
    loop, d_loop = g.memo[spec.key], g.memo[d_spec.key]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:  # warm: the memoized graphs, so no state is made
        lev, ctl, got, reads = B._launch_loop(g, spec, 0)
        d_lev, d_ctl, d_got, d_reads = B._launch_loop(g, d_spec, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got is loop and d_got is d_loop and reads == d_reads == 0
    assert torch.equal(lev, want[0]) and int(ctl[B.BCTL_LEVEL]) == want[1]
    assert torch.equal(d_lev, d_want[0]) and int(d_ctl[B.BCTL_LEVEL]) == d_want[1]


def test_loop_graph_freed_during_a_capture_leaves_it_valid(cuda):
    """A loop graph freed while another graph is being captured (here its
    last reference dropped inside the capture; in a run, a garbage
    collection that a step's Python calls trigger) leaves that capture
    valid: its graphs are freed at the next build of a loop graph."""
    import gc

    from graphtpu_torch.algorithms import bfs as B
    from graphtpu_torch.ops import device_loop

    g = _bfs_graph(10, False)
    want = B._bfs_kernel(g, 0, "cuda")  # bfs-impl=device's graph, memoized on g
    root = g.memo[("bfs_dense_loop", "cuda")].root.value
    gc.collect()  # loop graphs of earlier tests freed now, outside the capture
    x = torch.arange(1000, dtype=torch.int32, device="cuda")
    y = torch.empty_like(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        torch.add(x, 1, out=y)
        g.memo.clear()  # the loop graph's last reference
        gc.collect()
        torch.mul(y, 2, out=y)
    assert [r.value for r, _, _ in device_loop._deferred] == [root]
    graph.replay()
    assert torch.equal(y, (x + 1) * 2)
    lev, it = B._bfs_kernel(_bfs_graph(10, False), 0, "cuda")
    assert not device_loop._deferred
    assert torch.equal(lev, want[0]) and it == want[1]


# ------------------- delta-stepping's device loop (K24, K8's settle mode, K14's bucket mode)
# ------------------- and the fixed-point loops (K25)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 33, 1000, 300007, (1 << 20) + 3])
def test_frontier_compact_bucket_matches_plain(cuda, dtype, n):
    """K14's bucket mode (the bucket read on the card, with and without the
    changed mask, the degree sum) against its plain version: ids, count and
    sum; distances on bucket borders, infinite and past int32's buckets."""
    from graphtpu_torch.ops.frontier import compact_bucket_into, compact_bucket_plain

    rng = np.random.default_rng(n)
    delta = 0.3
    inv = float(torch.tensor(1.0 / delta, dtype=dtype))
    dist = (rng.random(n) * 6).astype(np.float64)
    dist[rng.random(n) < 0.2] = np.inf
    on = rng.random(n) < 0.1  # on a bucket's border
    dist[on] = rng.integers(0, 20, size=int(on.sum())) * delta
    dist[rng.random(n) < 0.01] = 2.0**40
    mask = rng.random(n) < 0.5
    deg_pad = np.concatenate([rng.integers(0, 30, size=n), [0]]).astype(np.int32)
    for k_bucket in (0, 3, 10, 100):
        for k in (1, 1 << 10, 1 << 16):
            for use_mask in (False, True):
                got = []
                for dev in ("cpu", cuda):
                    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731 - a copy
                    ids = torch.full((k,), -1, dtype=torch.int32, device=dev)
                    status = torch.zeros(2, dtype=torch.int32, device=dev)
                    k_at = torch.tensor([k_bucket], dtype=torch.int32, device=dev)
                    (compact_bucket_into if dev != "cpu" else compact_bucket_plain)(
                        t(dist).to(dtype), inv, k_at, t(mask) if use_mask else None,
                        t(deg_pad), ids, status)
                    got.append((ids.cpu(), status.cpu()))
                assert all(torch.equal(a, b) for a, b in zip(*got)), (k_bucket, k, use_mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("count", [0, 1, 2000, 1 << 13])
def test_relax_min_settle_matches_plain(cuda, dtype, count):
    """K8's settle mode against its plain version on a frontier whose
    vertices are also targets of the same step, and without an expansion
    (a weight class without edges): dist and the changed mask."""
    from graphtpu_torch.ops.frontier import relax_min_settle, relax_min_settle_plain

    rng = np.random.default_rng(count + 1)
    n, k, e_cap = 1 << 16, 1 << 13, 1 << 17
    deg = rng.integers(0, 12, size=n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    ids = np.full(k, n, dtype=np.int32)
    ids[:count] = np.sort(rng.choice(n, size=count, replace=False))
    dst = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    if count:
        dst[::4] = ids[rng.integers(0, count, size=dst[::4].shape[0])]
    w = rng.random(int(indptr[-1])) * 3
    dist = rng.random(n) * 20
    dist[rng.random(n) < 0.3] = np.inf
    changed = rng.random(n) < 0.5
    deg_pad = np.concatenate([deg, [0]]).astype(np.int32)
    for with_exp in (True, False):
        got = []
        for dev in ("cpu", cuda):
            t = lambda a: torch.tensor(a, device=dev)  # noqa: E731 - a copy
            exp = expand(t(ids), t(deg_pad), t(indptr), t(dst), e_cap, with_row_ids=False) \
                if with_exp else None
            d, ch = t(dist).to(dtype), t(changed)
            (relax_min_settle if dev != "cpu" else relax_min_settle_plain)(
                d, t(ids), exp, t(w).to(dtype), ch)
            got.append((d.cpu(), ch.cpu()))
        assert all(torch.equal(a, b) for a, b in zip(*got)), with_exp


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sssp_delta_route_matches_plain(cuda, dtype):
    """K24 at every stage (init from a pinned source, the derives' routes at
    and past the capacities and the step limit, the steps' counts, the
    advance over 2^20 + 5 distances with infinite ones and ones past int32's
    buckets) against its plain version: dist, changed and every word."""
    from graphtpu_torch.algorithms import sssp as S

    rng = np.random.default_rng(7)
    n, k_cap, e_cap = (1 << 20) + 5, 1 << 10, 1 << 14
    inv = float(torch.tensor(1.0 / 0.3, dtype=dtype))
    dist = rng.random(n) * 50
    dist[rng.random(n) < 0.3] = np.inf
    dist[rng.random(n) < 0.001] = 2.0**40
    changed = rng.random(n) < 0.3
    words = [(3, 5, 40, 100, 2000), (3, 5, 40, 0, 0), (3, 40, 40, 100, 200),
             (3, 5, 40, k_cap + 1, 10), (3, 5, 40, 10, e_cap + 1), (160, 5, 40, 0, 0),
             (int(np.floor(50 * inv)), 7, 40, 1, 1)]
    for stage in range(S.DSTAGE_ADVANCE + 1):
        for word in (words[:1] if stage == S.DSTAGE_INIT else words):
            got = []
            for dev in ("cpu", cuda):
                t = lambda a: torch.tensor(a, device=dev)  # noqa: E731 - a copy
                d, ch = t(dist).to(dtype), t(changed)
                ctl = torch.full((S.DCTL_WORDS,), 9, dtype=torch.int32, device=dev)
                ctl[:5] = t(list(word)).to(torch.int32)
                source = torch.tensor([12345], dtype=torch.int32).pin_memory()
                S.sssp_delta_route(d, ch, source, ctl, stage, inv, 4 * n, k_cap, e_cap)
                got.append((d.cpu(), ch.cpu(), ctl.cpu()))
            assert all(torch.equal(a, b) for a, b in zip(*got)), (stage, word)


def test_fixed_point_route_matches_plain(cuda):
    """K25 in its compare mode (with and without the degrees), its flag mode
    and at init (limit and skip from pinned memory) against its plain
    version: the labels and every control word."""
    from graphtpu_torch.ops import fixed_point as F

    rng = np.random.default_rng(9)
    n = (1 << 20) + 7
    old = rng.integers(0, n, size=n).astype(np.int32)
    deg = (rng.random(n) < 0.8).astype(np.int32)
    cases = [(share, use_deg, word) for share in (0.0, 1e-6, 0.3) for use_deg in (False, True)
             for word in ((0, 10, 0), (9, 10, 0), (1, 10, 3))]
    for share, use_deg, word in cases + [("flag", c, (2, 10, 0)) for c in (0, 4)] + [
            ("init", s, (0, 0, 0)) for s in (0, 1)]:
        if not isinstance(share, str):
            new = np.where(rng.random(n) < share, rng.integers(0, n, size=n), old)
        got = []
        for dev in ("cpu", cuda):
            t = lambda a: torch.tensor(a, device=dev)  # noqa: E731 - a copy
            fp = F.control(dev, False)
            fp.ctl[:3] = t(list(word)).to(torch.int32)
            fp.params[0], fp.params[1] = 10, 2
            o = t(old)
            if share == "init":
                F.fixed_point_route(fp, F.STAGE_INIT, start=use_deg)
            elif share == "flag":
                F.fixed_point_route(fp, F.STAGE_STEP, flag=t([use_deg]).to(torch.int32)[0])
            else:
                F.fixed_point_route(fp, F.STAGE_STEP, old=o, new=t(new).to(torch.int32),
                                    deg=t(deg) if use_deg else None)
            got.append((o.cpu(), fp.ctl.cpu()))
        assert all(torch.equal(a, b) for a, b in zip(*got)), (share, use_deg, word)


def _count_graph_calls(monkeypatch):
    graph_calls = []
    call = kernels.graph_call
    monkeypatch.setattr(kernels, "graph_call",
                        lambda name, *a: (graph_calls.append(name), call(name, *a))[1])
    return graph_calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["2.5", "0.3", "tiny", "torus"])
def test_delta_graph_run_matches_host_run(cuda, dtype, case, monkeypatch):
    """Delta-stepping as one CUDA graph against the host loop under
    plain_torch() on the card, from several sources (read from pinned
    memory): distances bit for bit, steps and every counter; one graph
    launch a run and none of the loop's own kernels counted from Python;
    at delta 2.5 the heavy class is empty, at 0.3 both hold edges, tiny
    capacities force both dense fallbacks, and a torus walks many buckets."""
    from graphtpu_torch.algorithms import sssp as S
    from graphtpu_torch.utils.config import PlatformConfig
    from graphtpu_torch.utils.synth import grid_graph, rmat_graph

    if case == "torus":
        g, over = grid_graph(64, torus=True, seed=2), {"sssp_delta": 0.4}
    else:
        g = rmat_graph(13, 8, directed=True, weighted=True, seed=3)
        over = {"2.5": {"sssp_delta": 2.5}, "0.3": {"sssp_delta": 0.3},
                "tiny": {"sssp_delta": 0.3, "sssp_frontier_rows": 8,
                         "sssp_frontier_edges": 64}}[case]
    cfg = PlatformConfig(device="cuda", **over)
    graph_calls = _count_graph_calls(monkeypatch)
    own = ("sssp_delta_route", "frontier_compact_bucket", "push_relax_min_settle",
           "frontier_starts", "sssp_apply")
    for src in (0, 5, 77, 0):
        kernels.reset_launch_counts()
        graph_calls.clear()
        dist, it, stats = S.sssp_delta_run(g, src, cfg, dtype, with_stats=True)
        assert S.last_run["driver"] == "graph" and graph_calls.count("graph_launch") == 1
        assert not any(kernels.launch_counts[k] for k in own), kernels.launch_counts
        runs = S.delta_runs([0] * S.DCTL_COUNTS + [stats[k] for k in S.DELTA_COUNTS])
        assert kernels.replayed_counts["sssp_delta_route"] == sum(runs.values())
        with kernels.plain_torch():
            p_dist, p_it, p_stats = S.sssp_delta_run(g, src, cfg, dtype, with_stats=True)
        assert torch.equal(dist, p_dist) and (it, stats) == (p_it, p_stats), src
    if case == "tiny":
        assert stats["light_dense"] and stats["heavy_dense"]
    if case == "torus":
        assert stats["buckets"] > 20


@pytest.mark.parametrize("path", ["sssp-device", "wcc-device", "cdlp-slab-directed",
                                  "cdlp-slab-undirected", "cdlp-sort", "cdlp-sort-skip"])
def test_fixed_point_graph_runs_match_host_run(cuda, path, monkeypatch):
    """sssp-impl=device, wcc-impl=device, slab and sort CDLP as one CUDA
    graph each against the host loop under plain_torch() on the card:
    results and iterations; one graph launch a run, K25 counted from
    Python never."""
    from graphtpu_torch.algorithms import cdlp as C
    from graphtpu_torch.algorithms import sssp as S
    from graphtpu_torch.algorithms import wcc as W
    from graphtpu_torch.ops import minmode as M
    from graphtpu_torch.utils.config import PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    cfg = PlatformConfig(device="cuda")
    if path == "sssp-device":
        g = rmat_graph(13, 8, directed=True, weighted=True, seed=4)
        runs = [(S, lambda src=src: S.sssp_device_run(g, src, cfg)) for src in (0, 9, 0)]
    elif path == "wcc-device":
        g = rmat_graph(13, 4, directed=True, seed=5)
        runs = [(W, lambda: W.wcc_device_run(g, cfg))] * 2
    else:
        g = rmat_graph(12, 8, directed=path != "cdlp-slab-undirected", seed=6)
        centers, neigh = C.build_incidence(g)
        deg = np.bincount(centers, minlength=g.n).astype(np.int32)
        if path.startswith("cdlp-slab"):
            runs = [(M, lambda it=it: M.cdlp_slab_run(g, centers, neigh, deg, it, cfg))
                    for it in (10, 3, 1, 10)]
        else:
            skip = 2 if path == "cdlp-sort-skip" else 0
            runs = [(C, lambda it=it: C.cdlp_sort_run(g, centers, neigh, deg, it, skip, "cuda"))
                    for it in (10, 4, 10)]
    graph_calls = _count_graph_calls(monkeypatch)
    for mod, run in runs:
        kernels.reset_launch_counts()
        graph_calls.clear()
        out, it = run()
        assert mod.last_run["driver"] == "graph" and graph_calls.count("graph_launch") == 1
        assert not kernels.launch_counts["fixed_point_route"], kernels.launch_counts
        assert kernels.replayed_counts["fixed_point_route"] == it + 1 - path.startswith(
            "cdlp-slab")
        with kernels.plain_torch():
            p_out, p_it = run()
        assert mod.last_run["driver"] == "host loop"
        assert torch.equal(out, p_out) and it == p_it


def test_new_graph_runs_make_no_host_read_but_their_last(cuda):
    """Warm runs of the delta, device, slab and sort loops under sync debug
    mode "error": the launch waits for nothing; only the read of the
    control words at their end syncs."""
    from graphtpu_torch.algorithms import cdlp as C
    from graphtpu_torch.algorithms import sssp as S
    from graphtpu_torch.algorithms import wcc as W
    from graphtpu_torch.ops import fixed_point as F
    from graphtpu_torch.ops import minmode as M
    from graphtpu_torch.utils.config import PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    cfg = PlatformConfig(device="cuda", sssp_delta=0.3)
    gw = rmat_graph(12, 8, directed=False, weighted=True, seed=1)
    g = rmat_graph(12, 8, directed=True, seed=2)
    centers, neigh = C.build_incidence(g)
    deg = np.bincount(centers, minlength=g.n).astype(np.int32)
    want = {"delta": S.sssp_delta_run(gw, 0, cfg), "device": S.sssp_device_run(gw, 0, cfg),
            "wcc": W.wcc_device_run(g, cfg),
            "slab": M.cdlp_slab_run(g, centers, neigh, deg, 10, cfg),
            "sort": C.cdlp_sort_run(g, centers, neigh, deg, 10, 0, "cuda")}
    prep = S.sssp_prep(gw, torch.float32, "cuda")
    light, heavy = S.sssp_delta_prep(gw, 0.3, torch.float32, "cuda")
    sym = g.symmetrized()
    plan = M.memoized_cdlp_plan(g, centers, neigh, deg, None, torch.device("cuda"))
    csr = C.incidence_csr(g, centers, neigh, deg, torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = {"delta": S._launch_delta(gw, prep, light, heavy, 0, 0.3, 1 << 16, 1 << 18),
               "device": S._launch_device(prep, 0, gw.n, torch.float32, gw.memo),
               "wcc": W._launch_device(sym, W.wcc_prep(sym, "cuda")),
               "slab": M._launch_slab(g, plan, None, 10),
               "sort": C._launch_sort(g, csr, 10, 0)}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for name, (out, ctl, loop, reads) in got.items():
        assert loop is not None and reads == 0, name
        it = int(ctl[S.DCTL_IT if name == "delta" else F.FCTL_IT])
        assert torch.equal(out, want[name][0]) and it == want[name][1], name
