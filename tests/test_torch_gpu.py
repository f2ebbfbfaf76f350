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
from graphtpu_torch.ops.minmode import slab_minmode, slab_minmode_plain
from graphtpu_torch.ops.pallas_gather import vreg_shuffle, vreg_shuffle_plain
from graphtpu_torch.ops.spmv import (
    csr_pull_reduce, csr_pull_reduce_plain, slab_spmv_min, slab_spmv_min_plain, slab_spmv_sum,
    slab_spmv_sum_plain,
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
