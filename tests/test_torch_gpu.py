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
from graphtpu_torch.ops.gather import gather_rows, gather_rows_plain
from graphtpu_torch.ops.minmode import slab_minmode, slab_minmode_plain
from graphtpu_torch.ops.spmv import slab_spmv_sum, slab_spmv_sum_plain

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
