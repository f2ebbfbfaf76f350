"""The port's rank-held blocks gathered back to the host, for the tests of
graphtpu_torch/parallel/ (a check that each rank holds its own block).

``gather_block`` (a partition's blocks) and ``gather_tensors`` (any
tensors a rank keeps, such as a plan's) run on every rank through
``Mesh.call``, so a worker
process imports this module by name: the module-scoped autouse fixture
puts tests/ on the workers' PYTHONPATH while the test module runs. This
module imports nothing of JAX, so a worker stays as light as the port.

A test module takes both with ``from torch_dist_gather import gather,
tests_on_worker_path  # noqa: F401``. ``residual_claims`` runs BFS's
residual test on every rank's installed pull CSR, for the tests of K17."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from graphtpu_torch.parallel.mesh import Mesh, all_gather_rows

TESTS = Path(__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def tests_on_worker_path():
    path = os.pathsep.join(p for p in (str(TESTS), os.environ.get("PYTHONPATH")) if p)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONPATH", path)
        yield


def gather_block(mesh: Mesh, key) -> tuple:
    """Per rank: the blocks every rank holds under ``key``, all-gathered to
    [D, m_pad] host arrays, in the fields' order (indptr and count left
    out)."""
    out = []
    for f in mesh.state[key][:-2]:
        g = all_gather_rows(f.to(torch.uint8) if f.dtype == torch.bool else f)
        g = g.reshape(mesh.size, -1).cpu().numpy()
        out.append(g.astype(bool) if f.dtype == torch.bool else g)
    return tuple(out)


def gather(sg, key) -> tuple:
    """What the ranks of ``sg``'s mesh hold under ``key``, on the host."""
    return sg.mesh.call(gather_block, [(key,)] * sg.num_devices)


def gather_tensors(mesh: Mesh, key, path) -> tuple:
    """Per rank: the tensors found by ``path`` (indices and attribute names,
    in turn) in what the rank holds under ``key``, each all-gathered to a
    [D, ...] host array (a tuple or list there gives one array per tensor)."""
    obj = mesh.state[key]
    for p in path:
        obj = getattr(obj, p) if isinstance(p, str) else obj[p]
    out = []
    for t in obj if isinstance(obj, (tuple, list)) else (obj,):
        g = all_gather_rows((t.to(torch.uint8) if t.dtype == torch.bool else t).reshape(-1))
        g = g.reshape((mesh.size,) + tuple(t.shape)).cpu().numpy()
        out.append(g.astype(bool) if t.dtype == torch.bool else g)
    return tuple(out)


def gather_at(sg, key, *path) -> tuple:
    """What the ranks of ``sg``'s mesh hold at ``path`` under ``key``, as
    [D, ...] host arrays."""
    return sg.mesh.call(gather_tensors, [(key, path)] * sg.num_devices)


def residual_claims(mesh: Mesh, key, levels, level: int, rids, e_cap: int) -> np.ndarray:
    """Per rank: the distributed BFS's residual test (``residual_claim``, its
    plain version on a CPU rank) of the rank's residual rows ``rids`` (local
    ids, padded with the rank's row count r) over the pull CSR the rank holds
    under ``key`` (adaptive_bfs's install), against the replicated
    ``levels``, the pad r; all-gathered to a [D, k] host array."""
    from graphtpu_torch.ops.frontier import expand, residual_claim

    (_, (qi, qdeg, qsrc), _), _ = mesh.state[key]
    lv = torch.as_tensor(levels).to(mesh.device)
    ids = torch.as_tensor(rids).to(mesh.device)
    exp = expand(ids, qdeg, qi, qsrc, e_cap, with_row_ids=False)
    got = residual_claim(lv, level, exp, e_cap, ids, qdeg.shape[0] - 1)
    return all_gather_rows(got).reshape(mesh.size, -1).cpu().numpy()
