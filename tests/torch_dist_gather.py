"""The port's rank-held blocks gathered back to the host, for the tests of
graphtpu_torch/parallel/ (a check that each rank holds its own block).

``gather_block`` runs on every rank through ``Mesh.call``, so a worker
process imports this module by name: the module-scoped autouse fixture
puts tests/ on the workers' PYTHONPATH while the test module runs. This
module imports nothing of JAX, so a worker stays as light as the port.

A test module takes both with ``from torch_dist_gather import gather,
tests_on_worker_path  # noqa: F401``."""

import os
from pathlib import Path

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
