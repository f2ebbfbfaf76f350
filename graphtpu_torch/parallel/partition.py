"""Row-partitioned graphs over a mesh (counterpart of
graphtpu/parallel/partition.py).

A 1-D partition of destination rows: rank d owns the ``rows_per_dev``
rows from ``d * rows_per_dev`` and the pull-ordered edges that end in them;
the dense per-vertex vectors (ranks, labels, distances, frontiers) are
replicated, and each step ends with an all-gather of the locally reduced
row blocks. ``n_pad``, ``rows_per_dev`` and the padded blocks are the JAX
package's, array for array: ``_partition_stream`` cuts the same key-sorted
stream into the same [D, m_pad] blocks (``ROW_ALIGN``, ``EDGE_ALIGN``).

The host builds every block (each process holds the whole Graph, as every
JAX process does), and each rank keeps only its own block, on its own
device (``ShardedGraph.pull`` and friends install it once and return the
key it is kept under; the default loops install their plans the same way,
through ``ShardedGraph.installed``). A rank's block also carries its pull
CSR: the valid entries are a prefix of the block and their rows ascend, so
``src[:count]`` with ``indptr`` over the rank's rows is what the kernels
take (``count`` is kept on the host, so a step reads nothing back).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from graphtpu_torch.core.graph import Graph
from graphtpu_torch.core.types import INDEX_DTYPE
from graphtpu_torch.parallel.mesh import Mesh

# Row blocks padded to a multiple of 128 rows, and edge blocks to a multiple
# of 1024 entries, as in the JAX package (its VPU tile sizes): the blocks
# are then the JAX devices' blocks.
ROW_ALIGN = 128
EDGE_ALIGN = 1024

_keys = itertools.count()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class ShardedCOO(NamedTuple):
    """Pull-ordered edges partitioned by destination row block: on the host
    [D, m_pad] arrays (every block), on a rank its own [m_pad] block plus
    its CSR. ``dst_local`` is the row relative to the block, ascending
    within a block."""

    src: object        # int32 global source ids
    dst_local: object  # int32 block-local destination rows
    w: object          # float edge weights (1.0 when unweighted)
    valid: object      # bool, False for padding
    indptr: object = None  # a rank's block: int32 [rows_per_dev + 1] over src[:count]
    count: int = 0         # a rank's block: its valid entries (a prefix)


class ShardedIncidence(NamedTuple):
    """CDLP's (center, neighbour) stream partitioned by center block.
    Padding entries have center_local == rows_per_dev, a throwaway segment
    past the real rows."""

    center_local: object  # int32
    neigh: object         # int32 global neighbour ids
    valid: object         # bool
    indptr: object = None  # a rank's block: int32 [rows_per_dev + 1]
    count: int = 0         # a rank's block: its valid entries (a prefix)


def _partition_stream(num_devices: int, key: np.ndarray, rows_per_dev: int, columns: dict,
                      pad_key_value: int):
    """Split a key-sorted edge stream into per-rank blocks, each padded to
    the largest block's size (aligned): (key_local, valid, columns, m_pad),
    all [D, m_pad]."""
    bounds = np.searchsorted(key, np.arange(1, num_devices + 1) * rows_per_dev, side="left")
    starts = np.concatenate([[0], bounds[:-1]])
    counts = bounds - starts
    m_pad = max(_round_up(int(counts.max()) if num_devices else 0, EDGE_ALIGN), EDGE_ALIGN)

    key_local = np.full((num_devices, m_pad), pad_key_value, dtype=INDEX_DTYPE)
    valid = np.zeros((num_devices, m_pad), dtype=bool)
    for d in range(num_devices):
        s, c = int(starts[d]), int(counts[d])
        key_local[d, :c] = key[s : s + c] - d * rows_per_dev
        valid[d, :c] = True
    out = {}
    for name, (arr, pad_value) in columns.items():
        block = np.full((num_devices, m_pad), pad_value, dtype=arr.dtype)
        for d in range(num_devices):
            s, c = int(starts[d]), int(counts[d])
            block[d, :c] = arr[s : s + c]
        out[name] = block
    return key_local, valid, out, m_pad


def _block_indptr(key_local: np.ndarray, valid: np.ndarray, rows: int) -> np.ndarray:
    """CSR offsets over ``rows`` rows of one block's valid prefix (the last
    is the count of valid entries)."""
    c = int(valid.sum())
    return np.searchsorted(key_local[:c], np.arange(rows + 1), side="left").astype(np.int32)


def _install(mesh: Mesh, key, fields: tuple, rows: int) -> None:
    """Per rank: keep this rank's block (``fields`` of a ShardedCOO or a
    ShardedIncidence, without indptr) on its device under ``key``."""
    cls = ShardedCOO if len(fields) == 4 else ShardedIncidence
    keyloc = fields[cls._fields.index("dst_local" if cls is ShardedCOO else "center_local")]
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device) for a in fields]
    indptr = _block_indptr(keyloc, fields[-1], rows)
    mesh.state[key] = cls(*t, torch.from_numpy(indptr).to(mesh.device), int(indptr[-1]))


def _on_device(tree, device):
    if isinstance(tree, tuple):
        return tuple(_on_device(t, device) for t in tree)
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def install_arrays(mesh: Mesh, key, *arrays) -> None:
    """Per rank: keep ``arrays`` (numpy arrays, or tuples of them, nested)
    on its device under ``key``, as the same tuples of tensors."""
    mesh.state[key] = _on_device(arrays, mesh.device)


def rank_part(tree, d: int):
    """Rank d's part of host arrays [D, ...] (tuples of them, nested)."""
    if isinstance(tree, tuple):
        return tuple(rank_part(t, d) for t in tree)
    return tree[d]


def _drop(mesh: Mesh, keys) -> None:
    for k in keys:
        mesh.state.pop(k, None)


class ShardedGraph:
    """A Graph partitioned over a mesh. The host partitions are built on
    demand (``*_host``); ``pull``, ``pull_symmetrized`` and ``incidence``
    install each rank's block once and return the key it is kept under."""

    def __init__(self, graph: Graph, mesh: Mesh, wdtype=np.float32):
        self.graph = graph
        self.mesh = mesh
        self.num_devices = mesh.size
        self.n = graph.n
        self.n_pad = max(_round_up(graph.n, self.num_devices * ROW_ALIGN),
                         self.num_devices * ROW_ALIGN)
        self.rows_per_dev = self.n_pad // self.num_devices
        self.wdtype = np.dtype(wdtype)
        self.key = next(_keys)
        self._installed: set = set()

    def pad_vector(self, vec: np.ndarray, pad_value) -> np.ndarray:
        out = np.full(self.n_pad, pad_value, dtype=vec.dtype)
        out[: self.n] = vec
        return out

    # -- host partitions (every block; the JAX package's arrays) -------------

    def _pull_of(self, graph: Graph) -> ShardedCOO:
        src, dst, w = graph.pull_arrays()
        dst_local, valid, cols, _ = _partition_stream(
            self.num_devices, dst, self.rows_per_dev,
            {"src": (src, 0), "w": (w.astype(self.wdtype), 0)},
            pad_key_value=self.rows_per_dev - 1,
        )
        return ShardedCOO(cols["src"], dst_local, cols["w"], valid)

    def pull_host(self) -> ShardedCOO:
        return self._pull_of(self.graph)

    def pull_symmetrized_host(self) -> ShardedCOO:
        return self._pull_of(self.graph.symmetrized())

    def incidence_host(self) -> ShardedIncidence:
        from graphtpu_torch.algorithms.cdlp import build_incidence

        centers, neigh = build_incidence(self.graph)
        center_local, valid, cols, _ = _partition_stream(
            self.num_devices, centers.astype(np.int64), self.rows_per_dev,
            {"neigh": (neigh, 0)}, pad_key_value=self.rows_per_dev,
        )
        return ShardedIncidence(center_local, cols["neigh"], valid)

    # -- rank-held blocks ------------------------------------------------------

    def installed(self, kind: str, install, per_rank) -> tuple:
        """Key of each rank's state of ``kind``. On the first call,
        ``install(mesh, key, *per_rank()[d])`` runs on every rank d; later
        calls send nothing. ``release`` and ``forget`` drop it."""
        key = (self.key, kind)
        if kind not in self._installed:
            self.mesh.call(install, [(key, *args) for args in per_rank()])
            self._installed.add(kind)
        return key

    def installed_parts(self, kind: str, parts: tuple, replicated: tuple = ()) -> tuple:
        """Key under which rank d holds ``(rank_part(parts, d), *replicated)``
        as tensors on its device, installed once (``install_arrays``)."""
        return self.installed(kind, install_arrays, lambda: [
            (rank_part(parts, d), *replicated) for d in range(self.num_devices)])

    def forget(self, kind: str) -> None:
        """Drop each rank's state of ``kind``, if installed."""
        if kind in self._installed:
            self._installed.discard(kind)
            if not self.mesh.closed:
                self.mesh.call(_drop, [([(self.key, kind)],)] * self.num_devices)

    def _installed_key(self, kind: str, build) -> tuple:
        def per_rank():
            fields = build()[:-2]  # without indptr and count
            return [(tuple(a[d] for a in fields), self.rows_per_dev)
                    for d in range(self.num_devices)]

        return self.installed(kind, _install, per_rank)

    def pull(self) -> tuple:
        """Key of each rank's block of the pull-ordered edges."""
        return self._installed_key("pull", self.pull_host)

    def pull_symmetrized(self) -> tuple:
        """Key of each rank's block of the symmetrized structure (WCC); an
        undirected graph's is its pull."""
        if not self.graph.directed:
            return self.pull()
        return self._installed_key("pull_sym", self.pull_symmetrized_host)

    def incidence(self) -> tuple:
        """Key of each rank's block of CDLP's incidence stream."""
        return self._installed_key("incidence", self.incidence_host)

    def release(self) -> None:
        """Drop this graph's blocks and plans on every rank."""
        if self._installed and not self.mesh.closed:
            keys = [(self.key, k) for k in self._installed]
            self.mesh.call(_drop, [(keys,)] * self.num_devices)
        self._installed.clear()

    # -- degree views (padded to n_pad, replicated) --------------------------

    def out_degree_padded(self) -> np.ndarray:
        return self.pad_vector(self.graph.out_degree.astype(np.int32), 0)

    def incidence_degree_padded(self) -> np.ndarray:
        """Neighbour-multiset size per vertex (CDLP's has-neighbours test)."""
        from graphtpu_torch.algorithms.cdlp import build_incidence

        deg = self.graph.memo.get("incidence_deg")
        if deg is None:
            centers, _ = build_incidence(self.graph)
            deg = np.bincount(centers, minlength=self.n).astype(np.int32)
            self.graph.memo["incidence_deg"] = deg
        return self.pad_vector(deg, 0)
