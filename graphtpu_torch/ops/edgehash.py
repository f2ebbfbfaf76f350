"""Static edge-membership hash table probed a 64-slot row at a time
(counterpart of graphtpu/ops/edgehash.py; same table, bit for bit).

"Is (x, y) an edge?" is answered from a global table whose collision
domain is a ROW of 64 slots, 512 bytes, fetched whole and compared at once:
there is no probe sequence. The table is int32 [rows, 128]; a slot is an
(even, odd) lane pair. The even lane holds the key's low 32 bits, the odd
lane ``(key_hi << PAYLOAD_BITS) | payload``, so keys up to
2^(30 + 32 - PAYLOAD_BITS) fit. Empty slots hold (-1, -1); a real odd lane
is never negative, so -1 cannot match. The row comes from a 32-bit
multiplicative hash of both halves.

Keys that do not fit their row (more than 64 keys hash to it) are LEFT OUT
and returned to the caller as a mask, to be handled exactly on the host
(ops/triangles.py patches their triangles after the sweep). At the default
fill (a mean of 16 keys per row) that all but never happens.

``edgehash_probe`` is the wrapper of kernel K9 (csrc/edgehash_probe.cu):
row fetch, 64-slot compare and payload select in one kernel, run over the
probes binned by table partition (a histogram and a scatter launch before
it, an unbin launch after it), a block grouping each partition's probes by
row so that a row reaches the SM once for all its probes there; a call too
small to gain (``k9_bins``) takes the probe launch alone. ``_probe_lanes``
is its plain PyTorch version, and ``probe_bin_plan`` the bin order's. The
32-bit products of the hash wrap; torch does not promise that for signed
tensors, so the plain code multiplies in int64 in 16-bit pieces that cannot
overflow, and masks.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from graphtpu_torch.ops import kernels

PAYLOAD_BITS = 2
_PAYLOAD_MASK = (1 << PAYLOAD_BITS) - 1
_SLOTS = 64          # key slots per row
_ROW = 2 * _SLOTS    # int32 lanes per row (lo/odd interleaved) == 128

# K9's bins (csrc/edgehash_probe.cu): at most K9_MAX_PARTS partitions;
# K9_TILE probes a tile of the bin passes; a probe block groups the probes
# of one partition by row, K9_CHUNK at a time. A call is binned only where its
# probes share rows: at least K9_BIN_MIN_PROBES of them, and at least one
# per row of the table on average (below that the bin, scan and unbin
# passes cost more than the fetches they save)
K9_MAX_PARTS = 1 << 11
K9_TILE = 16384  # csrc/edgehash_probe.cu: 2 steps of 8192
K9_CHUNK = 4096
K9_BIN_MIN_PROBES = 1 << 20

_M_LO = np.uint32(0x9E3779B1)   # golden-ratio prime
_M_HI = np.uint32(0x85EBCA77)   # murmur3 fmix prime
_U32 = 0xFFFFFFFF


class EdgeHash(NamedTuple):
    table: torch.Tensor   # int32 [rows, 128]
    rows: int             # power of two


def _table_rows(m: int, fill: float) -> int:
    return 1 << max(4, int(np.ceil(np.log2(max(m, 1) / (_SLOTS * fill) + 1))))


def _split(keys: np.ndarray, payload: np.ndarray):
    lo = (keys.astype(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys.astype(np.uint64) >> np.uint64(32)).astype(np.uint32)
    odd = (hi << np.uint32(PAYLOAD_BITS)) | payload.astype(np.uint32)
    return lo.view(np.int32), odd.view(np.int32), lo, hi


def _host_hash(lo_u32: np.ndarray, hi_u32: np.ndarray, rows: int) -> np.ndarray:
    h = (lo_u32 * _M_LO) ^ (hi_u32 * _M_HI)  # uint32 wrap-around
    b = int(rows).bit_length() - 1
    return ((h >> np.uint32(32 - b)) & np.uint32(rows - 1)).astype(np.int64)


def build_edge_hash(
    keys: np.ndarray, payload: np.ndarray, fill: float = 0.25, *, device="cpu"
) -> Tuple[EdgeHash, np.ndarray]:
    """Build, on the host, a membership table on ``device`` for int64
    ``keys`` (non-negative, unique, < 2^(30 + 32 - PAYLOAD_BITS)) with
    payload ints < 2^PAYLOAD_BITS.

    ``fill`` is the target mean slot occupancy (0.25: a mean of 16 keys per
    64-slot row). Returns (EdgeHash, spilled), where ``spilled`` marks the
    keys that did NOT fit."""
    keys = np.asarray(keys, dtype=np.int64)
    payload = np.asarray(payload, dtype=np.int64)
    lo_i32, odd_i32, lo_u32, hi_u32 = _split(keys, payload)

    rows = _table_rows(len(keys), fill)
    h = _host_hash(lo_u32, hi_u32, rows)
    order = np.argsort(h, kind="stable")
    hs = h[order]
    idx = np.arange(hs.shape[0], dtype=np.int64)
    rank = np.zeros(hs.shape[0], dtype=np.int64)
    if hs.shape[0]:
        new_run = np.concatenate([[True], hs[1:] != hs[:-1]])
        rank = idx - np.maximum.accumulate(np.where(new_run, idx, 0))
    fits = rank < _SLOTS
    table = np.full(rows * _ROW, -1, dtype=np.int32)
    base = hs[fits] * _ROW + 2 * rank[fits]
    table[base] = lo_i32[order][fits]
    table[base + 1] = odd_i32[order][fits]
    spilled = np.zeros(keys.shape[0], dtype=bool)
    spilled[order[~fits]] = True
    return EdgeHash(torch.from_numpy(table.reshape(rows, _ROW)).to(device), rows), spilled


def _mul_u32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit constant,
    in int64 products below 2^48."""
    return (a * (m & 0xFFFF) + (((a * (m >> 16)) & 0xFFFF) << 16)) & _U32


def _wrap_i32(a: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 with the same bits."""
    return torch.where(a >= 1 << 31, a - (1 << 32), a).to(torch.int32)


def _hash_rows(lo_u: torch.Tensor, hi_u: torch.Tensor, rows: int) -> torch.Tensor:
    """Row of each key from its halves as int64 in [0, 2^32): int64 [P]."""
    b = int(rows).bit_length() - 1
    h = _mul_u32(lo_u, int(_M_LO)) ^ _mul_u32(hi_u, int(_M_HI))
    return (h >> (32 - b)) & (rows - 1)


def _build_kernel(keys: torch.Tensor, payload: torch.Tensor, rows: int):
    """Table construction on the keys' device: hash, stable sort by row,
    rank within the row, one scatter. The rank is the distance to the first
    key of the row's run, found by a search of the sorted rows in
    themselves."""
    m = keys.shape[0]
    dev = keys.device
    lo_u = keys & _U32
    hi = keys >> 32
    lo = _wrap_i32(lo_u)
    odd = ((hi << PAYLOAD_BITS) | payload).to(torch.int32)
    h = _hash_rows(lo_u, hi, rows).to(torch.int32)
    h_s, idx_s = torch.sort(h, stable=True)
    rank = torch.arange(m, device=dev) - torch.searchsorted(h_s, h_s, right=False)
    fits = rank < _SLOTS
    dump = rows * _ROW  # two slots past the table take what does not fit
    safe = torch.where(fits, h_s.long() * _ROW + 2 * rank, dump)
    table = torch.full((dump + 2,), -1, dtype=torch.int32, device=dev)
    table[safe] = lo[idx_s]
    table[safe + 1] = odd[idx_s]
    spilled = torch.zeros(m + 1, dtype=torch.bool, device=dev)
    spilled[torch.where(fits, m, idx_s)] = True
    return table[:dump].reshape(rows, _ROW), spilled[:m]


def build_edge_hash_device(
    keys: torch.Tensor, payload: torch.Tensor, fill: float = 0.25
) -> Tuple[EdgeHash, np.ndarray]:
    """build_edge_hash computed on the device of ``keys`` (int64) and
    ``payload`` (int32). Same table, same hash, same overflow policy;
    ``spilled`` comes back as a host bool mask."""
    m = int(keys.shape[0])
    rows = _table_rows(m, fill)
    table, spilled = _build_kernel(keys, payload.to(torch.int32), rows)
    # overflow all but never happens: read the count, one scalar, and copy
    # the [m] mask only when it is not zero
    if int(spilled.sum()) == 0:
        return EdgeHash(table, rows), np.zeros(m, dtype=bool)
    return EdgeHash(table, rows), spilled.cpu().numpy()


def _probe_lanes(eh: EdgeHash, klo: torch.Tensor, khi: torch.Tensor):
    """K9's plain PyTorch version, on flat int32 (lo, hi) key halves: the
    row gather, the compare of 64 slots and the payload select as torch ops."""
    h = _hash_rows(klo.long() & _U32, khi.long() & _U32, eh.rows)
    fetched = eh.table.index_select(0, h)            # [P, 128] int32 row gather
    lo_lanes = fetched[:, 0::2]
    odd_lanes = fetched[:, 1::2]
    match = (
        (odd_lanes >= 0)
        & (lo_lanes == klo[:, None])
        & ((odd_lanes >> PAYLOAD_BITS) == khi[:, None])
    )
    found = match.any(dim=-1)
    payload = torch.where(match, odd_lanes & _PAYLOAD_MASK, 0).sum(dim=-1, dtype=torch.int32)
    return found, payload


def _check_table(name: str, eh: EdgeHash) -> None:
    t = eh.table
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != _ROW or not t.is_contiguous():
        raise TypeError(f"{name}: the table must be a contiguous int32 [rows, {_ROW}] tensor")
    if t.shape[0] != eh.rows or eh.rows < 2 or eh.rows & (eh.rows - 1) or eh.rows > 1 << 31:
        raise ValueError(f"{name}: rows {eh.rows} must be a power of two in [2, 2^31] and the "
                         f"table's first dimension ({t.shape[0]})")


def k9_partition_shift(rows: int, p: int) -> int:
    """log2 of the rows of one K9 partition for a call of ``p`` probes: a
    partition's probes (about K9_CHUNK / 2 of them) are grouped by row in one
    block's shared memory, so 2^pshift is about K9_CHUNK / 2 * rows / p rows,
    raised where the table would have more than K9_MAX_PARTS partitions."""
    b = int(rows).bit_length() - 1
    target = (K9_CHUNK // 2) * int(rows) // max(int(p), 1)
    shift = target.bit_length() - 1 if target >= 1 else 0
    return min(max(shift, b - (K9_MAX_PARTS.bit_length() - 1), 0), b)


def k9_parts(rows: int, pshift: int) -> int:
    """Partitions of a table of ``rows`` rows (a power of two) at 2^pshift
    rows each."""
    return max(1, int(rows) >> pshift)


def k9_bins(rows: int, p: int) -> bool:
    """K9's size rule: bin a call's probes when it has at least
    K9_BIN_MIN_PROBES probes and at least one per row of the table; else
    the probe kernel runs alone over the caller's order."""
    return p >= K9_BIN_MIN_PROBES and p >= rows


def _partitions(eh: EdgeHash, klo: torch.Tensor, khi: torch.Tensor, pshift: int):
    return _hash_rows(klo.long() & _U32, khi.long() & _U32, eh.rows) >> pshift


def probe_bin_plan(eh: EdgeHash, klo: torch.Tensor, khi: torch.Tensor, pshift: int):
    """The bin order of K9's scatter as torch ops: int64 [P], the probes'
    indices ordered by partition (row >> pshift), the caller's order within
    a partition (the kernel's order there follows its atomics)."""
    return torch.sort(_partitions(eh, klo, khi, pshift), stable=True).indices


def edgehash_bin(eh: EdgeHash, klo: torch.Tensor, khi: torch.Tensor, pshift: int):
    """(bklo, bkhi, pos, starts): the keys in bin order, each probe's place
    there (int32 [P], in the caller's order) and each partition's first
    place (int32 [parts]). On the card: K9's histogram launch, a torch scan
    of its [tiles, parts] counts in partition order and its scatter launch
    (each counted as a K9 launch); on the CPU, ``probe_bin_plan``."""
    p, dev = klo.shape[0], klo.device
    parts = k9_parts(eh.rows, pshift)
    if parts > K9_MAX_PARTS:
        raise ValueError(f"edgehash_bin: {parts} partitions; K9 takes at most {K9_MAX_PARTS}")
    if not kernels.use_kernel(eh.table):
        perm = probe_bin_plan(eh, klo, khi, pshift)
        pos = torch.empty_like(perm)
        pos[perm] = torch.arange(p, device=dev)
        counts = torch.bincount(_partitions(eh, klo, khi, pshift), minlength=parts)
        starts = (counts.cumsum(0) - counts).to(torch.int32)
        return klo[perm], khi[perm], pos.to(torch.int32), starts
    tiles = (p + K9_TILE - 1) // K9_TILE
    counts = torch.empty(tiles * parts, dtype=torch.int32, device=dev)
    bins = torch.empty((p, 2), dtype=torch.int32, device=dev)  # (klo, khi) pairs
    pos = torch.empty(p, dtype=torch.int32, device=dev)
    args = (eh.table.data_ptr(), eh.rows, klo.data_ptr(), khi.data_ptr(), p, pshift, parts, tiles)
    kernels.launch("edgehash_bin_count", dev, *args, counts.data_ptr(), counter="edgehash_probe")
    by_part = counts.view(tiles, parts).t().reshape(-1)
    first = (by_part.cumsum(0, dtype=torch.int32) - by_part).view(parts, tiles)
    offsets = first.t().contiguous()
    kernels.launch("edgehash_bin_scatter", dev, *args, offsets.data_ptr(), bins.data_ptr(),
                   pos.data_ptr(), counter="edgehash_probe")
    return bins[:, 0], bins[:, 1], pos, first[:, 0]


def _probe_kernel(eh: EdgeHash, klo: torch.Tensor, khi: torch.Tensor, pshift):
    """K9 on the card: the probes binned at 2^pshift rows a partition (four
    launches), or the probe alone over the caller's order where ``pshift``
    is None (one)."""
    p, dev = klo.shape[0], klo.device
    found = torch.empty(p, dtype=torch.bool, device=dev)
    payload = torch.empty(p, dtype=torch.int32, device=dev)
    if not p:
        return found, payload
    if pshift is None:
        kernels.launch("edgehash_probe", dev, eh.table.data_ptr(), eh.rows, klo.data_ptr(),
                       khi.data_ptr(), found.data_ptr(), payload.data_ptr(), p)
        return found, payload
    bklo, _, pos, starts = edgehash_bin(eh, klo, khi, pshift)
    starts = starts.contiguous()
    res = torch.empty(p, dtype=torch.int32, device=dev)
    # bklo is column 0 of the [P, 2] pairs: its pointer is the pairs'
    kernels.launch("edgehash_bin_probe", dev, eh.table.data_ptr(), eh.rows, bklo.data_ptr(),
                   starts.data_ptr(), starts.shape[0], p, pshift, res.data_ptr(),
                   counter="edgehash_probe")
    kernels.launch("edgehash_unbin", dev, pos.data_ptr(), res.data_ptr(), found.data_ptr(),
                   payload.data_ptr(), p, counter="edgehash_probe")
    return found, payload


def edgehash_probe(eh: EdgeHash, klo: torch.Tensor, khi: torch.Tensor):
    """K9 wrapper: (found bool [P], payload int32 [P]) for keys given as
    flat int32 halves ``klo``, ``khi`` [P] on the table's device. A key not
    in the table gives (False, 0). On the card the probes are binned by
    partition of the table (``k9_partition_shift``) where ``k9_bins`` says
    so: four K9 launches, else one."""
    _check_table("edgehash_probe", eh)
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in (klo, khi)) or klo.shape != khi.shape:
        raise TypeError("edgehash_probe: klo and khi must be 1-D int32 of one length")
    if any(t.device != eh.table.device for t in (klo, khi)):
        raise ValueError("edgehash_probe: keys and table must be on one device")
    if not (klo.is_contiguous() and khi.is_contiguous()):
        raise ValueError("edgehash_probe: klo and khi must be contiguous")
    if not kernels.use_kernel(eh.table):
        return _probe_lanes(eh, klo, khi)
    p = klo.shape[0]
    if p >= 1 << 31:
        raise ValueError("edgehash_probe: K9 takes fewer than 2^31 probes a call")
    binned = k9_bins(eh.rows, p)
    return _probe_kernel(eh, klo, khi, k9_partition_shift(eh.rows, p) if binned else None)


def probe_edge_hash(eh: EdgeHash, keys: torch.Tensor):
    """Membership test: keys int64 >= 0 (any shape) -> (found bool, payload
    int32) of that shape. Unknown keys give (False, 0)."""
    kf = keys.reshape(-1)
    found, payload = edgehash_probe(
        eh, _wrap_i32(kf & _U32).contiguous(), (kf >> 32).to(torch.int32).contiguous()
    )
    return found.reshape(keys.shape), payload.reshape(keys.shape)


def pair_key_halves(x: torch.Tensor, y: torch.Tensor, id_bits: int):
    """(klo, khi) int32 of the packed pair keys ``(x << id_bits) | y`` of
    flat int32 ids x, y >= 0: the low half is the shift wrapped to 32 bits,
    the high half ``x >> (32 - id_bits)``."""
    if not 0 < id_bits < 32:
        raise ValueError(f"pair keys: id_bits {id_bits} outside (0, 32)")
    klo = _wrap_i32(((x.long() << id_bits) | y.long()) & _U32)
    return klo.contiguous(), (x >> (32 - id_bits)).contiguous()


def probe_edge_hash_xy(eh: EdgeHash, x: torch.Tensor, y: torch.Tensor, id_bits: int):
    """Membership test for the packed pair keys ``(x << id_bits) | y`` of
    int32 ids x, y >= 0 (0 < id_bits < 32), of any shape."""
    klo, khi = pair_key_halves(x.reshape(-1).to(torch.int32), y.reshape(-1).to(torch.int32),
                               id_bits)
    found, payload = edgehash_probe(eh, klo, khi)
    return found.reshape(x.shape), payload.reshape(x.shape)
