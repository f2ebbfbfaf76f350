"""Compacted frontier / active-set engine with static capacities
(counterpart of graphtpu/ops/frontier.py).

A frontier is a fixed-capacity id buffer ``ids [K]`` (ascending, padded
with n) plus its true count. ``compact`` turns a dense mask into one and
``compact_stream`` dedupes a stream of vertex ids back into one, both on
kernel K14 (``frontier_compact``; ``compact_into``, ``compact_stream_into``
and ``compact_rows_into`` write into given buffers with the ids' degree sum,
the last in K14's row-flag mode; ``compact_level_into`` compacts the vertices
at a level read on the card and ``compact_unvisited_into`` an expansion's
unvisited neighbours, K14's level and unvisited modes, which BFS auto's
device loop runs); ``expand`` lays the frontier's adjacency
slices out in ``e_cap`` edge slots on kernel K5 (``frontier_expand``), after
the row starts of kernel K18 (``frontier_starts``),
``residual_claim`` is BFS's bottom-up residual test, the ids of the rows of
an expansion that reach the current level, on kernel K17
(``bfs_residual_claim``; ``residual_hits``, the same test on K7 ``max_i32``
over a frontier mask, is what the tests and measuring scripts hold it
against), ``mask_status`` gives a mask's (count, edge-sum), the numbers
a caller needs to decide whether a frontier fits its capacities,
``relax_min`` is SSSP's push relaxation over an expansion on kernel K8
(``push_relax_min``; ``relax_min_into`` its in-place mode, which marks the
vertices it lowered), ``relax_min_i32`` the distributed WCC's scatter-min on
K8's int32 mode, and ``bfs_trunc_probe`` is BFS's truncated bottom-up probe
on kernel K13. K13 and K17 take the level as an int, or as a one-element
int32 tensor on the card that the kernel reads there (their device-level
mode: one captured launch serves every level of a device loop). Every
function returns the JAX function's values, pad slots included, and never
reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import kernels
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.spmv import csr_pull_reduce, csr_pull_reduce_plain

# K14's scratch: one count per block of its grid (csrc/frontier_compact.cu
# K14_MAX_BLOCKS)
K14_MAX_BLOCKS = 1024


class Expansion(NamedTuple):
    rows_local: torch.Tensor          # [E] int32: frontier slot owning each edge slot
    row_ids: Optional[torch.Tensor]   # [E] int32: vertex id owning each edge slot
    neigh: torch.Tensor               # [E] int32: neighbour id (0 where invalid)
    gpos: torch.Tensor                # [E] int32: global incidence position (0 if invalid)
    seg_starts: torch.Tensor          # [K+1] int32: exclusive cumsum of frontier degrees
    edge_count: torch.Tensor          # 0-d int32: real edges (slots >= this are pad)
    valid: torch.Tensor               # [E] bool: slot holds a real edge


def mask_status(mask: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """(count, edge-sum) of a mask over [n] vertices with degrees ``deg``,
    as one int64 [2] tensor, so that a caller reads both in one copy."""
    return torch.stack([mask.sum(), torch.where(mask, deg, 0).sum()])


def compact_plain(mask: torch.Tensor, k: int):
    """K14's plain PyTorch version of ``compact``, the JAX function's
    formulation: a sort of where(mask, id, n), cut or padded to k."""
    n = mask.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    ids = torch.sort(torch.where(mask, idx, n)).values
    return _fit(ids, k, n), mask.sum(dtype=torch.int32)


def _k14_outputs(k: int, device):
    return (torch.empty(k, dtype=torch.int32, device=device),
            torch.empty((), dtype=torch.int32, device=device),
            torch.empty(K14_MAX_BLOCKS, dtype=torch.int32, device=device))


def compact(mask: torch.Tensor, k: int, out: torch.Tensor | None = None):
    """K14 wrapper: dense bool mask [n] -> (ids [k] ascending, padded with
    n, count as a 0-d int32). Ids past k are cut; the count is the true
    one. ``mask`` is 1-D and contiguous (a slice of a longer mask is).
    ``out``: a contiguous int32 [k] on the mask's device that takes the ids
    (and is returned), as a device loop's state does."""
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise TypeError("compact: mask must be a contiguous 1-D bool tensor")
    if k < 0:
        raise ValueError(f"compact: k {k} < 0")
    if out is not None and (out.dtype != torch.int32 or out.shape != (k,) or
                            out.device != mask.device or not out.is_contiguous()):
        raise ValueError(f"compact: out must be a contiguous int32 [{k}] on the mask's device")
    if not kernels.use_kernel(mask):
        ids, count = compact_plain(mask, k)
        return (ids, count) if out is None else (out.copy_(ids), count)
    n = mask.shape[0]
    ids, count, scratch = _k14_outputs(k if out is None else 0, mask.device)
    ids = ids if out is None else out
    kernels.launch("frontier_compact", mask.device, mask.data_ptr(), n, ids.data_ptr(), k,
                   count.data_ptr(), scratch.data_ptr(), K14_MAX_BLOCKS)
    return ids, count


def _fit(ids: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The first k of ``ids``, padded with n where there are fewer."""
    if ids.shape[0] >= k:
        return ids[:k].contiguous()
    return torch.cat([ids, ids.new_full((k - ids.shape[0],), n)])


def frontier_expand_plain(ids, starts, indptr_pad, neigh, e_cap: int, with_row_ids=True):
    """K5's plain PyTorch version, the JAX function's formulation: each
    nonempty row's index scattered (max) at its start, a cummax over the
    slots, then gathers of the owner, its global position and the
    neighbour."""
    k, dev = ids.shape[0], ids.device
    lens = starts[1:] - starts[:-1]
    total = starts[-1]
    head = torch.where(lens > 0, torch.arange(k, dtype=torch.int32, device=dev), -1)
    # a row starting at or past e_cap is cut: its mark lands in slot e_cap
    at = torch.clamp(starts[:-1], max=e_cap).long()
    marks = torch.full((e_cap + 1,), -1, dtype=torch.int32, device=dev).scatter_reduce_(
        0, at, head, "amax"
    )[:e_cap]
    rows_local = torch.cummax(marks, 0).values.clamp_(0, k - 1)
    slot = torch.arange(e_cap, dtype=torch.int32, device=dev)
    valid = slot < total
    row_ids = ids[rows_local.long()] if with_row_ids else None
    delta = indptr_pad[ids.long()] - starts[:-1]
    gpos = torch.where(valid, delta[rows_local.long()] + slot, 0)
    # an edgeless graph has no neighbour to read, and no valid slot
    nb = torch.where(valid, neigh[gpos.long()], 0) if neigh.numel() else torch.zeros_like(gpos)
    return rows_local, row_ids, gpos, nb, valid


def frontier_expand(ids, starts, indptr_pad, neigh, e_cap: int, with_row_ids=True):
    """K5 wrapper: (rows_local, row_ids or None, gpos, neigh, valid) over
    ``e_cap`` slots for a frontier ``ids [K]`` (K >= 1, padded with n) whose
    degree prefix is ``starts [K+1]``. All inputs int32, contiguous, on one
    device; ``indptr_pad`` is [n+1], ``neigh`` the incidence neighbours."""
    ts = (ids, starts, indptr_pad, neigh)
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in ts):
        raise TypeError("frontier_expand: ids, starts, indptr_pad and neigh must be 1-D int32")
    if any(t.device != ids.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("frontier_expand: inputs must be contiguous, on one device")
    k = ids.shape[0]
    if k < 1 or starts.shape[0] != k + 1:
        raise ValueError(f"frontier_expand: need K >= 1 ids and K+1 starts, got {k}, "
                         f"{starts.shape[0]}")
    if not 0 <= e_cap < 1 << 31:
        raise ValueError(f"frontier_expand: e_cap {e_cap} outside [0, 2^31)")
    if not kernels.use_kernel(ids):
        return frontier_expand_plain(ids, starts, indptr_pad, neigh, e_cap, with_row_ids)
    out = lambda dt: torch.empty(e_cap, dtype=dt, device=ids.device)  # noqa: E731
    rows_local, gpos, nb = out(torch.int32), out(torch.int32), out(torch.int32)
    row_ids = out(torch.int32) if with_row_ids else None
    valid = out(torch.bool)
    if e_cap:
        kernels.launch(
            "frontier_expand", ids.device, ids.data_ptr(), starts.data_ptr(), k,
            indptr_pad.data_ptr(), neigh.data_ptr(), rows_local.data_ptr(),
            row_ids.data_ptr() if with_row_ids else None, gpos.data_ptr(), nb.data_ptr(),
            valid.data_ptr(), e_cap,
        )
    return rows_local, row_ids, gpos, nb, valid


def frontier_starts_plain(ids: torch.Tensor, deg_pad: torch.Tensor) -> torch.Tensor:
    """K18's plain PyTorch version, the JAX function's formulation: a
    gather of the degrees, their int32 cumsum and a leading 0."""
    lens = table_gather(deg_pad, ids)
    return torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0, dtype=torch.int32)])


def frontier_starts(ids: torch.Tensor, deg_pad: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """K18 wrapper: int32 [K+1] row starts of the expansion of ``ids``
    [K] (int32, ids in [0, len(deg_pad))): starts[0] = 0 and starts[i+1] =
    starts[i] + deg_pad[ids[i]], as int32 sums (they wrap as the JAX
    cumsum's do). starts[K] is the edge count. ``out``: a contiguous int32
    [K+1] on the ids' device that takes them (and is returned). One launch
    (after a memset of its scratch), no host read."""
    if ids.dtype != torch.int32 or deg_pad.dtype != torch.int32 or ids.dim() != 1 or \
            deg_pad.dim() != 1:
        raise TypeError("frontier_starts: ids and deg_pad must be 1-D int32")
    if ids.device != deg_pad.device or not (ids.is_contiguous() and deg_pad.is_contiguous()):
        raise ValueError("frontier_starts: ids and deg_pad must be contiguous, on one device")
    k = ids.shape[0]
    if k >= (1 << 31) - 1:
        raise ValueError(f"frontier_starts: {k} ids are too many")
    if out is not None and (out.dtype != torch.int32 or out.shape != (k + 1,) or
                            out.device != ids.device or not out.is_contiguous()):
        raise ValueError(f"frontier_starts: out must be a contiguous int32 [{k + 1}] on the "
                         "ids' device")
    if not kernels.use_kernel(ids):
        starts = frontier_starts_plain(ids, deg_pad)
        return starts if out is None else out.copy_(starts)
    starts = torch.empty(k + 1, dtype=torch.int32, device=ids.device) if out is None else out
    words = kernels.query("frontier_starts_scratch_words", k)
    scratch = torch.empty(words, dtype=torch.int64, device=ids.device)
    kernels.launch("frontier_starts", ids.device, ids.data_ptr(), k, deg_pad.data_ptr(),
                   deg_pad.shape[0], starts.data_ptr(), scratch.data_ptr(), words)
    return starts


def expand(ids: torch.Tensor, deg_pad: torch.Tensor, indptr_pad: torch.Tensor,
           neigh: torch.Tensor, e_cap: int, with_row_ids: bool = True,
           starts: torch.Tensor | None = None) -> Expansion:
    """Concatenate the adjacency slices of ``ids`` into [e_cap] slots.

    ``deg_pad``/``indptr_pad`` are [n+1] with deg_pad[n] == 0, so the pad
    id n reads as an empty slice. Edges past e_cap are cut: callers check
    ``edge_count <= e_cap`` first. A pad slot belongs to the last nonempty
    row (row 0 when there is none). ``starts``: an int32 [K+1] buffer that
    takes the row starts (``frontier_starts``'s ``out``). Two launches on
    the card: K18, K5."""
    starts = frontier_starts(ids, deg_pad, starts)
    rows_local, row_ids, gpos, nb, valid = frontier_expand(
        ids, starts, indptr_pad, neigh, e_cap, with_row_ids
    )
    return Expansion(rows_local, row_ids, nb, gpos, starts, starts[-1], valid)


def compact_stream_plain(vals: torch.Tensor, active: torch.Tensor, k: int, n: int):
    """K14's plain PyTorch version of ``compact_stream``, the JAX
    function's formulation: a sort, a dedupe mask, a second sort."""
    s = torch.sort(torch.where(active, vals, n)).values
    first = s < n
    first[1:] &= s[1:] != s[:-1]
    ids = torch.sort(torch.where(first, s, n)).values
    return _fit(ids, k, n), first.sum(dtype=torch.int32)


def _check_stream(name, vals, active, k, n) -> None:
    if vals.dtype != torch.int32 or active.dtype != torch.bool:
        raise TypeError(f"{name}: vals must be int32, active bool")
    if vals.dim() != 1 or vals.shape != active.shape or active.device != vals.device:
        raise ValueError(f"{name}: vals and active must be 1-D, of one length and device")
    if not (vals.is_contiguous() and active.is_contiguous()) or k < 0 or not 0 <= n < 1 << 31:
        raise ValueError(f"{name}: contiguous inputs, k >= 0 and n in [0, 2^31) (k {k}, n {n})")


# K14's stream entry's modes (csrc/frontier_compact.cu K14_MARK_*)
K14_ACTIVE, K14_ROWS, K14_UNVISITED = range(3)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _k14_stream(counter, vals, active, rows, n, ids, count, deg_pad, deg_sum,
                levels=None) -> None:
    """K14's stream entry on the card: ``active`` a bool mask, or None and
    ``rows`` (rows_local, rowflag, edge_count) for the row-flag mode, or
    ``rows`` (None, None, edge_count) and ``levels`` for the unvisited mode;
    ``deg_sum`` (with ``deg_pad``) or None."""
    scratch = torch.empty(K14_MAX_BLOCKS, dtype=torch.int32, device=vals.device)
    bitmap = torch.empty(max((n + 31) // 32, 1), dtype=torch.int32, device=vals.device)
    rows_local, rowflag, edge_count = rows if rows is not None else (None, None, None)
    mode = K14_ACTIVE if rows is None else K14_ROWS if levels is None else K14_UNVISITED
    kernels.launch("frontier_compact_stream", vals.device, vals.data_ptr(), _ptr(active),
                   _ptr(rows_local), _ptr(rowflag), _ptr(edge_count), _ptr(levels), mode,
                   vals.shape[0], n, bitmap.data_ptr(), ids.data_ptr(), ids.shape[0],
                   count.data_ptr(), _ptr(deg_pad), _ptr(deg_sum), scratch.data_ptr(),
                   K14_MAX_BLOCKS, counter=counter)


def _check_into(name, deg_pad, ids, status, device) -> None:
    ts = (deg_pad, ids, status)
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in ts) or status.shape[0] != 2:
        raise TypeError(f"{name}: deg_pad, ids and status [2] must be 1-D int32")
    if any(t.device != device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: deg_pad, ids and status must be contiguous, on one device")


def compact_stream_into(vals: torch.Tensor, active: torch.Tensor, n: int,
                        deg_pad: torch.Tensor, ids: torch.Tensor, status: torch.Tensor) -> None:
    """``compact_stream`` into given buffers: ``ids`` [k] takes the ids,
    ``status`` int32 [2] the true count and the degree sum of the ids
    written (``frontier_deg_sum``; pad ids read deg_pad[n] == 0). One K14
    call on the card, nothing read back."""
    _check_stream("compact_stream_into", vals, active, ids.shape[0], n)
    _check_into("compact_stream_into", deg_pad, ids, status, vals.device)
    if not kernels.use_kernel(vals):
        out, count = compact_stream_plain(vals, active, ids.shape[0], n)
        _put_status(ids, status, out, count, deg_pad)
        return
    _k14_stream("frontier_compact", vals, active, None, n, ids, status[0:1], deg_pad,
                status[1:2])


def _put_status(ids, status, out, count, deg_pad) -> None:
    ids.copy_(out)
    status.copy_(torch.stack([count, frontier_deg_sum(out, deg_pad)]))


def compact_into(mask: torch.Tensor, deg_pad: torch.Tensor, ids: torch.Tensor,
                 status: torch.Tensor) -> None:
    """``compact`` into given buffers: ``ids`` [k] takes the ids, ``status``
    int32 [2] the true count and the degree sum of the ids written
    (``frontier_deg_sum``). BFS's bottom-up residual rows and their
    in-degree sum. One K14 call on the card, nothing read back."""
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise TypeError("compact_into: mask must be a contiguous 1-D bool tensor")
    _check_into("compact_into", deg_pad, ids, status, mask.device)
    if not kernels.use_kernel(mask):
        out, count = compact_plain(mask, ids.shape[0])
        _put_status(ids, status, out, count, deg_pad)
        return
    scratch = torch.empty(K14_MAX_BLOCKS, dtype=torch.int32, device=mask.device)
    kernels.launch("frontier_compact_into", mask.device, mask.data_ptr(), None, None,
                   mask.shape[0], ids.data_ptr(), ids.shape[0], status.data_ptr(),
                   deg_pad.data_ptr(), status[1:].data_ptr(), scratch.data_ptr(),
                   K14_MAX_BLOCKS, counter="frontier_compact")


def _check_level(name, levels, level) -> None:
    """``level``: a one-element int32 tensor on the levels' device."""
    if not isinstance(level, torch.Tensor) or level.dtype != torch.int32 or \
            level.numel() != 1 or level.device != levels.device:
        raise TypeError(f"{name}: level must be a one-element int32 tensor on the levels' "
                        "device")


def compact_level_plain(levels: torch.Tensor, level: torch.Tensor, k: int):
    """K14's level mode, plain PyTorch: the JAX kernel's ``compact(levels
    == level, k)``."""
    return compact_plain(levels == level, k)


def compact_level_into(levels: torch.Tensor, level: torch.Tensor, ids: torch.Tensor,
                       count: torch.Tensor) -> None:
    """K14 wrapper, level mode: the vertices v with ``levels[v] == level``
    (``levels`` int32 [n]; ``level`` a one-element int32 tensor, read on the
    card) into ``ids`` [k] (ascending, padded with n, cut at k), their true
    count into ``count`` (a one-element int32 tensor). BFS's frontier at the
    start of a tier step. One call, no host read."""
    _check_level("compact_level_into", levels, level)
    ts = (levels, ids, count)
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in ts) or count.shape != (1,):
        raise TypeError("compact_level_into: levels, ids and count [1] must be 1-D int32")
    if any(t.device != levels.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("compact_level_into: inputs must be contiguous, on one device")
    if not kernels.use_kernel(levels):
        out, c = compact_level_plain(levels, level, ids.shape[0])
        ids.copy_(out)
        count.copy_(c.reshape(1))
        return
    scratch = torch.empty(K14_MAX_BLOCKS, dtype=torch.int32, device=levels.device)
    kernels.launch("frontier_compact_into", levels.device, None, levels.data_ptr(),
                   level.data_ptr(), levels.shape[0], ids.data_ptr(), ids.shape[0],
                   count.data_ptr(), None, None, scratch.data_ptr(), K14_MAX_BLOCKS,
                   counter="frontier_compact_level")


def compact_unvisited_plain(exp: Expansion, levels: torch.Tensor, n: int,
                            deg_pad: torch.Tensor, ids: torch.Tensor,
                            status: torch.Tensor) -> None:
    """K14's unvisited mode, plain PyTorch: the JAX tier step's ``unvisited =
    valid & (table_gather(levels, neigh) == INT32_INF)``, ``compact_stream``
    over it and ``frontier_deg_sum``."""
    unvisited = exp.valid & (table_gather(levels, exp.neigh) == INT32_INF)
    out, count = compact_stream_plain(exp.neigh, unvisited, ids.shape[0], n)
    _put_status(ids, status, out, count, deg_pad)


def compact_unvisited_into(exp: Expansion, levels: torch.Tensor, n: int,
                           deg_pad: torch.Tensor, ids: torch.Tensor,
                           status: torch.Tensor) -> None:
    """K14 wrapper, unvisited mode: the distinct neighbours ``exp.neigh[j]``
    of the slots j < ``exp.edge_count`` with ``levels[neigh[j]] ==
    INT32_INF`` (``levels`` int32 [n]), into ``ids`` [k] (ascending, padded
    with n, cut at k), with ``status`` int32 [2] = (true count, degree sum
    of the ids written). BFS's new frontier after a tier step's expansion.
    One call, no host read."""
    _check_stream("compact_unvisited_into", exp.neigh, exp.valid, ids.shape[0], n)
    _check_into("compact_unvisited_into", deg_pad, ids, status, exp.neigh.device)
    if levels.dtype != torch.int32 or levels.shape != (n,) or not levels.is_contiguous() or \
            levels.device != exp.neigh.device:
        raise TypeError(f"compact_unvisited_into: levels must be a contiguous int32 [{n}]")
    if not kernels.use_kernel(exp.neigh):
        compact_unvisited_plain(exp, levels, n, deg_pad, ids, status)
        return
    _k14_stream("frontier_compact_unvisited", exp.neigh, None, (None, None, exp.edge_count), n,
                ids, status[0:1], deg_pad, status[1:2], levels=levels)


def compact_rows_plain(exp: Expansion, rowflag: torch.Tensor, n: int, deg_pad: torch.Tensor,
                       ids: torch.Tensor, status: torch.Tensor) -> None:
    """K14's row-flag mode, plain PyTorch: the JAX kernel's ch_edge mask
    (valid slots whose row's flag is set, a gather of the flags by
    rows_local), ``compact_stream_plain`` over it and ``frontier_deg_sum``."""
    ch_edge = exp.valid & (table_gather(rowflag.to(torch.int32), exp.rows_local) == 1)
    out, count = compact_stream_plain(exp.neigh, ch_edge, ids.shape[0], n)
    _put_status(ids, status, out, count, deg_pad)


def compact_rows_into(exp: Expansion, rowflag: torch.Tensor, n: int, deg_pad: torch.Tensor,
                      ids: torch.Tensor, status: torch.Tensor) -> None:
    """K14 wrapper, row-flag mode: the distinct neighbours ``exp.neigh[j]``
    of the slots j < ``exp.edge_count`` whose row ``exp.rows_local[j]`` has
    ``rowflag`` set (bool, one a frontier row), into ``ids`` [k] (ascending,
    padded with n, cut at k), with ``status`` int32 [2] = (true count,
    degree sum of the ids written). CDLP's next active set after a tier
    step: the neighbours of the rows that changed. One call, no host read."""
    _check_stream("compact_rows_into", exp.neigh, exp.valid, ids.shape[0], n)
    _check_into("compact_rows_into", deg_pad, ids, status, exp.neigh.device)
    if rowflag.dtype != torch.bool or rowflag.dim() != 1 or not rowflag.is_contiguous() or \
            rowflag.device != exp.neigh.device:
        raise TypeError("compact_rows_into: rowflag must be a contiguous 1-D bool tensor")
    if not kernels.use_kernel(exp.neigh):
        compact_rows_plain(exp, rowflag, n, deg_pad, ids, status)
        return
    _k14_stream("frontier_compact_rows", exp.neigh, None,
                (exp.rows_local, rowflag, exp.edge_count), n, ids, status[0:1], deg_pad,
                status[1:2])


def compact_stream(vals: torch.Tensor, active: torch.Tensor, k: int, n: int):
    """K14 wrapper: the distinct active values of a stream -> (ids [k]
    ascending, padded with n, true count as a 0-d int32). ``vals`` [e] int32
    holds ids in [0, n] (n, the pad id, is never taken), ``active`` [e]
    bool. On the card the values mark a bitmap of n bits, which dedupes and
    orders them without a sort."""
    _check_stream("compact_stream", vals, active, k, n)
    if not kernels.use_kernel(vals):
        return compact_stream_plain(vals, active, k, n)
    ids = torch.empty(k, dtype=torch.int32, device=vals.device)
    count = torch.empty((), dtype=torch.int32, device=vals.device)
    _k14_stream("frontier_compact", vals, active, None, n, ids, count, None, None)
    return ids, count


def residual_hits(fmask_pad: torch.Tensor, exp: Expansion, e_cap: int) -> torch.Tensor:
    """Bool [K]: whether any slot of frontier row i of ``exp`` (``e_cap``
    slots) holds a neighbour marked 1 in ``fmask_pad`` (int32 [n+1], 0 at
    n). BFS's bottom-up residual test, the JAX package's cumsum of the hits
    differenced at the row starts, as one K7 ``max_i32`` over the rows'
    slot ranges: the starts are clamped to e_cap, and one more segment
    closes the slots past the last row (pad slots, whose neighbour 0 may
    be marked) and is dropped. A row's range holds only valid slots, so
    the two agree on every row, a cut one included. K17 took its place on
    the paths (``residual_claim``)."""
    indptr = residual_indptr(exp, e_cap)
    return csr_pull_reduce("max_i32", fmask_pad, exp.neigh, indptr)[:-1] > 0


def residual_claim_plain(levels: torch.Tensor, level, exp: Expansion, e_cap: int,
                         rids: torch.Tensor, pad: int) -> torch.Tensor:
    """K17's plain PyTorch version, the composite it replaced: the frontier
    mask padded by one, K7's plain ``max_i32`` over the rows' clamped slot
    ranges (``residual_indptr``), ``> 0`` and a where. ``level`` an int or a
    one-element tensor."""
    fmask_pad = torch.cat([(levels == level).to(torch.int32), levels.new_zeros(1)])
    hits = csr_pull_reduce_plain("max_i32", fmask_pad, exp.neigh, residual_indptr(exp, e_cap))
    return torch.where(hits[:-1] > 0, rids, pad)


def residual_claim(levels: torch.Tensor, level, exp: Expansion, e_cap: int,
                   rids: torch.Tensor, pad: int) -> torch.Tensor:
    """K17 wrapper, BFS's bottom-up residual test: int32 [K], ``rids[i]``
    where row i of ``exp`` (the expansion of the K residual rows ``rids``
    in ``e_cap`` slots) has a slot in [min(seg_starts[i], e_cap),
    min(seg_starts[i + 1], e_cap)) whose neighbour v has ``levels[v] ==
    level``, else ``pad`` (n on one device; the rank's row count in the
    distributed BFS, whose ``levels`` are the replicated global ones). The
    JAX package's ``claimed_ids``. ``level``: an int, or a one-element int32
    tensor on the levels' device that the kernel reads there (the
    device-level mode, counted as ``bfs_residual_claim_at``). One launch, no
    host read."""
    ts = (levels, exp.neigh, exp.seg_starts, rids)
    at = isinstance(level, torch.Tensor)
    if at:
        _check_level("residual_claim", levels, level)
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in ts):
        raise TypeError("residual_claim: levels, neigh, seg_starts and rids must be 1-D int32")
    if any(t.device != levels.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("residual_claim: inputs must be contiguous, on one device")
    k = rids.shape[0]
    if exp.seg_starts.shape[0] != k + 1 or not 0 <= e_cap <= exp.neigh.shape[0]:
        raise ValueError(f"residual_claim: {exp.seg_starts.shape[0]} row starts for {k} rows, "
                         f"or e_cap {e_cap} past {exp.neigh.shape[0]} slots")
    if not kernels.use_kernel(levels):
        return residual_claim_plain(levels, level, exp, e_cap, rids, pad)
    out = torch.empty(k, dtype=torch.int32, device=levels.device)
    if k:
        kernels.launch("bfs_residual_claim", levels.device, levels.data_ptr(), levels.shape[0],
                       0 if at else int(level), level.data_ptr() if at else None,
                       exp.neigh.data_ptr(), exp.seg_starts.data_ptr(), rids.data_ptr(), k,
                       e_cap, int(pad), out.data_ptr(), 8 * kernels.sm_count(levels.device),
                       counter="bfs_residual_claim_at" if at else None)
    return out


def residual_indptr(exp: Expansion, e_cap: int) -> torch.Tensor:
    """The K7 indptr of ``residual_hits``: the frontier rows' slot starts
    clamped to ``e_cap``, closed by one more segment that ends at e_cap."""
    starts = torch.clamp(exp.seg_starts, max=e_cap)
    return torch.cat([starts, starts.new_full((1,), e_cap)])


def frontier_deg_sum(ids: torch.Tensor, deg_pad: torch.Tensor) -> torch.Tensor:
    """Sum of degrees over a compacted frontier (pad ids read 0). A lower
    bound when the frontier was cut (count > K): callers check the count."""
    return table_gather(deg_pad, ids).sum(dtype=torch.int32)


def relax_min_plain(dist, row_ids, neigh, gpos, valid, w) -> torch.Tensor:
    """K8's plain PyTorch version, the JAX function's formulation: gathers
    of dist at the owners and of w at the positions, then a scatter-min
    into a copy of dist whose extra slot n takes the invalid slots."""
    if not w.numel():  # an edgeless graph: no valid slot
        return dist.clone()
    n = dist.shape[0]
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
    cand = table_gather(dist, torch.where(valid, row_ids, 0)) + table_gather(w, gpos)
    out = torch.cat([dist, inf.reshape(1)])
    out.scatter_reduce_(0, torch.where(valid, neigh, n).long(), torch.where(valid, cand, inf),
                        "amin")
    return out[:n]


def relax_min(dist: torch.Tensor, row_ids: torch.Tensor, neigh: torch.Tensor,
              gpos: torch.Tensor, valid: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K8 wrapper: a copy of ``dist`` with, for each valid slot e of an
    expansion, dist[neigh[e]] lowered to dist[row_ids[e]] + w[gpos[e]] where
    that is smaller. ``dist`` and ``w`` float32 or float64 of one dtype;
    ``row_ids``, ``neigh``, ``gpos`` int32 and ``valid`` bool, all [E]."""
    if dist.dtype not in (torch.float32, torch.float64) or w.dtype != dist.dtype:
        raise TypeError(f"relax_min: dist and w must share a float dtype, got {dist.dtype}, "
                        f"{w.dtype}")
    slots = (row_ids, neigh, gpos)
    if any(t.dtype != torch.int32 for t in slots) or valid.dtype != torch.bool:
        raise TypeError("relax_min: row_ids, neigh and gpos must be int32, valid bool")
    ts = (dist, w, valid) + slots
    if any(t.dim() != 1 for t in ts) or any(t.shape != valid.shape for t in slots):
        raise ValueError("relax_min: 1-D inputs, the four slot tensors of one length")
    if any(t.device != dist.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("relax_min: inputs must be contiguous, on one device")
    if not kernels.use_kernel(dist):
        return relax_min_plain(dist, row_ids, neigh, gpos, valid, w)
    out = dist.clone()
    e_cap = valid.shape[0]
    if e_cap:
        kernels.launch(
            "push_relax_min", dist.device, dist.data_ptr(), row_ids.data_ptr(),
            neigh.data_ptr(), gpos.data_ptr(), valid.data_ptr(), w.data_ptr(), out.data_ptr(),
            e_cap, int(dist.dtype == torch.float64),
        )
    return out


def relax_min_into_plain(dist, ids, exp: Expansion, w, mask) -> None:
    """K8's in-place mode, plain PyTorch: the JAX round's formulation (the
    owners' ids gathered by rows_local, ``relax_min_plain`` into a new
    vector), then ``mask`` := new < dist and dist := new."""
    new = relax_min_plain(dist, table_gather(ids, exp.rows_local), exp.neigh, exp.gpos,
                          exp.valid, w)
    torch.lt(new, dist, out=mask)
    dist.copy_(new)


def relax_min_into(dist: torch.Tensor, ids: torch.Tensor, exp: Expansion, w: torch.Tensor,
                   mask: torch.Tensor) -> None:
    """K8 wrapper, in-place mode (SSSP auto's tier round): for each real
    slot e of ``exp``, the expansion of the frontier ``ids`` [k] (ascending,
    padded with n), dist[neigh[e]] is lowered in place to
    dist[ids[rows_local[e]]] + w[gpos[e]], the owner's distance as it was
    before the call, where that is smaller; ``mask`` [n] bool := the
    vertices lowered (JAX's ``new < dist``). ``dist`` and ``w`` float32 or
    float64 of one dtype. One call (a memset of the mask, a snapshot of the
    frontier's distances, the relaxation over the real slots, whose count is
    read on the card), nothing read back."""
    if dist.dtype not in (torch.float32, torch.float64) or w.dtype != dist.dtype:
        raise TypeError(f"relax_min_into: dist and w must share a float dtype, got {dist.dtype}, "
                        f"{w.dtype}")
    slots = (exp.rows_local, exp.neigh, exp.gpos)
    if ids.dtype != torch.int32 or any(t.dtype != torch.int32 for t in slots) or \
            mask.dtype != torch.bool or exp.edge_count.dtype != torch.int32:
        raise TypeError("relax_min_into: int32 ids and expansion, bool mask")
    ts = (dist, ids, w, mask) + slots
    if any(t.dim() != 1 for t in ts) or mask.shape != dist.shape or \
            any(t.shape != exp.neigh.shape for t in slots):
        raise ValueError("relax_min_into: 1-D inputs, mask as long as dist, slots of one length")
    if any(t.device != dist.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("relax_min_into: inputs must be contiguous, on one device")
    if not kernels.use_kernel(dist):
        relax_min_into_plain(dist, ids, exp, w, mask)
        return
    k, n, e_cap = ids.shape[0], dist.shape[0], exp.neigh.shape[0]
    du = torch.empty(k, dtype=dist.dtype, device=dist.device)
    kernels.launch("push_relax_min_inplace", dist.device, dist.data_ptr(), ids.data_ptr(), k, n,
                   du.data_ptr(), exp.rows_local.data_ptr(), exp.neigh.data_ptr(),
                   exp.gpos.data_ptr(), w.data_ptr(), exp.edge_count.data_ptr(), e_cap,
                   mask.data_ptr(), 1 if dist.dtype == torch.float64 else 0,
                   2 * kernels.sm_count(dist.device))


def relax_min_i32_plain(n_out: int, labels, row_ids, neigh, valid, row_offset: int = 0):
    """K8's int32 mode, plain PyTorch: the JAX function's gather of the
    owners' labels and scatter-min into a vector of INT32_INF whose extra
    slot n_out takes the invalid slots. ``valid`` is a bool mask of the
    slots, or a 0-d int32 count of real slots (slots [0, valid) are real,
    as in an expansion)."""
    if valid.dtype != torch.bool:
        valid = torch.arange(row_ids.shape[0], device=row_ids.device) < valid
    cand = torch.full((n_out + 1,), INT32_INF, dtype=torch.int32, device=labels.device)
    if not valid.numel():
        return cand[:n_out]
    lab = table_gather(labels, torch.where(valid, row_ids + row_offset, 0))
    cand.scatter_reduce_(0, torch.where(valid, neigh, n_out).long(),
                         torch.where(valid, lab, INT32_INF), "amin")
    return cand[:n_out]


def relax_min_i32(n_out: int, labels: torch.Tensor, row_ids: torch.Tensor,
                  neigh: torch.Tensor, total: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    """K8 wrapper, int32 mode: int32 [n_out] of INT32_INF lowered, for each
    real slot e of an expansion, to labels[row_ids[e] + row_offset] at
    neigh[e] (in [0, n_out)). The real slots are [0, total): ``total`` is
    the expansion's 0-d int32 edge count (``Expansion.edge_count``), read
    on the device, never on the host. The distributed WCC's active step."""
    slots = (row_ids, neigh)
    if labels.dtype != torch.int32 or any(t.dtype != torch.int32 for t in slots + (total,)):
        raise TypeError("relax_min_i32: labels, row_ids, neigh and total must be int32")
    ts = (labels, total) + slots
    if labels.dim() != 1 or total.dim() != 0 or any(t.dim() != 1 for t in slots) or \
            row_ids.shape != neigh.shape:
        raise ValueError("relax_min_i32: 1-D labels, row_ids and neigh of one length, a 0-d total")
    if any(t.device != labels.device for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("relax_min_i32: inputs must be contiguous, on one device")
    if n_out < 0 or row_offset < 0 or row_ids.shape[0] >= 1 << 31:
        raise ValueError(f"relax_min_i32: n_out {n_out}, row_offset {row_offset} or "
                         f"{row_ids.shape[0]} slots out of range")
    if not kernels.use_kernel(labels):
        return relax_min_i32_plain(n_out, labels, row_ids, neigh, total, row_offset)
    out = torch.full((n_out,), INT32_INF, dtype=torch.int32, device=labels.device)
    e_cap = row_ids.shape[0]
    if e_cap:
        kernels.launch("push_relax_min_i32", labels.device, labels.data_ptr(),
                       row_ids.data_ptr(), neigh.data_ptr(), total.data_ptr(), out.data_ptr(),
                       e_cap, row_offset, n_out, 2 * kernels.sm_count(labels.device))
    return out


def bfs_trunc_probe_plain(levels, level, trunc, pdeg, t: int, row_offset: int = 0):
    """K13's plain PyTorch version: a gather of the levels at the table's
    ids (an id outside [0, len(levels)) is no hit), an any over the t
    table rows, and the two masks. ``level`` an int or a one-element
    tensor."""
    r, n = pdeg.shape[0], levels.shape[0]
    ok = (trunc >= 0) & (trunc < n)
    hit = ok & (levels.index_select(0, torch.where(ok, trunc, 0)) == level)
    hit = hit.reshape(t, r).any(0)
    unvisited = levels[row_offset:row_offset + r] == INT32_INF
    return unvisited & hit, unvisited & (pdeg > t) & ~hit


def bfs_trunc_probe(levels: torch.Tensor, level, trunc: torch.Tensor,
                    pdeg: torch.Tensor, t: int, row_offset: int = 0):
    """K13 wrapper: the truncated bottom-up probe of BFS over r =
    len(pdeg) rows. Row v hits when one of its first ``t`` in-neighbours,
    ``trunc[j * r + v]`` (an id outside [0, len(levels)) is the sentinel),
    sits at ``level``; it is unvisited when ``levels[row_offset + v]`` is
    INT32_INF. Returns bool [r] masks (claim: unvisited and hit; resid:
    unvisited, not hit and ``pdeg[v] > t``, the rows whose full in-lists
    must be checked). ``levels`` (the frontier's source, replicated in the
    distributed BFS), ``trunc`` [t * r] and ``pdeg`` are int32. ``level``:
    an int, or a one-element int32 tensor on the levels' device that the
    kernel reads there (the device-level mode, counted as
    ``bfs_trunc_probe_at``)."""
    ts = (levels, trunc, pdeg)
    at = isinstance(level, torch.Tensor)
    if at:
        _check_level("bfs_trunc_probe", levels, level)
    if any(x.dtype != torch.int32 or x.dim() != 1 for x in ts):
        raise TypeError("bfs_trunc_probe: levels, trunc and pdeg must be 1-D int32")
    if any(x.device != levels.device for x in ts) or not all(x.is_contiguous() for x in ts):
        raise ValueError("bfs_trunc_probe: inputs must be contiguous, on one device")
    r, n = pdeg.shape[0], levels.shape[0]
    if t < 1 or trunc.shape[0] != t * r or not 0 <= row_offset <= n - r:
        raise ValueError(f"bfs_trunc_probe: need t >= 1, t * {r} table entries and rows "
                         f"[{row_offset}, {row_offset + r}) inside {n} levels")
    if not kernels.use_kernel(levels):
        return bfs_trunc_probe_plain(levels, level, trunc, pdeg, t, row_offset)
    claim = torch.empty(r, dtype=torch.bool, device=levels.device)
    resid = torch.empty(r, dtype=torch.bool, device=levels.device)
    if r:
        kernels.launch("bfs_trunc_probe", levels.device, levels.data_ptr(), n,
                       0 if at else int(level), level.data_ptr() if at else None,
                       trunc.data_ptr(), t, r, row_offset, pdeg.data_ptr(), claim.data_ptr(),
                       resid.data_ptr(), counter="bfs_trunc_probe_at" if at else None)
    return claim, resid


def scatter_frontier(mask_cap: int, neigh: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Dense bool mask of size mask_cap marking ``neigh[active]``; ids
    equal to mask_cap are dropped."""
    idx = torch.where(active, neigh, mask_cap).long()
    out = torch.zeros(mask_cap + 1, dtype=torch.bool, device=neigh.device)
    return out.index_fill_(0, idx, True)[:mask_cap]
