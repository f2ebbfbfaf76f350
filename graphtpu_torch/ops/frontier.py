"""Compacted frontier / active-set engine with static capacities
(counterpart of graphtpu/ops/frontier.py).

A frontier is a fixed-capacity id buffer ``ids [K]`` (ascending, padded
with n) plus its true count. ``compact`` turns a dense mask into one,
``expand`` lays the frontier's adjacency slices out in ``e_cap`` edge
slots on kernel K5 (``frontier_expand``), ``compact_stream`` dedupes a
stream of vertex ids back into a frontier, ``mask_status`` gives a
mask's (count, edge-sum), the numbers a caller needs to decide whether a
frontier fits its capacities, and ``relax_min`` is SSSP's push relaxation
over an expansion on kernel K8 (``push_relax_min``). Every function
returns the JAX function's values, pad slots included, and never reads a
value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from graphtpu_torch.ops import kernels
from graphtpu_torch.ops.gather import table_gather


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


def compact(mask: torch.Tensor, k: int):
    """Dense bool mask [n] -> (ids [k] ascending, padded with n, count).
    Ids past k are cut; the count is the true one."""
    n = mask.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    ids = torch.sort(torch.where(mask, idx, n)).values
    return _fit(ids, k, n), mask.sum(dtype=torch.int32)


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


def expand(ids: torch.Tensor, deg_pad: torch.Tensor, indptr_pad: torch.Tensor,
           neigh: torch.Tensor, e_cap: int, with_row_ids: bool = True) -> Expansion:
    """Concatenate the adjacency slices of ``ids`` into [e_cap] slots.

    ``deg_pad``/``indptr_pad`` are [n+1] with deg_pad[n] == 0, so the pad
    id n reads as an empty slice. Edges past e_cap are cut: callers check
    ``edge_count <= e_cap`` first. A pad slot belongs to the last nonempty
    row (row 0 when there is none)."""
    lens = table_gather(deg_pad, ids)
    starts = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0, dtype=torch.int32)])
    rows_local, row_ids, gpos, nb, valid = frontier_expand(
        ids, starts, indptr_pad, neigh, e_cap, with_row_ids
    )
    return Expansion(rows_local, row_ids, nb, gpos, starts, starts[-1], valid)


def compact_stream(vals: torch.Tensor, active: torch.Tensor, k: int, n: int):
    """Unique active values of a stream -> (ids [k] ascending, padded with
    n, true count)."""
    s = torch.sort(torch.where(active, vals, n)).values
    first = s < n
    first[1:] &= s[1:] != s[:-1]
    ids = torch.sort(torch.where(first, s, n)).values
    return _fit(ids, k, n), first.sum(dtype=torch.int32)


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


def scatter_frontier(mask_cap: int, neigh: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Dense bool mask of size mask_cap marking ``neigh[active]``; ids
    equal to mask_cap are dropped."""
    idx = torch.where(active, neigh, mask_cap).long()
    out = torch.zeros(mask_cap + 1, dtype=torch.bool, device=neigh.device)
    return out.index_fill_(0, idx, True)[:mask_cap]
