"""Degree-oriented wedge enumeration for LCC: the scalable triangle path
(counterpart of graphtpu/ops/triangles.py, its rowblock path).

The membership sweep (algorithms/lcc.py) enumerates, for every directed
A-edge, the whole neighbourhood of the smaller endpoint. Degree orientation
cuts that: every symmetrized edge points from its lower-ranked endpoint to
its higher-ranked one (rank = (degree, id)), so each triangle holds exactly
one wedge (u -> x, u -> y) with an oriented edge x -> y, and enumerating the
out-out pairs of every vertex and testing x -> y counts each triangle once.
Out-degrees after orientation are small even where raw degrees are not.

Rows are bucketed by oriented out-degree d+ into padded slabs [W, R_pad]
with per-graph DP-optimal widths. Per bucket, ``wedge_rowblock`` (kernel
K10, csrc/wedge_rowblock.cu) tests every real out-out pair of every row
and returns the credits. The kernel closes a wedge (u; x, y) by finding y
in out(x), a sorted list of the plan's closing CSR; ``_wedge_bucket_rowblock``
is its plain PyTorch version, which probes the edge hash (ops/edgehash.py)
for each pair as the JAX package does, chunked over row blocks and pair
chunks as the JAX package chunks it, so that its memory stays bounded. The
closing CSR leaves out the keys the hash spilled, so both see the same
edges.

Graphalytics / LAGraph_lcc semantics (lcc.cpp:61-70; the numerator counts
directed A-edges between distinct neighbours): each corner of a found
triangle {u, x, y} is credited with the stored-direction multiplicity (1 or
2) of its OPPOSITE edge: u gets mult(x, y) (the hash payload), x gets
mult(u, y) (the j-leg), y gets mult(u, x) (the i-leg). The x and y credits
are sums per (slot, row), that is per oriented edge; they reach the vertices
by one gather in head order and one segment sum.

Vertex ids are RELABELED by rank on the host, so that id order is rank
order: every adjacency list is then sorted by id and by rank at once, and
orientation is "smaller id to larger id".
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from graphtpu_torch.core.types import INT32_INF
from graphtpu_torch.ops import edgehash, kernels
from graphtpu_torch.ops.edgehash import EdgeHash, probe_edge_hash_xy
from graphtpu_torch.ops.gather import table_gather
from graphtpu_torch.ops.scan_reduce import seg_sum_scan
from graphtpu_torch.ops.slab import optimal_bucket_bounds
from graphtpu_torch.ops.spmv import int32_tensor
from graphtpu_torch.utils.logging import get_logger

# The plain version's tiling, and the plan's row-block width that follows
# from it (kept equal to the JAX package's, so R_pad and edge_pos agree):
# probes per inner step (pc * rc) and the cap of the row-block width.
_CHUNK_PROBES = 1 << 18
_ROWBLOCK_RC_CAP = 1 << 11

# the widest row the plan takes, and the budget of bucket widths
_MAX_WEDGE_WIDTH = 4096
_WEDGE_BUCKET_K = 16


def _optimal_bucket_bounds(d_plus: np.ndarray) -> list:
    """DP-optimal wedge-bucket upper bounds for THIS graph's oriented
    out-degree histogram: at most 16 boundaries minimizing the padded pair
    count, the sum over buckets of rows_b W_b (W_b - 1) / 2. Graphs with at
    most 16 distinct degrees get exact buckets."""
    return optimal_bucket_bounds(d_plus, k=_WEDGE_BUCKET_K, kind="pairs", lo=1)


class WedgeBucket(NamedTuple):
    rows: np.ndarray          # [R] host int64 ranked centre ids
    slab: torch.Tensor        # [W, R_pad] int32 out-neighbour ranked ids, -1 pad
    mslab: torch.Tensor       # [W, R_pad] int32 edge multiplicities, 0 pad
    r_real: int
    chunk_cols: int           # rc: the plain version's row-block width


class ClosingCSR(NamedTuple):
    """The oriented out-lists by tail, over ranked ids, without the keys the
    edge hash spilled: what K10 searches to close a wedge."""
    indptr: torch.Tensor  # [n + 1] int32
    ids: torch.Tensor     # [M'] int32 heads, ascending within each tail's list
    mult: torch.Tensor    # [M'] uint8 stored-direction multiplicity (1 or 2)


def closing_csr(ex, ey, mult, spilled: np.ndarray, n: int) -> ClosingCSR:
    """The closing CSR from the oriented stream sorted by (ex, ey) (int
    tensors on the plan's device) and the hash's spill mask over it."""
    if spilled.any():
        keep = torch.from_numpy(~spilled).to(ex.device)
        ex, ey, mult = ex[keep], ey[keep], mult[keep]
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=ex.device)
    indptr[1:] = torch.cumsum(torch.bincount(ex, minlength=n), 0)
    return ClosingCSR(indptr, ey.to(torch.int32).contiguous(), mult.to(torch.uint8))


class WedgePlan(NamedTuple):
    buckets: tuple
    n: int
    id_bits: int
    deg_s: np.ndarray         # [n] symmetrized degree (original ids)
    rank: np.ndarray          # [n] original id -> ranked id
    ehash: EdgeHash
    # aggregation of the per-edge credits in head order:
    edge_pos: Optional[torch.Tensor]     # [M] flat positions of real slab entries
    head_indptr: Optional[torch.Tensor]  # [n+1] segment starts by head (ranked)
    bucket_rows: Optional[torch.Tensor]  # [sum R] int64: the buckets' rows, on the device
    # host copies for the rare spilled-key patch (ranked ids, (ex, ey) sorted)
    ex: np.ndarray
    ey: np.ndarray
    mult: np.ndarray
    spilled: np.ndarray       # bool mask over the oriented edge stream
    closing: ClosingCSR       # what K10 searches, on the device


def _orient_sort_kernel(eu, ev, mult, rank, id_bits):
    """Rank gathers, orientation and one sort of the packed int64 pair keys
    on the device. The pairs are unique, so the order is the one a sort by
    (ex, ey) gives."""
    ru = table_gather(rank, eu)
    rv = table_gather(rank, ev)
    packed = (torch.minimum(ru, rv).long() << id_bits) | torch.maximum(ru, rv).long()
    packed, order = torch.sort(packed)
    ex_s = (packed >> id_bits).to(torch.int32)
    ey_s = (packed & ((1 << id_bits) - 1)).to(torch.int32)
    return packed, mult[order], ex_s, ey_s


def _fill_slab_kernel(ey_dev, mult_dev, starts, degs, w, off):
    """One bucket's slabs by two gathers of the sorted stream. Also gives
    every entry's head id and its flat position in the transposed
    [W, R_pad] layout (offset by ``off``) for the edge-credit aggregation;
    pad entries get INT32_INF heads, so a sort by head puts them last."""
    r_pad = starts.shape[0]
    dev = starts.device
    offs = torch.arange(w, dtype=torch.int32, device=dev)
    pos = starts[:, None] + offs[None, :]
    mask = offs[None, :] < degs[:, None]
    safe = torch.where(mask, pos, 0)
    slab = torch.where(mask, table_gather(ey_dev, safe), -1)
    mslab = torch.where(mask, table_gather(mult_dev, safe), 0)
    rr = torch.arange(r_pad, dtype=torch.int32, device=dev)[:, None]
    tpos = torch.where(mask, offs[None, :] * r_pad + rr + off, 0)
    heads = torch.where(mask, slab, INT32_INF)
    return slab.t().contiguous(), mslab.t().contiguous(), heads.reshape(-1), tpos.reshape(-1)


def _head_sort_kernel(heads, tpos):
    """Stable sort of the (head, position) pairs by head; the INT32_INF
    heads of slab padding come last and are cut by the real count."""
    heads_s, order = torch.sort(heads, stable=True)
    return heads_s, tpos[order]


class WedgeCapacityError(ValueError):
    """The oriented out-degree exceeds the largest wedge bucket: the only
    condition under which lcc-impl=auto may fall back to the membership
    sweep (catching a bare ValueError would turn a real fault anywhere in
    the pipeline into a silent sweep)."""


_WEDGE_CACHE_VERSION = 2


def _wedge_cache_file(cache_dir, graph):
    name = getattr(graph, "name", None)
    if cache_dir is None or not name:
        return None
    return Path(cache_dir) / name / "wedge-v2.npz"


def _load_oriented_cache(cache_dir, graph):
    """Oriented edge list and rank from the ingest cache (the skip-if-exists
    contract of load-graph.sh:50-67 applied to LCC prep)."""
    f = _wedge_cache_file(cache_dir, graph)
    if f is None or not f.exists():
        return None
    log = get_logger("lcc")
    try:
        with np.load(f) as z:
            if (
                int(z["version"]) != _WEDGE_CACHE_VERSION
                or int(z["n"]) != graph.n
                or int(z["nnz"]) != graph.nnz
            ):
                log.warning("wedge cache %s incompatible: ignoring", f)
                return None
            out = tuple(z[k].astype(np.int64) for k in ("ex", "ey", "mult", "rank", "deg_s"))
        log.info("wedge cache hit: %s", f)
        return out
    except Exception as e:  # a corrupt or truncated cache is rebuilt
        log.warning("wedge cache %s unreadable (%s): rebuilding", f, e)
        return None


def _save_oriented_cache(cache_dir, graph, ex, ey, mult, rank, deg_s):
    f = _wedge_cache_file(cache_dir, graph)
    if f is None:
        return
    f.parent.mkdir(parents=True, exist_ok=True)
    tmp = f.with_suffix(".tmp.npz")
    # uncompressed: reading it back must cost less than the prep it saves
    np.savez(
        tmp,
        version=_WEDGE_CACHE_VERSION,
        n=graph.n,
        nnz=graph.nnz,
        ex=ex.astype(np.int32),
        ey=ey.astype(np.int32),
        mult=mult.astype(np.int8),
        rank=rank.astype(np.int32),
        deg_s=deg_s.astype(np.int32),
    )
    tmp.replace(f)
    get_logger("lcc").info("wedge cache written: %s", f)


def prepare_wedge_plan(graph, cache_dir=None, *, device) -> WedgePlan:
    """Wedge-plan prep: symmetrize and dedupe with the stored-direction
    multiplicity (host: the input stream is nearly sorted, so the linear
    passes dominate), then rank relabel, orientation, sort, hash build, slab
    fill and head sort on ``device``. With ``cache_dir`` the oriented edge
    list is kept per graph and restored on repeat runs."""
    n = graph.n
    id_bits = max(int(max(n - 1, 1)).bit_length(), 1)

    cached = _load_oriented_cache(cache_dir, graph)
    if cached is not None:
        ex, ey, mult, rank, deg_s = cached
        mult_d = int32_tensor(mult, device)
        ex32 = int32_tensor(ex, device)
        ey32 = int32_tensor(ey, device)
        packed = (ex32.long() << id_bits) | ey32.long()
    else:
        s, d = graph.src, graph.dst
        keep = s != d
        s, d = s[keep], d[keep]
        lo = np.minimum(s, d).astype(np.int64)
        hi = np.maximum(s, d).astype(np.int64)
        key = (lo << id_bits) | hi
        key.sort()  # pull-ordered input is nearly sorted: cheap on the host
        is_first = np.ones(key.shape[0], dtype=bool)
        is_first[1:] = key[1:] != key[:-1]
        uniq = key[is_first]
        # Graph dedupes directed pairs, so a pair's multiplicity is 1 or 2
        first_pos = np.nonzero(is_first)[0]
        mult = np.diff(np.concatenate([first_pos, [key.shape[0]]])).astype(np.int64)

        eu = (uniq >> id_bits).astype(np.int64)
        ev = (uniq & ((1 << id_bits) - 1)).astype(np.int64)
        deg_s = (np.bincount(eu, minlength=n) + np.bincount(ev, minlength=n)).astype(np.int64)

        # rank relabel: id order == (degree, id) order
        order_v = np.lexsort((np.arange(n), deg_s))
        rank = np.empty(n, dtype=np.int64)
        rank[order_v] = np.arange(n, dtype=np.int64)

        packed, mult_d, ex32, ey32 = _orient_sort_kernel(
            int32_tensor(eu, device), int32_tensor(ev, device), int32_tensor(mult, device),
            int32_tensor(rank, device), id_bits,
        )
        ex = ex32.cpu().numpy().astype(np.int64)
        ey = ey32.cpu().numpy().astype(np.int64)
        mult = mult_d.cpu().numpy().astype(np.int64)
        _save_oriented_cache(cache_dir, graph, ex, ey, mult, rank, deg_s)

    d_plus = np.bincount(ex, minlength=n).astype(np.int64)
    indptr_o = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(d_plus, out=indptr_o[1:])

    # looked up through the module, so that a test can swap in a build that
    # overfills the table and forces spills
    ehash, spilled = edgehash.build_edge_hash_device(packed, mult_d, fill=0.25)
    closing = closing_csr(ex32, ey32, mult_d, spilled, n)

    # bucket the rows with d+ >= 2 into padded slabs; collect every real
    # entry's (head, transposed flat position) for the edge-credit aggregation
    buckets = []
    heads_parts, tpos_parts = [], []
    m_real = 0
    flat_offset = 0
    prev = 1  # rows with d+ < 2 generate no wedges
    max_dp = int(d_plus.max()) if n else 0
    if max_dp > _MAX_WEDGE_WIDTH:
        raise WedgeCapacityError(
            f"oriented out-degree {max_dp} exceeds the largest wedge bucket {_MAX_WEDGE_WIDTH}"
        )
    for w in _optimal_bucket_bounds(d_plus):
        if prev >= max_dp:
            break
        sel = np.nonzero((d_plus > prev) & (d_plus <= w))[0]
        prev = w
        if sel.size == 0:
            continue
        r = sel.shape[0]
        n_pairs = w * (w - 1) // 2
        # the plain version's row-block width: one inner step carries about
        # _CHUNK_PROBES probes for narrow buckets (few pairs, wide blocks),
        # near 128 rows for wide ones, where wider blocks only pad rows
        target = max(128, _CHUNK_PROBES // max(n_pairs, 1))
        target = 1 << (target.bit_length() - 1)
        rc = min(_ROWBLOCK_RC_CAP, target, 1 << max(0, int(np.ceil(np.log2(max(r, 1))))))
        r_pad = -(-r // rc) * rc
        if flat_offset + w * r_pad >= 1 << 31:
            raise WedgeCapacityError("the padded slab entries exceed int32 flat positions")
        starts = np.zeros(r_pad, dtype=np.int32)
        degs = np.zeros(r_pad, dtype=np.int32)
        starts[:r] = indptr_o[sel]
        degs[:r] = d_plus[sel]
        slab_t, mslab_t, heads, tpos = _fill_slab_kernel(
            ey32, mult_d, int32_tensor(starts, device), int32_tensor(degs, device), w, flat_offset
        )
        heads_parts.append(heads)
        tpos_parts.append(tpos)
        m_real += int(d_plus[sel].sum())
        flat_offset += w * r_pad
        buckets.append(WedgeBucket(sel, slab_t, mslab_t, r, rc))

    edge_pos = head_indptr = bucket_rows = None
    if heads_parts:
        _, pos_sorted = _head_sort_kernel(torch.cat(heads_parts), torch.cat(tpos_parts))
        edge_pos = pos_sorted[:m_real].contiguous()  # already in head order
        # entries per head: every oriented edge whose tail has d+ >= 2 gives
        # exactly one slab entry to its head
        hip = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(ey[d_plus[ex] > 1], minlength=n), out=hip[1:])
        head_indptr = int32_tensor(hip, device)
        bucket_rows = torch.from_numpy(np.concatenate([b.rows for b in buckets])).to(device)

    return WedgePlan(
        tuple(buckets), n, id_bits, deg_s, rank, ehash,
        edge_pos, head_indptr, bucket_rows,
        ex, ey, mult, spilled, closing,
    )


def _patch_spilled(plan: WedgePlan, numerator_ranked: np.ndarray) -> None:
    """Exact host accounting for the rare keys the 64-slot hash rows could
    not hold: every triangle whose CLOSING edge (x, y) spilled was missed by
    its probe; its apex set is in+(x) & in+(y)."""
    sp = np.nonzero(plan.spilled)[0]
    if sp.size == 0:
        return
    ex, ey, mult = plan.ex, plan.ey, plan.mult
    keys = (ex << plan.id_bits) | ey           # ascending (lexsorted stream)
    # in+-lists: tails grouped by head
    by_head = np.argsort(ey, kind="stable")
    tails = ex[by_head]
    hip = np.zeros(plan.n + 1, dtype=np.int64)
    np.cumsum(np.bincount(ey, minlength=plan.n), out=hip[1:])

    def mult_of(u, v):  # (u, v) -> stored-direction multiplicity
        k = (np.asarray(u, np.int64) << plan.id_bits) | np.asarray(v, np.int64)
        return mult[np.searchsorted(keys, k)]

    for e in sp:
        x, y, m_xy = ex[e], ey[e], mult[e]
        us = np.intersect1d(tails[hip[x]:hip[x + 1]], tails[hip[y]:hip[y + 1]])
        if us.size == 0:
            continue
        np.add.at(numerator_ranked, us, m_xy)
        numerator_ranked[x] += int(mult_of(us, np.full(us.shape, y)).sum())
        numerator_ranked[y] += int(mult_of(us, np.full(us.shape, x)).sum())


def _pair_list_padded(w: int, pc: int, device):
    """The upper-triangle pair list padded to a multiple of ``pc`` with
    (0, 0) sentinels (i < j fails, so they mask themselves)."""
    ii, jj = np.triu_indices(w, k=1)
    p = ii.shape[0]
    q = -(-max(p, 1) // pc)
    ii_pad = np.zeros(q * pc, dtype=np.int32)
    jj_pad = np.zeros(q * pc, dtype=np.int32)
    ii_pad[:p] = ii
    jj_pad[:p] = jj
    return int32_tensor(ii_pad, device), int32_tensor(jj_pad, device)


def _wedge_bucket_rowblock(slab, mslab, ehash, id_bits, ii_pad, jj_pad, rc, pc):
    """K10's plain PyTorch version: the triangle credits of a [W, R_pad]
    bucket, (u_cred [R_pad], edge_cred [W, R_pad]) int32. Row blocks of
    ``rc`` columns, and within a block the pair list in chunks of ``pc``:
    each step probes [pc, rc] pairs and adds the per-leg credits by row into
    [W, rc] accumulators."""
    w, r_pad = slab.shape
    u_cred = torch.zeros(r_pad, dtype=torch.int32, device=slab.device)
    edge_cred = torch.zeros((w, r_pad), dtype=torch.int32, device=slab.device)
    for r0 in range(0, r_pad, rc):
        sub, msub = slab[:, r0:r0 + rc], mslab[:, r0:r0 + rc]
        acc = edge_cred[:, r0:r0 + rc]
        for p0 in range(0, ii_pad.shape[0], pc):
            ii_c, jj_c = ii_pad[p0:p0 + pc], jj_pad[p0:p0 + pc]
            x = sub.index_select(0, ii_c)                 # [pc, rc]
            y = sub.index_select(0, jj_c)
            # rows are left-packed: y valid => x valid
            valid = (ii_c < jj_c)[:, None] & (y >= 0)
            found, m_xy = probe_edge_hash_xy(ehash, x.clamp(min=0), y.clamp(min=0), id_bits)
            hit = found & valid
            u_cred[r0:r0 + rc] += torch.where(hit, m_xy, 0).sum(0, dtype=torch.int32)
            mi = msub.index_select(0, ii_c)
            mj = msub.index_select(0, jj_c)
            acc.index_add_(0, ii_c, torch.where(hit, mj, 0))
            acc.index_add_(0, jj_c, torch.where(hit, mi, 0))
    return u_cred, edge_cred


def plain_pair_chunk(w: int, rc: int) -> int:
    """Pairs per inner step of the plain version for a bucket of width
    ``w`` and row blocks of ``rc``: about _CHUNK_PROBES probes a step, a
    power of two as in the JAX package."""
    pc = max(1, min(w * (w - 1) // 2, _CHUNK_PROBES // rc))
    return 1 << (pc.bit_length() - 1)


def _check_closing(closing: ClosingCSR, device) -> None:
    """Types, shapes and device of a closing CSR, and positions that fit the
    kernel's int32 indices (with room for a warp's pieces past the end)."""
    indptr, ids, mult = closing
    if (indptr.dtype != torch.int32 or ids.dtype != torch.int32 or mult.dtype != torch.uint8
            or indptr.dim() != 1 or ids.dim() != 1 or mult.dim() != 1
            or not all(t.is_contiguous() for t in closing)):
        raise TypeError("wedge_rowblock: the closing CSR must be contiguous 1-D int32 indptr "
                        "and ids and uint8 mult")
    if indptr.shape[0] < 1 or ids.shape[0] != mult.shape[0] or ids.shape[0] > (1 << 31) - 1024:
        raise ValueError(f"wedge_rowblock: closing CSR of {indptr.shape[0]} pointers, "
                         f"{ids.shape[0]} ids and {mult.shape[0]} multiplicities")
    if any(t.device != device for t in closing):
        raise ValueError("wedge_rowblock: slabs, table and closing CSR must be on one device")


def wedge_rowblock(slab, mslab, ehash: Optional[EdgeHash], id_bits: int, chunk_cols: int,
                   closing: ClosingCSR):
    """K10 wrapper: the triangle credits of one bucket. For every row r of
    ``slab`` [W, R_pad] (int32 ranked ids, distinct within a row,
    left-packed, -1 pad) and every pair i < j of its real entries, with
    x = slab[i, r] and y = slab[j, r]: if (x, y) is an edge, mult(x, y) is
    added to u_cred[r], mslab[j, r] to edge_cred[i, r] and mslab[i, r] to
    edge_cred[j, r]. Returns (u_cred [R_pad], edge_cred [W, R_pad]) int32.
    The kernel finds y in out(x) of ``closing`` (ascending, distinct ids per
    list; the indptr is not read past its end, and ids beyond it have no
    list); the plain version probes the key in ``ehash``: the two must hold
    the same edges with the same payloads. ``mslab`` holds multiplicities
    in [0, 255]: the kernel keeps them in a byte and nothing checks it, so
    a larger value gives other credits on the card than the plain version's
    (the plan's are 0, 1 or 2). ``chunk_cols`` divides
    R_pad and is the plain version's row-block width; the kernel ignores
    it, and it ignores ``ehash`` too, which may then be None."""
    if slab.dtype != torch.int32 or mslab.dtype != torch.int32 or slab.dim() != 2:
        raise TypeError("wedge_rowblock: slab and mslab must be 2-D int32")
    if slab.shape != mslab.shape or not (slab.is_contiguous() and mslab.is_contiguous()):
        raise ValueError("wedge_rowblock: slab and mslab must be contiguous, of one shape")
    if mslab.device != slab.device or (ehash is not None and ehash.table.device != slab.device):
        raise ValueError("wedge_rowblock: slabs and table must be on one device")
    if ehash is not None:
        edgehash._check_table("wedge_rowblock", ehash)
    _check_closing(closing, slab.device)
    w, r_pad = slab.shape
    if not 1 <= w <= _MAX_WEDGE_WIDTH or r_pad >= 1 << 31 or not 0 < id_bits < 32:
        raise ValueError(f"wedge_rowblock: W {w} outside [1, {_MAX_WEDGE_WIDTH}], R_pad {r_pad} "
                         f"or id_bits {id_bits} out of range")
    if not kernels.use_kernel(slab):
        if ehash is None:
            raise ValueError("wedge_rowblock: the plain version probes the edge hash: give it")
        if chunk_cols < 1 or r_pad % chunk_cols:
            raise ValueError(f"wedge_rowblock: chunk_cols {chunk_cols} must divide R_pad {r_pad}")
        pc = plain_pair_chunk(w, chunk_cols)
        return _wedge_bucket_rowblock(slab, mslab, ehash, id_bits,
                                      *_pair_list_padded(w, pc, slab.device), chunk_cols, pc)
    u_cred = torch.zeros(r_pad, dtype=torch.int32, device=slab.device)
    edge_cred = torch.zeros((w, r_pad), dtype=torch.int32, device=slab.device)
    if r_pad and w >= 2:
        kernels.launch(
            "wedge_rowblock", slab.device, slab.data_ptr(), mslab.data_ptr(), w, r_pad,
            closing.indptr.data_ptr(), closing.ids.data_ptr(), closing.mult.data_ptr(),
            closing.indptr.shape[0] - 1, u_cred.data_ptr(), edge_cred.data_ptr(),
        )
    return u_cred, edge_cred


def _aggregate_heads(edge_cred_flat, edge_pos, head_indptr):
    """The real slab entries' credits gathered in head order (kernel K1)
    and summed per head, in int64."""
    vals = table_gather(edge_cred_flat, edge_pos)
    return seg_sum_scan(vals, head_indptr, acc_dtype=torch.int64, out_dtype=torch.int64)


def numerator_from_credits(plan: WedgePlan, credits) -> np.ndarray:
    """Numerator per ORIGINAL vertex id from each bucket's (u_cred,
    edge_cred): the centres' credits by row, the legs' credits gathered in
    head order and summed per head, the spilled keys patched on the host."""
    numerator_ranked = np.zeros(plan.n, dtype=np.int64)
    if plan.buckets:
        flat = torch.cat([edge_cred.reshape(-1) for _, edge_cred in credits])
        num = _aggregate_heads(flat, plan.edge_pos, plan.head_indptr)
        # a bucket's rows are distinct, and no row is in two buckets
        num[plan.bucket_rows] += torch.cat(
            [u_cred[:b.r_real] for b, (u_cred, _) in zip(plan.buckets, credits)]).long()
        numerator_ranked = num.cpu().numpy()
    _patch_spilled(plan, numerator_ranked)
    # ranked ids back to original ids
    return numerator_ranked[plan.rank]


def lcc_oriented_numerator(plan: WedgePlan) -> np.ndarray:
    """Numerator per ORIGINAL vertex id: the sum over the triangles at v of
    the stored-direction multiplicity of the opposite edge."""
    return numerator_from_credits(plan, [
        wedge_rowblock(b.slab, b.mslab, plan.ehash, plan.id_bits, b.chunk_cols, plan.closing)
        for b in plan.buckets
    ])


def coefficients(numerator: np.ndarray, deg_s: np.ndarray) -> np.ndarray:
    """numerator / (d (d - 1)) in float64, 0.0 where d < 2."""
    num = numerator.astype(np.float64)
    d = deg_s.astype(np.float64)
    denom = d * (d - 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(denom > 0, num / denom, 0.0)


def wedge_plan(graph, cache_dir=None, *, device) -> WedgePlan:
    """The graph's wedge plan on ``device``, memoized on the Graph."""
    key = ("wedge_plan", str(torch.device(device)))
    plan = graph.memo.get(key)
    if plan is None:
        plan = graph.memo[key] = prepare_wedge_plan(graph, cache_dir=cache_dir, device=device)
    return plan


def lcc_oriented(graph, cache_dir=None, *, device) -> np.ndarray:
    """Local clustering coefficients (float64 per original vertex id). The
    wedge plan is memoized on the Graph per device, so repetitions build it
    once; with ``cache_dir`` the oriented edge list persists across runs."""
    plan = wedge_plan(graph, cache_dir, device=device)
    return coefficients(lcc_oriented_numerator(plan), plan.deg_s)
