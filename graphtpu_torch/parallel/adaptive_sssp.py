"""Distributed changed-set Bellman-Ford SSSP (counterpart of
graphtpu/parallel/adaptive_sssp.py), the JAX package's default distributed
SSSP: the one-device tier ladder (algorithms/sssp.py) with each rank
relaxing the out-edges of the changed rows it owns.

A round whose changed set fits a tier's (rows, edges) budget runs at the
smallest such tier: each rank compacts its changed rows, expands them
through its local push CSR (kernel K5) and lowers a copy of the distances
by its candidates (kernel K8); one all-reduce of the minimum merges the
ranks' copies, which is the minimum of the distances and every rank's
candidates (relaxations commute, so the order does not matter). Heavier
rounds run the full min.plus sweep, K7 over the rank's pull block, then an
all-gather. Tiers are chosen by the global changed count and edge sum, so
a round that fits fits every rank's part. One host loop with one host read
a round replaces the JAX package's nested while_loops, and every branch
reads replicated values only.
"""

from __future__ import annotations

import numpy as np
import torch

from graphtpu_torch.ops.frontier import compact, expand, mask_status, relax_min
from graphtpu_torch.parallel.adaptive_bfs import _local_csr
from graphtpu_torch.parallel.algorithms import _spmv_block
from graphtpu_torch.parallel.mesh import Mesh, all_reduce_min


def _build_prep(sg):
    """Each rank's push CSR slice with its weights ([D, r+1] indptr, [D, r+1]
    degrees, [D, M] dst, [D, M] w) and the replicated out-degrees [n_pad + 1],
    memoized on the ShardedGraph per weight dtype."""
    key = sg.wdtype.name
    cache = getattr(sg, "_sssp_adaptive_prep", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    g = sg.graph
    push = _local_csr(g.indptr.astype(np.int64), [g.dst.astype(np.int32), g.w.astype(sg.wdtype)],
                      sg.n_pad, sg.rows_per_dev, sg.num_devices)
    out_deg = np.zeros(sg.n_pad + 1, dtype=np.int32)
    out_deg[:g.n] = np.diff(g.indptr).astype(np.int32)
    prep = (push, out_deg)
    sg._sssp_adaptive_prep = (key, prep)
    return prep


def _sssp_body(mesh: Mesh, key, coo_key, source: int, n: int, r: int, tiers: tuple):
    """(distances [n], rounds, round counts [tiers..., full])."""
    dev = mesh.device
    ((pi, pdeg, pdst, pw),), gdeg_pad = mesh.state[key]
    shard = mesh.state[coo_key]
    n_pad = gdeg_pad.shape[0] - 1
    gdeg_n = gdeg_pad[:-1]
    my = mesh.rank * r
    T = len(tiers)
    FULL = T
    counts = [0] * (T + 1)

    def chosen(acnt, ae):
        for i, (k_i, e_i) in enumerate(tiers):
            if acnt <= k_i and ae <= e_i:
                return i
        return FULL

    def tier_step(i, dist, changed):
        k_cap, e_cap = tiers[i]
        ids_l, _ = compact(changed[my:my + r], k_cap)
        exp = expand(ids_l, pdeg, pi, pdst, e_cap)
        rows = torch.where(exp.valid, exp.row_ids + my, 0)
        return all_reduce_min(relax_min(dist, rows, exp.neigh, exp.gpos, exp.valid, pw))

    dist = torch.full((n_pad,), float("inf"), dtype=pw.dtype, device=dev)
    dist[source] = 0.0
    changed = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    changed[source] = True
    acnt, ae = mask_status(changed, gdeg_n).tolist()
    it = 0
    while acnt > 0 and it < n:
        phase = chosen(acnt, ae)
        counts[phase] += 1
        if phase < T:
            new = tier_step(phase, dist, changed)
        else:
            new = torch.minimum(dist, _spmv_block("min_plus", shard, dist))
        changed = new < dist
        dist, it = new, it + 1
        acnt, ae = mask_status(changed, gdeg_n).tolist()
    return dist[:n].cpu().numpy(), it, counts


def sssp_adaptive_dist(sg, source_dense: int, cfg=None, with_stats: bool = False):
    """Distributed tiered adaptive SSSP on a ShardedGraph: (float64
    distances [n], inf unreachable, rounds), and with ``with_stats`` the
    JAX package's dict of full, active and per-tier rounds. The ladder is
    ``sssp_tiers`` of the one-device path (sssp-frontier-rows/-edges,
    sssp-tiers)."""
    from graphtpu_torch.algorithms.sssp import sssp_tiers

    push, out_deg = _build_prep(sg)
    key = sg.installed_parts(f"sssp-adaptive-{sg.wdtype.name}", (push,), (out_deg,))
    coo_key = sg.pull()
    k_cap = int(getattr(cfg, "sssp_frontier_rows", 0) or 1 << 16)
    e_cap = int(getattr(cfg, "sssp_frontier_edges", 0) or 1 << 18)
    tiers = sssp_tiers(k_cap, e_cap, cfg)
    args = (key, coo_key, int(source_dense), sg.n, sg.rows_per_dev, tiers)
    d, it, c = sg.mesh.call(_sssp_body, [args] * sg.num_devices)
    out = d.astype(np.float64)
    if not with_stats:
        return out, it
    return out, it, {
        "full_steps": c[-1],
        "active_steps": it - c[-1],
        "tier_steps": {int(e): c[i] for i, (_, e) in enumerate(tiers)},
        "tiers": [(int(k), int(e)) for k, e in tiers],
    }
