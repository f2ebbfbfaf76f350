#!/usr/bin/env python3
"""Where K7 ``csr_pull_reduce`` and K5 ``frontier_expand`` spend their time,
on one CUDA card.

    python3 graphtpu_torch/tools/csr_row_times.py [--root CHECKOUT] [--tag NAME] [--out FILE]

Takes the pull CSR of the benchmark graph (RMAT scale 20, edge factor 32,
undirected, seed 42) in ``max_i32`` and ``min_i32`` and that of the SSSP
graph (RMAT scale 20, edge factor 16, weighted) in ``min_plus`` float32 and
float64, both cached under intermediate/ of the checkout that holds this
script, and prints device us per call (the profiler's device time) beside
the bytes bound (each input read once, each output written once, over the
card's published 3.35 TB/s):

* K7 per in-degree class (0; 1-4; 5-32; 33-256; 257-4,096; above 4,096),
  each class as a CSR of its own built from the rows of that class, then
  all rows in one call;
* K7 on the heavy rows of the WCC slab plan alone (``plan.heavy_neigh``,
  ``plan.heavy_indptr``), which is what WCC under ``auto`` launches;
* K7 on the largest row alone;
* K5 at every (rows, slots) tier a path launches: CDLP, WCC and SSSP's
  (2^16, 2^18), BFS's (2^16, 2^16), (2^18, 2^18), (2^18, 2^20) and
  (2^18, 2^22), the BFS bottom-up's (2^15, 2^18); each with a frontier of
  random rows that fills the slots, one of the largest rows that fills
  them, and a nearly empty one, with and without ``row_ids``;
* a kernel that returns at once, where the version has one: the floor
  under every launch-sized row.

``--root`` names the checkout whose ``graphtpu_torch`` is measured (this
one by default), so that two versions of the kernels can be timed in one
call on one card. ``--out`` also writes the table to a file.
"""

from __future__ import annotations

import argparse
import runpy
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
BENCH_GRAPH = "bench-rmat-s20-ef32"
SSSP_GRAPH = "bench-rmat-s20-ef16-w"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
CLASSES = ((0, 0), (1, 4), (5, 32), (33, 256), (257, 4096), (4097, None))
K5_TIERS = (
    ("cdlp/wcc/sssp", 1 << 16, 1 << 18), ("bfs tier 0", 1 << 16, 1 << 16),
    ("bfs tier 1", 1 << 18, 1 << 18), ("bfs tier 2", 1 << 18, 1 << 20),
    ("bfs tier 3", 1 << 18, 1 << 22), ("bfs bottom-up", 1 << 15, 1 << 18),
)


class Progress(list):
    """The table's lines, each printed as it is measured."""

    def append(self, line):
        print(line, flush=True)
        super().append(line)


# device ms per call from traces whose record counts are whole; loaded by
# path, as --root may make graphtpu_torch another checkout's
device_ms = runpy.run_path(str(Path(__file__).with_name("trace_times.py")))["device_ms"]


def sub_csr(indptr, src, w, rows):
    """The CSR of ``rows`` (ascending row numbers) alone: (indptr, src, w)."""
    import torch

    deg = indptr.diff()
    keep = torch.zeros(deg.shape[0], dtype=torch.bool, device=indptr.device)
    keep[rows] = True
    edge_keep = torch.repeat_interleave(keep, deg.long(), output_size=src.shape[0])
    sub_indptr = torch.cat([deg.new_zeros(1), torch.cumsum(deg[rows], 0, dtype=torch.int32)])
    return (sub_indptr.contiguous(), src[edge_keep].contiguous(),
            None if w is None else w[edge_keep].contiguous())


def k7_bytes(rows, edges, n, itemsize, with_x, with_w):
    """indptr and src, w per edge, the entries of x the edges can reach,
    the result."""
    return (4 * (rows + 1) + 4 * edges + (itemsize * edges if with_w else 0)
            + (itemsize * min(n, edges) if with_x else 0) + itemsize * rows)


def k5_frontier(deg_pad, n, k, e_cap, fill, gen):
    """(ids [k] ascending, padded with n; starts [k+1]; real rows; edges)
    of a frontier whose rows are a random sample (``random``), the rows of
    largest degree (``largest``), both cut where their edges pass e_cap, or
    eight random rows (``sparse``)."""
    import torch

    deg = deg_pad[:-1].long()
    if fill == "largest":
        order = torch.argsort(deg, descending=True, stable=True)
    else:
        order = torch.randperm(n, generator=gen, device=deg.device)
    order = order[:8] if fill == "sparse" else order[:k]
    filled = torch.cumsum(deg[order], 0) >= e_cap
    count = int(filled.long().argmax()) + 1 if bool(filled.any()) else order.shape[0]
    ids = torch.full((k,), n, dtype=torch.int32, device=deg.device)
    ids[:count] = torch.sort(order[:count]).values.to(torch.int32)
    lens = deg_pad[ids.long()]
    starts = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0, dtype=torch.int32)])
    return ids, starts, count, int(starts[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--out", default=None, help="also write the table to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("csr_row_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.algorithms.bfs import BFS_TRUNC, bfs_adaptive_prep
    from graphtpu_torch.algorithms.sssp import _initial, _sssp_dense_step, sssp_prep
    from graphtpu_torch.algorithms.wcc import wcc_slab_plan
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.ops import kernels
    from graphtpu_torch.ops.frontier import frontier_expand
    from graphtpu_torch.ops.spmv import csr_pull_reduce, pull_csr
    from graphtpu_torch.utils.synth import rmat_graph

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda:0")
    gen = torch.Generator(device=device).manual_seed(0)
    inter = HERE / "intermediate"

    def graph(name, edge_factor, weighted):
        if cache_mod.exists(inter, name):
            return cache_mod.load(inter, name)
        g = rmat_graph(20, edge_factor, directed=False, weighted=weighted, seed=42)
        cache_mod.save(g, inter, name)
        return g

    g, gw = graph(BENCH_GRAPH, 32, False), graph(SSSP_GRAPH, 16, True)
    n = g.n
    lines = Progress()
    lines.append(f"card: {smi}; version {args.tag} ({args.root}); graphs {BENCH_GRAPH} "
             f"(n={n}, {g.nnz} stored edges), {SSSP_GRAPH} (n={gw.n}, {gw.nnz} stored edges)")

    def us(ms):
        return f"{ms * 1e3:.1f}"

    def bound_us(nbytes):
        return f"{nbytes / HBM_BYTES_PER_S * 1e6:.1f}"

    # the empty kernel
    if hasattr(kernels, "launch_empty"):
        lines.append(f"empty kernel: {us(device_ms(lambda: kernels.launch_empty(device), 100))} us")
    else:
        lines.append("empty kernel: not in this version")

    # K7: the four (graph, mode, dtype) sweeps the dense steps launch
    pull = pull_csr(g, device)
    frontier = torch.zeros(n, dtype=torch.int32, device=device)
    frontier[pull.src[pull.indptr[0]:pull.indptr[1]].long()] = 1  # BFS level 1 from vertex 0
    labels = torch.arange(n, dtype=torch.int32, device=device)
    sweeps = [("max_i32", "int32", frontier, pull, None), ("min_i32", "int32", labels, pull, None)]
    for dtype in (torch.float32, torch.float64):
        sp = sssp_prep(gw, dtype, device)
        d = _initial(gw.n, 0, dtype, device)
        for _ in range(2):
            d, _ = _sssp_dense_step(d, sp.pull, sp.pull_w)
        sweeps.append(("min_plus", str(dtype).replace("torch.", ""), d, sp.pull, sp.pull_w))
    lines.append("k7: mode dtype class rows edges device_us bound_us")
    for mode, dname, x, csr, w in sweeps:
        deg = csr.indptr.diff()
        size = x.element_size()
        for lo, hi in CLASSES:
            in_class = (deg >= lo) if hi is None else (deg >= lo) & (deg <= hi)
            rows = in_class.nonzero().reshape(-1)
            name = f"{lo}+" if hi is None else (f"{lo}" if lo == hi else f"{lo}-{hi}")
            if rows.shape[0] == 0:
                lines.append(f"k7: {mode} {dname} {name} 0 0 - -")
                continue
            ip, s, ww = sub_csr(csr.indptr, csr.src, w, rows)
            nb = k7_bytes(rows.shape[0], s.shape[0], n, size, True, w is not None)
            try:
                took = us(device_ms(lambda: csr_pull_reduce(mode, x, s, ip, ww)))
            except RuntimeError as err:
                # a version may refuse a launch (min_plus without any edge)
                took = f"refused({str(err).split(': ')[-1].replace(' ', '_')})"
            lines.append(f"k7: {mode} {dname} {name} {rows.shape[0]} {s.shape[0]} {took} "
                         f"{bound_us(nb)}")
            del ip, s, ww
        ms = device_ms(lambda: csr_pull_reduce(mode, x, csr.src, csr.indptr, w))
        nb = k7_bytes(n, csr.src.shape[0], n, size, True, w is not None)
        lines.append(f"k7: {mode} {dname} all {n} {csr.src.shape[0]} {us(ms)} {bound_us(nb)}")
        big = int(deg.argmax())
        ip, s, ww = sub_csr(csr.indptr, csr.src, w, torch.tensor([big], device=device))
        ms = device_ms(lambda: csr_pull_reduce(mode, x, s, ip, ww))
        nb = k7_bytes(1, s.shape[0], n, size, True, w is not None)
        lines.append(f"k7: {mode} {dname} largest-row 1 {s.shape[0]} {us(ms)} {bound_us(nb)}")

    # K7 on the heavy rows of the WCC slab plan (labels, and the stored ids)
    plan = wcc_slab_plan(g.symmetrized(), device)
    if plan.heavy_rows is not None:
        hn, hi_ = plan.heavy_neigh, plan.heavy_indptr
        for what, x in (("labels", labels), ("stored-ids", None)):
            ms = device_ms(lambda: csr_pull_reduce("min_i32", x, hn, hi_))
            nb = k7_bytes(hi_.shape[0] - 1, hn.shape[0], n, 4, x is not None, False)
            lines.append(f"k7: min_i32 int32 wcc-heavy-rows({what}) {hi_.shape[0] - 1} "
                         f"{hn.shape[0]} {us(ms)} {bound_us(nb)}")

    # K5 at every tier shape a path launches
    prep = bfs_adaptive_prep(g, BFS_TRUNC, device)
    lines.append("k5: tier rows slots fill real_rows edges row_ids device_us bound_us")
    for tier, k, e_cap in K5_TIERS:
        for fill in ("random", "largest", "sparse"):
            ids, starts, count, edges = k5_frontier(prep.deg_pad, n, k, e_cap, fill, gen)
            for with_row_ids in (True, False):
                ms = device_ms(lambda: frontier_expand(ids, starts, prep.push_indptr,
                                                       prep.push_dst, e_cap, with_row_ids))
                # ids and starts, an indptr entry per real row, a neighbour per
                # valid slot; rows_local, gpos, neigh (and row_ids) and valid per slot
                nb = (4 * (2 * k + 1) + 4 * count + 4 * min(edges, e_cap)
                      + (17 if with_row_ids else 13) * e_cap)
                lines.append(f"k5: {tier} {k} {e_cap} {fill} {count} {edges} "
                             f"{'yes' if with_row_ids else 'no'} {us(ms)} {bound_us(nb)}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
