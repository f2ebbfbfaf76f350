#!/usr/bin/env python3
"""K11 ``masked_spgemm`` timed on one CUDA card, at the bench size and at
RMAT scales 14, 15 and 16.

    python3 graphtpu_torch/tools/spgemm_times.py [--root CHECKOUT] [--tag NAME] [--out FILE]

C<U> = U.U under plus.pair (structural: every term 1) and under plus.times
over float32 values of U made from seed 11 (float plus over unequal terms,
which K11 adds in a fixed order), U the degree-oriented structure of an
undirected RMAT graph (each edge once, from the lower (degree, id) end to
the higher), on the benchmark graph (scale 20, edge factor 32, seed 42;
cached under intermediate/ of the checkout that holds this script) and on
scales 14, 15 and 16 (edge factor 32, seed 42), where a small call's
planning shows beside its kernels. Prints per graph: mask entries, terms
(A entries the mask entries walk), search steps (the first design's
searches of B's rows), the B entries a row-wise walk reads, the device ms
of one call (the profiler's device time of every kernel and copy of the
call, planning included), of K11's launches alone, the median wall ms of
one call over 11 (host clock, synchronized), the call's sum over the mask
(under plus.pair the triangle count) and, for the row-wise design, the device ms of its warp rows and of
its block rows and column windows.

``--root`` names the checkout whose ``graphtpu_torch`` is timed (this one by
default), so that two versions of K11 are timed in one call on one card.
"""

from __future__ import annotations

import argparse
import runpy
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
BENCH_GRAPH = "bench-rmat-s20-ef32"
K11_RECORDS = ("masked_spgemm_kernel", "k11_")  # K11's kernel names, either design

device_ms = runpy.run_path(str(Path(__file__).with_name("trace_times.py")))["device_ms"]


def oriented_csr(g, device):
    """(U, S, rows, cols): the degree-oriented structure U of an undirected
    graph (each edge once, from the lower (degree, id) end to the higher) and
    the graph's stored CSR S, both structural CSRs on ``device``; rows and
    cols are U's entries as int32 tensors. Columns stay sorted within a row,
    as the stored edges are sorted by (src, dst)."""
    import torch

    from graphtpu_torch.core.spgemm import CSR
    from graphtpu_torch.ops.spmv import int32_tensor

    s, d = int32_tensor(g.src, device), int32_tensor(g.dst, device)
    deg = int32_tensor(g.out_degree, device)
    ds, dd = deg[s.long()], deg[d.long()]
    keep = (ds < dd) | ((ds == dd) & (s < d))
    rows, cols = s[keep].contiguous(), d[keep].contiguous()
    counts = torch.bincount(rows.long(), minlength=g.n)
    indptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    sym = CSR(int32_tensor(g.indptr, device), d, None)
    return CSR(indptr, cols, None), sym, rows, cols


def spgemm_work(a, b, rows):
    """(terms, search steps, row-wise reads) of C<M> = A.B at mask rows
    ``rows``, as this data needs them: the A entries that the mask entries
    walk; the steps of the first design's searches of B's rows, one per
    term (a row of d entries takes floor(log2 d) + 1 steps); and the B
    entries a row-wise walk reads, sum_{k in A.row(i)} deg_B(k) over the
    distinct mask rows i."""
    import torch

    deg_a, deg_b = a.indptr.diff().long(), b.indptr.diff().double()
    steps = torch.where(deg_b > 0, torch.floor(torch.log2(deg_b.clamp(min=1))) + 1, 0).long()
    ks = a.col.long()
    cs = torch.cat([ks.new_zeros(1), steps[ks].cumsum(0)])
    cw = torch.cat([ks.new_zeros(1), b.indptr.diff().long()[ks].cumsum(0)])
    lo, hi = a.indptr[:-1].long(), a.indptr[1:].long()
    r = rows.long()
    distinct = torch.unique(r)
    return (int(deg_a[r].sum()), int((cs[hi] - cs[lo])[r].sum()),
            int((cw[hi] - cw[lo])[distinct].sum()))


def time_call(fn, reps=3, wall_reps=11):
    """(device ms of the whole call, device ms of K11's launches, median
    wall ms of one synchronized call)."""
    import torch

    walls = []
    for _ in range(wall_reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return device_ms(fn, reps=reps), device_ms(fn, reps=reps, only=K11_RECORDS), \
        sorted(walls)[len(walls) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("spgemm_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.core import spgemm
    from graphtpu_torch.core.semiring import PLUS_PAIR, PLUS_TIMES
    from graphtpu_torch.core.spgemm import CSR, masked_spgemm_rows
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.utils.synth import rmat_graph

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda:0")
    inter = HERE / "intermediate"
    if cache_mod.exists(inter, BENCH_GRAPH):
        bench = cache_mod.load(inter, BENCH_GRAPH)
    else:
        bench = rmat_graph(20, 32, directed=False, weighted=False, seed=42)
        cache_mod.save(bench, inter, BENCH_GRAPH)
    lines = [f"card: {smi}; version {args.tag} ({args.root})",
             "k11: graph semiring mask_entries terms search_steps rowwise_reads call_device_ms "
             "k11_device_ms call_wall_ms sum warp_rows_ms block_rows_ms"]
    for name, g in [(f"rmat-s{k}-ef32", rmat_graph(k, 32, directed=False, seed=42))
                    for k in (14, 15, 16)] + [(BENCH_GRAPH, bench)]:
        u, _, rows, cols = oriented_csr(g, device)
        terms, steps, reads = spgemm_work(u, u, rows)
        gen = torch.Generator(device=device).manual_seed(11)
        uv = CSR(u.indptr, u.col, torch.rand(u.col.numel(), generator=gen, device=device) + 0.5)
        for sname, semiring, a in (("plus.pair", PLUS_PAIR, u), ("plus.times/f32", PLUS_TIMES, uv)):
            call = lambda: masked_spgemm_rows(semiring, a, a, rows, cols)  # noqa: E731
            total = float(call().double().sum())
            dev, k11, wall = time_call(call)
            parts = "- -"
            if hasattr(spgemm, "plan_masked_spgemm"):  # the row-wise design
                parts = " ".join(f"{device_ms(call, reps=3, only=(k,)):.6f}"
                                 for k in ("k11_warp_kernel", "k11_block_kernel"))
            lines.append(f"k11: {name} {sname} {rows.numel()} {terms} {steps} {reads} {dev:.6f} "
                         f"{k11:.6f} {wall:.3f} {total:.17g} {parts}")
            print(lines[-1], flush=True)
        del u, uv, rows, cols
        torch.cuda.empty_cache()
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
