#!/usr/bin/env python3
"""Where K10 ``wedge_rowblock`` spends its time, bucket by bucket, on one
CUDA card.

    python3 graphtpu_torch/tools/wedge_bucket_times.py [--root CHECKOUT] [--tag NAME] [--out FILE]

Builds the LCC wedge plan of the benchmark graph (RMAT scale 20, edge
factor 32, undirected, seed 42; the graph and its oriented edge list cached
under intermediate/ of the checkout that holds this script) and prints, per
bucket: W, R_pad, rows, real entries, real wedges (pairs i < j of a row's
real entries), the out-list entries that closing them by a search of out(x)
reads (for every entry with a later one, the entries of out(x) up to the
row's largest id), and the device ms of K10 over the bucket (the profiler's
device time), with the wedges searched per second and the GB of lists read
per second. Then the same over all buckets, one launch per bucket, as the
LCC path launches them.

``--root`` names the checkout whose ``graphtpu_torch`` is timed (this one by
default), so that two versions of K10 can be timed in one call on one card:
a version whose plan has no closing CSR is called without one. ``--out``
also writes the table to a file.
"""

from __future__ import annotations

import argparse
import runpy
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
BENCH_GRAPH = "bench-rmat-s20-ef32"


# device ms per call from traces whose record counts are whole; loaded by
# path, as --root may make graphtpu_torch another checkout's
device_ms = runpy.run_path(str(Path(__file__).with_name("trace_times.py")))["device_ms"]


def closing_keys(plan, device):
    """The keys (x << id_bits | y) of the plan's oriented edges that its
    hash holds (the spilled ones left out), ascending, int64 on ``device``."""
    import torch

    keys = (plan.ex << plan.id_bits) | plan.ey
    return torch.from_numpy(keys[~plan.spilled]).to(device)


def wedge_work(slab, keys, id_bits):
    """(real entries, wedges, list entries read) of one bucket ``slab``
    [W, R] on its device. The wedges are the pairs i < j of each row's real
    entries; the list entries read are, for every entry i with a later one,
    those of out(slab[i]) up to the row's largest id, from ``keys``
    (closing_keys)."""
    import torch

    deg = (slab >= 0).sum(0, dtype=torch.int64)
    w = slab.shape[0]
    items = torch.arange(w, device=slab.device)[:, None] + 1 < deg[None, :]
    x = slab[items].long() << id_bits
    top = slab.max(0).values.long().expand(w, -1)[items]
    reads = torch.searchsorted(keys, x | top, right=True) - torch.searchsorted(keys, x)
    return int(deg.sum()), int((deg * (deg - 1) // 2).sum()), int(reads.sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--out", default=None, help="also write the table to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("wedge_bucket_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.ops.triangles import prepare_wedge_plan, wedge_rowblock
    from graphtpu_torch.utils.synth import rmat_graph

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda:0")
    inter = HERE / "intermediate"
    if cache_mod.exists(inter, BENCH_GRAPH):
        g = cache_mod.load(inter, BENCH_GRAPH)
    else:
        g = rmat_graph(20, 32, directed=False, weighted=False, seed=42)
        cache_mod.save(g, inter, BENCH_GRAPH)
        g.name = BENCH_GRAPH
    plan = prepare_wedge_plan(g, cache_dir=inter, device=device)
    closing = getattr(plan, "closing", None)  # absent in a version that probes the hash
    extra = () if closing is None else (closing,)
    keys = closing_keys(plan, device)

    def k10(b):
        return wedge_rowblock(b.slab, b.mslab, plan.ehash, plan.id_bits, b.chunk_cols, *extra)

    lines = [f"card: {smi}; version {args.tag} ({args.root}); graph {BENCH_GRAPH}: n={g.n}, "
             f"{plan.ex.shape[0]} oriented edges, {int(plan.spilled.sum())} spilled; "
             f"K10 {'searches the closing CSR' if extra else 'probes the edge hash'}",
             "k10: W R_pad rows entries wedges list_reads device_ms G_searches_per_s "
             "GB_lists_per_s"]
    tot = [0, 0, 0, 0]
    for b in plan.buckets:
        w, r_pad = b.slab.shape
        entries, wedges, reads = wedge_work(b.slab, keys, plan.id_bits)
        ms = device_ms(lambda: k10(b), reps=3)
        for k, v in enumerate((entries, wedges, reads, ms)):
            tot[k] += v
        lines.append(f"k10: {w} {r_pad} {b.r_real} {entries} {wedges} {reads} {ms:.6f} "
                     f"{wedges / ms / 1e6:.3f} {reads * 4 / ms / 1e6:.3f}")
        print(lines[-1], flush=True)
    ms = device_ms(lambda: [k10(b) for b in plan.buckets], reps=3)
    lines.append(f"k10: all - {sum(b.r_real for b in plan.buckets)} {tot[0]} {tot[1]} {tot[2]} "
                 f"{ms:.6f} {tot[1] / ms / 1e6:.3f} {tot[2] * 4 / ms / 1e6:.3f} "
                 f"(buckets one by one: {tot[3]:.6f} ms)")
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
