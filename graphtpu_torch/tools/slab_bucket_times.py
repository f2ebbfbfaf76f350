#!/usr/bin/env python3
"""Where the slab kernels' time is, bucket by bucket, on one CUDA card.

    python3 graphtpu_torch/tools/slab_bucket_times.py [--root CHECKOUT] [--tag NAME] [--out FILE]

Builds the CDLP and PageRank slab plans of the benchmark graph (RMAT scale
20, edge factor 32, undirected, seed 42; cached under intermediate/ of the
checkout that holds this script) and prints, per bucket: W, R, the stored
slots that are not pad, the padded slots W*R, and the device ms of
K2 ``slab_minmode`` (gather mode, labels after iteration 0), of K3
``slab_spmv_sum`` (float32) and of a bare K1 ``gather_rows`` (C=1) of a 4 MB
table by the bucket's flattened slab ids: the L2 gather floor that neither
kernel can beat without another layout; ``k1_row_ms`` is the same gather
with the ids in row-major order (all w of a row, then the next row: the
order of K2's wide path). Then the same over all
buckets: one table launch where the version has them (K2, K3), else one
launch per bucket, one after another. The last two columns count the
distinct 32 B sectors of a 4-byte table that 32 neighbouring slots touch,
averaged over the bucket: ``col_sectors`` for 32 neighbouring rows at one w
(the order in which K3, K6 and K2's narrow path gather), ``row_sectors`` for
32 neighbouring w of one row (K2's wide path).

``--root`` names the checkout whose ``graphtpu_torch`` is measured (this
one by default), so that two versions of the kernels can be timed in one
call on one card: a version without bucket tables is timed through its
per-slab wrappers. ``--out`` also writes the table to a file.
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


def sectors_per_warp(ids):
    """Mean number of distinct 32 B sectors of a 4-byte table that the 32
    ids of a row of ``ids`` [G, 32] touch (-1 = pad, touches nothing)."""
    import torch

    if ids.shape[0] == 0:
        return float("nan")
    sec = torch.where(ids >= 0, ids >> 3, -1).sort(dim=1).values
    distinct = (sec[:, 1:] != sec[:, :-1]).sum(1) + (sec[:, 0] >= 0)
    return float(distinct.double().mean())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--out", default=None, help="also write the table to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("slab_bucket_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.algorithms.cdlp import build_incidence
    from graphtpu_torch.algorithms.pr import _pull_plan_cached
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.ops.gather import gather_rows
    from graphtpu_torch.ops import minmode, slab, spmv
    from graphtpu_torch.ops.minmode import _iter0_minmode, memoized_cdlp_plan, slab_minmode
    from graphtpu_torch.ops.spmv import slab_spmv_sum
    from graphtpu_torch.utils.synth import rmat_graph

    tables = hasattr(slab, "BucketTable")  # one launch for all buckets of a plan

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
    n = g.n
    centers, neigh = build_incidence(g)
    deg = np.bincount(centers, minlength=n).astype(np.int32)
    cdlp_plan = memoized_cdlp_plan(g, centers, neigh, deg, None, device)
    pr_plan = _pull_plan_cached(g, torch.float32, device)
    labels0 = torch.arange(n, dtype=torch.int32, device=device)
    lab1 = _iter0_minmode(cdlp_plan, labels0)
    x = torch.rand(n, generator=torch.Generator(device=device).manual_seed(0), device=device) / n

    lines = [f"card: {smi}; version {args.tag} ({args.root}); graph {BENCH_GRAPH}: n={n}, "
             f"{centers.shape[0]} incidence entries"]
    for what, plan in (("cdlp", cdlp_plan), ("pr", pr_plan)):
        heavy = 0 if plan.heavy_rows is None else int(plan.heavy_rows.shape[0])
        hedges = int(plan.heavy_neigh.shape[0]) if heavy else 0
        lines.append(f"{what} plan: {len(plan.slabs)} buckets, heavy rows {heavy} ({hedges} edges)")
        lines.append(f"{what}: W R real_slots padded_slots k2_gather_ms k3_f32_ms k1_gather_ms "
                     f"k1_row_ms col_sectors row_sectors")
        idx_all, tot = [], [0, 0]
        for b in plan.slabs:
            w, r = b.slab.shape
            real = int((b.slab >= 0).sum())
            idx = torch.where(b.slab >= 0, b.slab, 0).reshape(-1).contiguous()
            idx_all.append(idx)
            if tables:
                # a table of one bucket, built once: the wide path's row-major
                # copy is made at the first launch, outside the timed ones
                tab = slab.BucketTable([b.slab])
                out = torch.empty(r, dtype=torch.int32, device=device)
                k2 = device_ms(lambda: minmode._launch_minmode(tab, "gather", n, lab1, out))
                y = torch.empty(r, dtype=x.dtype, device=device)
                k3 = device_ms(lambda: spmv._launch_sum(tab, x, y))
            else:
                k2 = device_ms(lambda: slab_minmode(b.slab, "gather", n, lab1))
                k3 = device_ms(lambda: slab_spmv_sum(b.slab, x))
            k1 = device_ms(lambda: gather_rows(lab1, idx))
            idx_row = idx.reshape(w, r).t().contiguous().reshape(-1)
            k1r = device_ms(lambda: gather_rows(lab1, idx_row))
            del idx_row
            col = sectors_per_warp(b.slab[:, :r // 32 * 32].reshape(-1, 32))
            row = sectors_per_warp(b.slab.t()[:, :w // 32 * 32].reshape(-1, 32))
            tot[0] += real
            tot[1] += w * r
            lines.append(f"{what}: {w} {r} {real} {w * r} {k2:.6f} {k3:.6f} {k1:.6f} {k1r:.6f} "
                         f"{col:.2f} {row:.2f}")
        if tables:
            buf = slab.result_buffer(plan, torch.int32)
            k2 = device_ms(lambda: minmode.slab_minmode_buckets(plan, "gather", n, lab1, buf))
            fbuf = slab.result_buffer(plan, x.dtype)
            k3 = device_ms(lambda: spmv.slab_spmv_sum_buckets(plan, x, fbuf))
        else:
            k2 = device_ms(lambda: [slab_minmode(b.slab, "gather", n, lab1) for b in plan.slabs])
            k3 = device_ms(lambda: [slab_spmv_sum(b.slab, x) for b in plan.slabs])
        k1 = device_ms(lambda: [gather_rows(lab1, idx) for idx in idx_all])
        lines.append(f"{what}: all all {tot[0]} {tot[1]} {k2:.6f} {k3:.6f} {k1:.6f} - - -")
        del idx_all
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
