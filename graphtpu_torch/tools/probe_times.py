#!/usr/bin/env python3
"""K9 ``edgehash_probe`` timed on one CUDA card, on the edge hash of the
bench graph's wedge plan and of RMAT scale 14.

    python3 graphtpu_torch/tools/probe_times.py [--root CHECKOUT] [--tag NAME] [--out FILE]

The probes are those of ``chip_smoke.py``'s K9 check: half oriented edges
of the plan (present), half random pairs (all but a few absent), shuffled,
from a seeded generator. On the bench graph (RMAT scale 20, edge factor 32,
undirected, seed 42; cached under intermediate/ of the checkout that holds
this script) at 2^20, 2^21 and 2^22 probes, on RMAT scale 14 (edge factor
32) at 2^16. Prints per shape: probes, distinct rows, found, the device ms
of one call (every kernel of the call, the bin passes and their torch scan
included), of K9's launches alone, and, where the version bins: of the
single-pass probe over the caller's order, of the binned passes at the
partition the call would take (and of each of their four launches), and
of the binned passes at the partition that the L2 size sets (the largest
power of two of 512 B rows of which two fit in the L2), so that the size
rule and the partition size can be read off.

``--root`` names the checkout whose ``graphtpu_torch`` is timed (this one by
default), so that two versions of K9 are timed in one call on one card.
"""

from __future__ import annotations

import argparse
import runpy
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
BENCH_GRAPH = "bench-rmat-s20-ef32"
K9_RECORDS = ("edgehash_probe_kernel", "k9_")  # K9's kernel names, either design

device_ms = runpy.run_path(str(Path(__file__).with_name("trace_times.py")))["device_ms"]


def probe_keys(plan, n, p, device, seed=9):
    """(klo, khi, x, y, present) of p probes: half oriented edges of the
    wedge plan, half random pairs of ids below n, shuffled."""
    import numpy as np
    import torch

    from graphtpu_torch.ops.edgehash import pair_key_halves

    gen = torch.Generator(device=device).manual_seed(seed)
    m = plan.ex.shape[0]
    pick = torch.randint(0, m, (p // 2,), generator=gen, device=device)
    ex = torch.from_numpy(plan.ex.astype(np.int32)).to(device)
    ey = torch.from_numpy(plan.ey.astype(np.int32)).to(device)
    rand = torch.randint(0, n, (2, p - p // 2), generator=gen, device=device, dtype=torch.int32)
    order = torch.randperm(p, generator=gen, device=device)
    x = torch.cat([ex[pick], rand[0]])[order].contiguous()
    y = torch.cat([ey[pick], rand[1]])[order].contiguous()
    klo, khi = pair_key_halves(x, y, plan.id_bits)
    return klo, khi, x, y, order < p // 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.ops import edgehash
    from graphtpu_torch.ops.edgehash import _U32, _hash_rows, edgehash_probe
    from graphtpu_torch.ops.triangles import prepare_wedge_plan
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
        bench.name = BENCH_GRAPH
    bins = hasattr(edgehash, "_probe_kernel")  # this version bins its probes
    lines = [f"card: {smi}; version {args.tag} ({args.root}); "
             f"{'probes binned by partition' if bins else 'one pass in the callers order'}",
             "k9: graph table_rows probes distinct_rows found call_device_ms k9_device_ms "
             "single_pass_ms binned_ms count_ms scatter_ms probe_ms unbin_ms l2_binned_ms"]
    small = rmat_graph(14, 32, directed=False, seed=42)
    for name, g, sizes, cache in (("rmat-s14-ef32", small, (1 << 16,), None),
                                  (BENCH_GRAPH, bench, (1 << 20, 1 << 21, 1 << 22), inter)):
        plan = prepare_wedge_plan(g, cache, device=device)
        eh = plan.ehash
        for p in sizes:
            klo, khi, _, _, present = probe_keys(plan, g.n, p, device)
            found, _ = edgehash_probe(eh, klo, khi)
            assert bool(found[present].all()), "a present key was not found"
            distinct = int(torch.unique(_hash_rows(klo.long() & _U32, khi.long() & _U32,
                                                   eh.rows)).numel())
            call = lambda: edgehash_probe(eh, klo, khi)  # noqa: E731
            dev = device_ms(call, reps=10)
            k9 = device_ms(call, reps=10, only=K9_RECORDS)
            single = binned = parts = l2_binned = "-"
            if bins:
                probe = edgehash._probe_kernel
                pshift = edgehash.k9_partition_shift(eh.rows, p)
                l2 = torch.cuda.get_device_properties(device).L2_cache_size
                l2_shift = max((l2 // (2 * 512)).bit_length() - 1,
                               eh.rows.bit_length() - 1 - 12)
                single = f"{device_ms(lambda: probe(eh, klo, khi, None)):.6f}"
                binned = f"{device_ms(lambda: probe(eh, klo, khi, pshift)):.6f}"
                parts = " ".join(
                    f"{device_ms(lambda: probe(eh, klo, khi, pshift), only=(k,)):.6f}"
                    for k in ("k9_count", "k9_scatter", "k9_probe", "k9_unbin"))
                if edgehash.k9_parts(eh.rows, l2_shift) > 1:
                    l2_binned = f"{device_ms(lambda: probe(eh, klo, khi, l2_shift)):.6f}"
            lines.append(f"k9: {name} {eh.rows} {p} {distinct} {int(found.sum())} {dev:.6f} "
                         f"{k9:.6f} {single} {binned} {parts} {l2_binned}")
            print(lines[-1], flush=True)
        del plan, eh
        torch.cuda.empty_cache()
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
