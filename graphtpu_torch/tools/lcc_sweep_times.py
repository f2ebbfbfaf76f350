#!/usr/bin/env python3
"""K15 ``lcc_sweep_member`` timed on one CUDA card, bucket by bucket and
over the whole sweep, under each choice of threads per A-edge.

    python3 graphtpu_torch/tools/lcc_sweep_times.py [--root CHECKOUT] [--tag NAME] [--out FILE]
                                                    [--units 32,64,128,256]

On the bench graph (RMAT scale 20, edge factor 32, undirected, seed 42;
cached under intermediate/ of the checkout that holds this script), the
sweep's degree buckets as ``lcc_sweep_numerator`` forms them. Prints per
bucket: its pad, A-edges, neighbour searches (the sum of d(c)), and the
device ms of K15 over the bucket at each unit of ``--units`` (threads an
A-edge), each unit's numerators checked equal to the default unit's. Then
the whole sweep, one launch a bucket, under the default unit
(``algorithms/lcc.py:K15_UNIT``), under each unit for every bucket, and
split at pad 128 (a warp up to it, a 256-thread block above: the kernel's
first design). The unit is read off these times.

``--root`` names the checkout whose ``graphtpu_torch`` is timed (this one by
default); a version whose wrapper takes no unit is timed under its own
design only.
"""

from __future__ import annotations

import argparse
import inspect
import runpy
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
BENCH_GRAPH = "bench-rmat-s20-ef32"

device_ms = runpy.run_path(str(Path(__file__).with_name("trace_times.py")))["device_ms"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--out", default=None, help="also write the table to this file")
    ap.add_argument("--units", default="32,64,128,256", help="threads per A-edge to time")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("lcc_sweep_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.algorithms import lcc as lcc_mod
    from graphtpu_torch.ingest import cache as cache_mod
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
    s_indptr, s_dst, s_deg, c, o, dc = lcc_mod.prepare_lcc(g)
    max_deg = int(s_deg.max())
    iters = max(1, int(np.ceil(np.log2(max(max_deg, 2) + 1))))
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    indptr, col = dev(s_indptr), dev(s_dst)
    buckets = []  # (pad, c, o, searches) of each nonempty bucket
    for pad in lcc_mod._bucket_bounds(max_deg):
        sel = (dc > (0 if pad == 16 else pad // 8)) & (dc <= pad)
        if sel.any():
            buckets.append((pad, dev(c[sel]), dev(o[sel]), int(s_deg[c[sel]].sum())))
    takes_unit = "unit" in inspect.signature(lcc_mod._lcc_bucket_sweep).parameters
    units = [int(u) for u in args.units.split(",")] if takes_unit else [None]
    unit0 = getattr(lcc_mod, "K15_UNIT", None)
    default = (lambda pad: unit0) if unit0 else None
    num = torch.zeros(g.n, dtype=torch.int64, device=device)

    def sweep(parts, unit_of):
        for pad, cb, ob, _ in parts:
            kw = {"unit": unit_of(pad)} if takes_unit else {}
            lcc_mod._lcc_bucket_sweep(num, indptr, col, cb, ob, pad, iters, **kw)

    def numerators(parts, unit_of):
        num.zero_()
        sweep(parts, unit_of)
        return num.clone()

    lines = [f"card: {smi}; version {args.tag} ({args.root}); graph {BENCH_GRAPH}: n={g.n}, "
             f"{c.shape[0]} A-edges, max degree {max_deg}",
             "k15: pad a_edges searches " + " ".join(f"ms_unit_{u}" for u in units)
             + (" default_unit" if default else "")]
    for b in buckets:
        want = numerators([b], lambda p: default(p) if default else None)
        row = []
        for u in units:
            if takes_unit:
                assert torch.equal(numerators([b], lambda p, u=u: u), want), (b[0], u)
            row.append(device_ms(lambda u=u: sweep([b], lambda p: u), reps=3))
        lines.append(f"k15: {b[0]} {b[1].shape[0]} {b[3]} " + " ".join(f"{ms:.6f}" for ms in row)
                     + (f" {default(b[0])}" if default else ""))
        print(lines[-1], flush=True)
    rules = [("default", (lambda p: default(p)) if default else (lambda p: None))]
    if takes_unit:
        rules += [(f"all_{u}", lambda p, u=u: u) for u in units]
        rules.append(("split_at_128", lambda p: 32 if p <= 128 else 256))
    for name, rule in rules:
        ms = device_ms(lambda rule=rule: sweep(buckets, rule), reps=3)
        lines.append(f"k15: whole sweep, rule {name}: {ms:.6f} ms "
                     f"(units {[rule(b[0]) for b in buckets]})")
        print(lines[-1], flush=True)
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
