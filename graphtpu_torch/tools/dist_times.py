#!/usr/bin/env python3
"""Where a naive distributed loop's time goes over one NCCL rank.

Run from the root of a checkout on a machine with a CUDA card:

    python3 graphtpu_torch/tools/dist_times.py [--scale 20] [--reps 5] [--sweep]

On RMAT scale ``--scale`` / edge factor 32 (undirected, seed 42, cached in
intermediate/ as the bench caches it) prints: the wall seconds of the
naive distributed PageRank (``pr-impl=segment``, 20 iterations) over a
one-rank NCCL group through ``try_run_distributed``, and of the one-device
run of the same loop (``pr-impl=scan``), ``--reps`` warm runs each, in turns;
the time of one ``all_gather_rows`` of 2^18 float32 against one clone of
it (1,000 calls each); the top host and device operations of one profiled
distributed run; and with ``--sweep``, the seconds of one LCC membership
sweep (``lcc_sweep_numerator``) on the same graph.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphtpu_torch.algorithms.common import run_algorithm
    from graphtpu_torch.algorithms.lcc import lcc_sweep_numerator
    from graphtpu_torch.bench import card, load_or_make
    from graphtpu_torch.parallel import dispatch
    from graphtpu_torch.parallel.mesh import all_gather_rows, close_mesh
    from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig

    if not torch.cuda.is_available():
        raise SystemExit("dist_times: needs a CUDA card")
    name, limit = card()
    g = load_or_make(str(ROOT / "intermediate"), f"bench-rmat-s{args.scale}-ef32", args.scale, 32,
                     weighted=False)
    params = AlgorithmParams(damping_factor=0.85, num_iterations=20)
    dist_cfg = PlatformConfig(device="cuda:0", num_devices=1, pr_impl="segment")
    one_cfg = PlatformConfig(device="cuda:0", pr_impl="scan")
    runs = {"one NCCL rank": lambda: dispatch.try_run_distributed("pr", g, params, dist_cfg),
            "one device": lambda: run_algorithm("pr", g, params, one_cfg)}
    secs = {k: [] for k in runs}
    for fn in runs.values():
        fn()  # the shard's install, the plan's build
    for _ in range(args.reps):
        for label, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs[label].append(time.perf_counter() - t0)
    print(f"PageRank, 20 iterations, RMAT s{args.scale}/ef32 ({g.nnz} stored edges; {name}, "
          f"{limit}):", flush=True)
    for label, ts in secs.items():
        print(f"  {label}: median {sorted(ts)[len(ts) // 2]:.6f} s of "
              + ", ".join(f"{t:.6f}" for t in ts), flush=True)

    x = torch.rand(1 << 18, device="cuda:0")
    for label, fn in (("all_gather_rows", lambda: all_gather_rows(x)), ("clone", x.clone)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 1000
        print(f"{label} of 2^18 float32: {ms:.6f} ms a call", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runs["one NCCL rank"]()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    print(avg.table(sort_by="cpu_time_total", row_limit=15), flush=True)
    print(avg.table(sort_by="cuda_time_total", row_limit=8), flush=True)
    dispatch.purge_sharded(g)
    close_mesh()

    if args.sweep:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        num, _ = lcc_sweep_numerator(g, torch.device("cuda:0"))
        torch.cuda.synchronize()
        print(f"LCC membership sweep, RMAT s{args.scale}/ef32: {time.perf_counter() - t0:.3f} s "
              f"(numerator sum {int(num.sum())})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
