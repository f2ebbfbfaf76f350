#!/usr/bin/env python3
"""CDLP auto's whole run on one CUDA card: host reads, launches issued from
Python, device busy time and idle share, cold and warm wall time.

    python3 graphtpu_torch/tools/cdlp_loop_times.py [--root CHECKOUT] [--tag NAME]
        [--reps 5] [--out FILE]

Takes the benchmark graph (RMAT scale 20, edge factor 32, undirected, seed
42; cached under intermediate/ of the checkout that holds this script) and
runs ``cdlp_adaptive_device_run`` at its defaults (cdlp-impl auto, 10
iterations), as the bench does: once cold (the prep and, where the loop is
a CUDA graph, the graph's build), then ``--reps`` warm runs whose wall ms
(the final read of the result included) give the median, then one warm run
under the profiler, whose trace gives:

* host reads: the device-to-host copies of the run;
* Python-issued launches: the CUDA runtime's enqueueing calls the trace
  records on the host (kernel launches, async copies and memsets, graph
  launches) plus, where the trace does not see the port's kernel library
  (a kernel that returns at once shows whether it does), the library's
  launch entries called from Python (``kernels._call``) and graph launches;
* device busy ms (the device records' time) and the idle share, 1 - busy /
  wall of that run (of TRACES such runs, the one whose trace kept the most
  records: the profiler now and then drops some of a CUDA graph's);
* the device records by kernel, their count and time.

It traces once before the run that builds the graph: a graph instantiated
before the profiler's first use in a process is traced with records
missing. Its last line is one JSON object of these numbers.

It prints the iterations, full and active steps and a hash of the labels,
so that two versions can be held to the same result. ``--root`` names
another checkout whose ``graphtpu_torch`` is timed instead (one whose loop
is the host loop is timed as it is), so that two versions run in one call on
one card: parent, change, change, parent. ``--out`` also writes the lines to
a file.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
BENCH_GRAPH = "bench-rmat-s20-ef32"
ITERMAX = 10
TRACES = 3  # profiled warm runs; the one that kept the most device records is read
# the CUDA runtime and driver calls that put work on a stream
ENQUEUE = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync",
           "cudaGraphLaunch", "cuGraphLaunch", "cudaLaunchCooperativeKernel", "cuMemcpy",
           "cuMemset")


def _on_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).endswith("CUDA")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--reps", type=int, default=5, help="warm runs timed")
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("cdlp_loop_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.algorithms.cdlp import build_incidence
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.ops import active, kernels
    from graphtpu_torch.utils.config import PlatformConfig
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
    lines = []

    def say(s):
        print(s, flush=True)
        lines.append(s)

    graph_loop = hasattr(active, "_LoopGraph")
    say(f"card: {smi}; torch {torch.__version__}; version {args.tag} ({args.root}; loop "
        f"{'one CUDA graph' if graph_loop else 'a host loop'}); graph {BENCH_GRAPH} (n={g.n}, "
        f"{g.nnz} stored edges), itermax {ITERMAX}")

    # the library's entries called from Python, and graph launches, counted
    calls = {"entries": 0, "graph_launches": 0}
    call = kernels._call

    def counted_call(name, *a, **kw):
        calls["entries"] += 1
        return call(name, *a, **kw)

    kernels._call = counted_call
    if hasattr(kernels, "graph_call"):
        gcall = kernels.graph_call

        def counted_graph_call(name, *a):
            calls["graph_launches"] += name == "graph_launch"
            return gcall(name, *a)

        kernels.graph_call = counted_graph_call

    def traced(fn):
        """(profile, wall s, library entries, graph launches) of one call."""
        torch.cuda.synchronize()
        calls["entries"] = calls["graph_launches"] = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return prof, wall, calls["entries"], calls["graph_launches"]

    def enqueues(prof):
        return sum(e.count for e in prof.key_averages()
                   if not _on_device(e) and e.key.startswith(ENQUEUE))

    # does the trace see the library's own runtime? (it links nvcc's cudart)
    kernels.launch_empty(device)
    prof, _, _, _ = traced(lambda: kernels.launch_empty(device))
    sees_library = enqueues(prof) >= 1
    say(f"the profiler {'sees' if sees_library else 'does not see'} the kernel library's "
        f"launches on the host ({enqueues(prof)} enqueueing calls for one empty kernel)")

    t0 = time.perf_counter()
    centers, neigh = build_incidence(g)
    deg = np.bincount(centers, minlength=g.n).astype(np.int32)
    cfg = PlatformConfig(device="cuda:0")
    prep = active.prepare_cdlp_adaptive(g, centers, neigh, deg, cfg)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0

    def run():
        return active.cdlp_adaptive_device_run(g, centers, neigh, deg, ITERMAX, cfg, prep,
                                               with_stats=True)

    t0 = time.perf_counter()
    labels, it, stats = run()
    cold_s = time.perf_counter() - t0
    digest = hashlib.sha256(labels.cpu().numpy().tobytes()).hexdigest()[:16]
    say(f"prep {prep_s:.3f} s; cold run (the graph's build where there is one) {cold_s:.3f} s; "
        f"{it} iterations, full steps {stats['full_steps']}, active steps "
        f"{stats['active_steps']}; labels sha256 {digest}")
    walls = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        walls.append(time.perf_counter() - t0)
        assert torch.equal(out[0], labels) and out[1] == it
    med = sorted(walls)[len(walls) // 2]
    say(f"warm runs: {', '.join(f'{w * 1e3:.3f}' for w in walls)} ms; median {med * 1e3:.3f} ms")

    # the trace that kept the most device records of TRACES (the profiler now
    # and then drops some of a CUDA graph's); the device spans of the loop's
    # named ranges (cdlp.*) cover their kernels and are left out
    best = None
    for _ in range(TRACES):
        kernels.reset_launch_counts()
        prof, wall, entries, glaunch = traced(run)
        events = [e for e in prof.key_averages() if _on_device(e)
                  and e.self_device_time_total > 0 and not e.key.startswith("cdlp.")]
        kept = sum(e.count for e in events)
        if best is None or kept > best[0]:
            replayed = {k: v for k, v in getattr(kernels, "replayed_counts", {}).items() if v}
            best = (kept, prof, wall, entries, glaunch, events, replayed)
    _, prof, wall, entries, glaunch, events, replayed = best
    busy = sum(e.self_device_time_total for e in events) / 1e3
    dtoh = sum(e.count for e in events if "DtoH" in e.key or "Device -> Pageable" in e.key
               or "Device -> Pinned" in e.key)
    runtime = enqueues(prof)
    issued = runtime + (0 if sees_library else entries + glaunch)
    records = sum(e.count for e in events)
    say(f"profiled warm run: wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / (wall * 1e3):.3f}; host reads (device-to-host copies) {dtoh}; "
        f"Python-issued launches {issued} ({runtime} enqueueing runtime calls traced, "
        f"{entries} kernel-library entries, {glaunch} graph launches); {records} device "
        f"records")
    if hasattr(active, "last_run"):
        say(f"last_run: {active.last_run}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total):
        say(f"  {e.key[:72]:72s} x{e.count:5d} {e.self_device_time_total / 1e3:9.3f} ms")
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    # the numbers as one JSON line, last (chip_smoke.py reads it)
    print(json.dumps({
        "iterations": it, "full_steps": stats["full_steps"],
        "active_steps": stats["active_steps"], "labels_sha256": digest, "cold_s": cold_s,
        "walls_ms": [w * 1e3 for w in walls], "median_ms": med * 1e3,
        "profiled_wall_ms": wall * 1e3, "busy_ms": busy, "idle_share": 1 - busy / (wall * 1e3),
        "host_reads": dtoh, "python_launches": issued, "graph_launches": glaunch,
        "records": {e.key: [e.count, e.self_device_time_total / 1e3] for e in events},
        "replayed": replayed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
