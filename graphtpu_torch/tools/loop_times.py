#!/usr/bin/env python3
"""One adaptive loop's whole run on one CUDA card: host reads, launches
issued from Python, device busy time and idle share, cold and warm wall
time.

    python3 graphtpu_torch/tools/loop_times.py --path {cdlp-auto,cdlp-slab,cdlp-sort,wcc-auto,
        wcc-adaptive,wcc-device,sssp-auto,sssp-device,sssp-delta,bfs-auto,bfs-device}
        [--root CHECKOUT] [--tag NAME] [--reps 5] [--out FILE]

Takes the benchmark graph (RMAT scale 20, edge factor 32, undirected, seed
42) for CDLP, WCC and BFS, the SSSP benchmark graph (RMAT scale 20, edge
factor 16, weighted, undirected, seed 42) for SSSP, both cached under
intermediate/ of the checkout that holds this script, and runs the path's
loop at its defaults, as the bench does: ``cdlp_adaptive_device_run``,
``cdlp_slab_run`` and ``cdlp_sort_run`` (10 iterations), ``wcc_adaptive_run``
(wcc-impl auto or adaptive) and wcc-impl=device's run, ``sssp_adaptive_run``,
sssp-impl=device's run and ``sssp_delta_run`` (from vertex 0, float32),
``bfs_adaptive_run`` and bfs-impl=device's ``_bfs_kernel`` (from vertex 0).
Once cold (where the loop
is a CUDA graph, the graph's build; the path's prep is built and timed
before), then ``--reps`` warm runs whose wall ms (the final read of the
step counts included) give the median, then warm runs under the profiler,
whose trace gives:

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

It prints the iterations, the step counts and a hash of the result, so that
two versions can be held to the same result. ``--root`` names another
checkout whose ``graphtpu_torch`` is timed instead (one whose loop is the
host loop is timed as it is), so that two versions run in one call on one
card: parent, change, change, parent. ``--out`` also writes the lines to a
file.
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
# path -> (graph name, scale, edge factor, weighted)
BENCH, SSSP = ("bench-rmat-s20-ef32", 20, 32, False), ("bench-rmat-s20-ef16-w", 20, 16, True)
GRAPHS = {"cdlp-auto": BENCH, "cdlp-slab": BENCH, "cdlp-sort": BENCH, "wcc-auto": BENCH,
          "wcc-adaptive": BENCH, "wcc-device": BENCH, "sssp-auto": SSSP, "sssp-device": SSSP,
          "sssp-delta": SSSP, "bfs-auto": BENCH, "bfs-device": BENCH}
ITERMAX = 10  # CDLP's iterations
RANGES = ("cdlp.", "wcc.", "sssp.", "bfs.", "loop.")  # the loops' named profiler ranges
TRACES = 3  # profiled warm runs; the one that kept the most device records is read
# the CUDA runtime and driver calls that put work on a stream
ENQUEUE = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync",
           "cudaGraphLaunch", "cuGraphLaunch", "cudaLaunchCooperativeKernel", "cuMemcpy",
           "cuMemset")


def _on_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).endswith("CUDA")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=sorted(GRAPHS), default="cdlp-auto", help="the loop timed")
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--reps", type=int, default=5, help="warm runs timed")
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("loop_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.algorithms import bfs as bfs_mod
    from graphtpu_torch.algorithms import cdlp as cdlp_mod
    from graphtpu_torch.algorithms import sssp as sssp_mod
    from graphtpu_torch.algorithms import wcc as wcc_mod
    from graphtpu_torch.algorithms.cdlp import build_incidence
    from graphtpu_torch.bench import load_or_make
    from graphtpu_torch.ops import active, kernels, minmode
    from graphtpu_torch.utils.config import PlatformConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda:0")
    name, scale, edge_factor, weighted = GRAPHS[args.path]
    g = load_or_make(str(HERE / "intermediate"), name, scale, edge_factor, weighted)
    lines = []

    def say(s):
        print(s, flush=True)
        lines.append(s)

    algo, impl = args.path.split("-")
    mod = {"cdlp-slab": minmode, "cdlp-sort": cdlp_mod}.get(args.path) or \
        {"cdlp": active, "wcc": wcc_mod, "sssp": sssp_mod, "bfs": bfs_mod}[algo]
    # whether this checkout runs the path as one CUDA graph (an older one may
    # run it as a host loop)
    graph_loop = {"cdlp-slab": hasattr(minmode, "_launch_slab"),
                  "cdlp-sort": hasattr(cdlp_mod, "_launch_sort"),
                  "wcc-device": hasattr(wcc_mod, "wcc_device_run"),
                  "sssp-device": hasattr(sssp_mod, "sssp_device_run"),
                  "sssp-delta": hasattr(sssp_mod, "_DeltaGraph")}.get(
                      args.path, hasattr(mod, "_LoopGraph"))
    say(f"card: {smi}; torch {torch.__version__}; version {args.tag} ({args.root}; loop "
        f"{'one CUDA graph' if graph_loop else 'a host loop'}); path {args.path}; graph {name} "
        f"(n={g.n}, {g.nnz} stored edges)" + (f", itermax {ITERMAX}" if algo == "cdlp" else ""))

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
    cfg = PlatformConfig(device="cuda:0", wcc_impl=impl if algo == "wcc" else "auto")
    f32 = torch.float32
    if algo == "cdlp":
        centers, neigh = build_incidence(g)
        deg = np.bincount(centers, minlength=g.n).astype(np.int32)
    if mod is active:
        prep = active.prepare_cdlp_adaptive(g, centers, neigh, deg, cfg)

        def run():
            return active.cdlp_adaptive_device_run(g, centers, neigh, deg, ITERMAX, cfg, prep,
                                                   with_stats=True)
    elif args.path == "cdlp-slab":
        minmode.memoized_cdlp_plan(g, centers, neigh, deg, None, torch.device(cfg.device))

        def run():
            return (*minmode.cdlp_slab_run(g, centers, neigh, deg, ITERMAX, cfg), {})
    elif args.path == "cdlp-sort":
        cdlp_mod.incidence_csr(g, centers, neigh, deg, torch.device(cfg.device))

        def run():
            return (*cdlp_mod.cdlp_sort_run(g, centers, neigh, deg, ITERMAX, 0,
                                            torch.device(cfg.device)), {})
    elif args.path == "wcc-device":
        from graphtpu_torch.ops.spmv import pull_csr

        sym = g.symmetrized()
        pull = pull_csr(sym, cfg.device)

        def run():
            if graph_loop:
                return (*wcc_mod.wcc_device_run(g, cfg), {})
            return (*wcc_mod._wcc_kernel(pull, sym.n), {})
    elif args.path == "sssp-device":
        sprep = sssp_mod.sssp_prep(g, f32, cfg.device)

        def run():
            if graph_loop:
                return (*sssp_mod.sssp_device_run(g, 0, cfg, f32), {})
            return (*sssp_mod._sssp_kernel(sprep, 0, g.n, f32), {})
    elif args.path == "sssp-delta":
        sssp_mod.sssp_prep(g, f32, cfg.device)
        sssp_mod.sssp_delta_prep(g, 2.5, f32, cfg.device)

        def run():
            return sssp_mod.sssp_delta_run(g, 0, cfg, f32, with_stats=True)
    elif mod is wcc_mod:
        sym = g.symmetrized()
        wcc_mod.wcc_prep(sym, cfg.device)
        if cfg.wcc_impl == "auto":
            wcc_mod.wcc_slab_plan(sym, cfg.device)

        def run():
            return wcc_mod.wcc_adaptive_run(g, cfg, with_stats=True)
    elif mod is sssp_mod:
        sssp_mod.sssp_prep(g, torch.float32, cfg.device)

        def run():
            return sssp_mod.sssp_adaptive_run(g, 0, cfg, torch.float32, with_stats=True)
    elif args.path == "bfs-auto":
        bfs_mod.bfs_adaptive_prep(g, bfs_mod.BFS_TRUNC, cfg.device)

        def run():
            return bfs_mod.bfs_adaptive_run(g, 0, cfg, with_stats=True)
    else:
        from graphtpu_torch.ops.spmv import pull_csr

        pull = pull_csr(g, cfg.device)

        def run():  # a checkout whose dense loop is the host loop takes the pull CSR
            if graph_loop:
                return (*bfs_mod._bfs_kernel(g, 0, cfg.device), {})
            return (*bfs_mod._bfs_kernel(pull, 0, g.n), {})
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    result, it, stats = run()
    cold_s = time.perf_counter() - t0
    digest = hashlib.sha256(result.cpu().numpy().tobytes()).hexdigest()[:16]
    steps = {k: stats[k] for k in ("full_steps", "active_steps", "tier_steps", "bu_steps",
                                   "dense_steps", "buckets", "light_active", "light_dense",
                                   "heavy_active", "heavy_dense") if k in stats}
    say(f"prep {prep_s:.3f} s; cold run (the graph's build where there is one) {cold_s:.3f} s; "
        f"{it} iterations, {steps}; result sha256 {digest}")
    walls = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        walls.append(time.perf_counter() - t0)
        assert torch.equal(out[0], result) and out[1] == it
    med = sorted(walls)[len(walls) // 2]
    say(f"warm runs: {', '.join(f'{w * 1e3:.3f}' for w in walls)} ms; median {med * 1e3:.3f} ms")

    # the trace that kept the most device records of TRACES (the profiler now
    # and then drops some of a CUDA graph's); the device spans of the loops'
    # named ranges (RANGES) cover their kernels and are left out
    best = None
    for _ in range(TRACES):
        kernels.reset_launch_counts()
        prof, wall, entries, glaunch = traced(run)
        events = [e for e in prof.key_averages() if _on_device(e)
                  and e.self_device_time_total > 0 and not e.key.startswith(RANGES)]
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
    if hasattr(mod, "last_run"):
        say(f"last_run: {mod.last_run}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total):
        say(f"  {e.key[:72]:72s} x{e.count:5d} {e.self_device_time_total / 1e3:9.3f} ms")
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    # the numbers as one JSON line, last (chip_smoke.py reads it)
    print(json.dumps({
        "path": args.path, "iterations": it, **steps, "result_sha256": digest,
        "prep_s": prep_s, "cold_s": cold_s,
        "walls_ms": [w * 1e3 for w in walls], "median_ms": med * 1e3,
        "profiled_wall_ms": wall * 1e3, "busy_ms": busy, "idle_share": 1 - busy / (wall * 1e3),
        "host_reads": dtoh, "python_launches": issued, "graph_launches": glaunch,
        "records": {e.key: [e.count, e.self_device_time_total / 1e3] for e in events},
        "replayed": replayed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
