#!/usr/bin/env python3
"""Smoke run of graphtpu_torch on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. Device and build: needs a CUDA card (exits non-zero without one),
   prints the card's name and power limit, builds the hand-written kernels
   from the checkout's sources.
2. Goldens: PageRank and CDLP on example-directed and example-undirected
   through the platform lifecycle on cuda:0, validated against the
   golden outputs.
3. Real size: the benchmark graph (RMAT scale 20, edge factor 32,
   undirected, seed 42; cached under intermediate/). CDLP (itermax 10) and
   PageRank (20 iterations, d = 0.85) through run_algorithm, on the
   kernels and then as plain PyTorch on the card: CDLP labels and
   iteration counts must be identical, PageRank within 1e-4 relative.
4. Launch counts: every kernel must have launched during phases 2 and 3.
5. Each kernel against its plain PyTorch version at the path's shapes,
   with both device times (profiler) and stream spans (CUDA events).

Exits non-zero if any phase fails. The last lines of stdout are the
card's name and power limit, one JSON line of per-kernel results, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures" / "graphs"
INTERMEDIATE = ROOT / "intermediate"
BENCH_GRAPH = "bench-rmat-s20-ef32"
CDLP_ITERS, PR_ITERS, DAMPING = 10, 20, 0.85
PR_RTOL = 1e-4        # the validator's EPSILON (graphtpu/harness/validator.py:40)
F32_SUM_RTOL = 1e-5   # float32 sums in another order than torch's


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps=10):
    """(device ms, stream ms) per call of fn(), over reps calls after a
    warm-up. Device ms is the device time the profiler attributes to the
    calls' kernels and copies; stream ms is the CUDA-event span per call,
    which also holds the time the device waits for the host to launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    stream_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in _device_events(prof))
    check(device_us > 0, "the profiler recorded no device time")
    return device_us / 1e3 / reps, stream_ms


def _device_events(prof):
    """The profiler's device-side rows (kernels, copies, memsets); the
    rows of torch ops repeat their kernels' time and are left out."""
    return [
        e for e in prof.key_averages()
        if getattr(e.device_type, "name", str(e.device_type)).endswith("CUDA")
        and e.self_device_time_total > 0
    ]


def profile_run(fn):
    """(wall seconds, device ms, top kernels) of one profiled call of fn()."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(_device_events(prof), key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = [(e.key[:48], e.self_device_time_total / 1e3) for e in events[:6]]
    return wall, device_ms, top


def max_abs_err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_goldens(device):
    from graphtpu_torch.harness.platform import GraphTorchPlatform
    from graphtpu_torch.harness.validator import validate_result
    from graphtpu_torch.utils.config import GraphSpec, PlatformConfig

    for name in ("example-directed", "example-undirected"):
        spec = GraphSpec.from_properties(FIXTURES / f"{name}.properties")
        for algo in ("pr", "cdlp"):
            plat = GraphTorchPlatform(
                PlatformConfig(device=str(device), intermediate_dir=str(INTERMEDIATE))
            )
            plat.verify_setup()
            plat.load_graph(spec)
            plat.startup()
            plat.prepare(spec, algo)
            res = plat.run(spec, algo)
            metrics = plat.finalize()
            ok, msg = validate_result(
                res, plat.graphs[spec.name], str(FIXTURES / f"{name}-{algo.upper()}")
            )
            print(f"golden {name} {algo}: {'PASS' if ok else 'FAIL'} ({msg}), "
                  f"processing {metrics.processing_time_seconds}s", flush=True)
            check(ok, f"golden {name} {algo} failed: {msg}")


def load_bench_graph():
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.utils.synth import rmat_graph

    if cache_mod.exists(INTERMEDIATE, BENCH_GRAPH):
        return cache_mod.load(INTERMEDIATE, BENCH_GRAPH), "cache"
    g = rmat_graph(20, 32, directed=False, seed=42)
    cache_mod.save(g, INTERMEDIATE, BENCH_GRAPH)
    return g, "generated"


def timed_run(algo, g, params, cfg):
    import torch

    from graphtpu_torch.algorithms.common import run_algorithm

    run_algorithm(algo, g, params, cfg)  # warm-up: plan on the device, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_algorithm(algo, g, params, cfg)  # values come back to the host
    return res, time.perf_counter() - t0


def phase_real_size(device):
    """Returns the graph, its plans and the kernel-path results."""
    import numpy as np
    import torch

    from graphtpu_torch.algorithms.cdlp import build_incidence
    from graphtpu_torch.algorithms.common import run_algorithm
    from graphtpu_torch.algorithms.pr import _pull_plan_cached
    from graphtpu_torch.ops import kernels
    from graphtpu_torch.ops.minmode import memoized_cdlp_plan
    from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig

    t0 = time.perf_counter()
    g, source = load_bench_graph()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    centers, neigh = build_incidence(g)
    deg = np.bincount(centers, minlength=g.n).astype(np.int32)
    cdlp_plan = memoized_cdlp_plan(g, centers, neigh, deg, None, device)
    pr_plan = _pull_plan_cached(g, torch.float32, device)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    heavy = 0 if cdlp_plan.heavy_rows is None else int(cdlp_plan.heavy_rows.shape[0])
    widths = [int(b.slab.shape[0]) for b in cdlp_plan.slabs]
    print(f"graph {BENCH_GRAPH}: n={g.n} stored edges={g.nnz} ({source} in {gen_s:.3f}s)")
    print(f"host prep: graph {gen_s:.3f}s, incidence + CDLP and PR plans built and "
          f"copied to {device} in {plan_s:.3f}s; CDLP buckets {widths}, "
          f"heavy rows {heavy} ({int(cdlp_plan.heavy_neigh.shape[0]) if heavy else 0} edges)",
          flush=True)

    cfg = PlatformConfig(device=str(device), cdlp_impl="slab")
    cdlp_params = AlgorithmParams(max_iterations=CDLP_ITERS)
    pr_params = AlgorithmParams(damping_factor=DAMPING, num_iterations=PR_ITERS)
    inc_nnz = int(centers.shape[0])

    out = {}
    for label, scope in (("kernel", None), ("plain", kernels.plain_torch)):
        with scope() if scope else contextlib.nullcontext():
            cd, cd_s = timed_run("cdlp", g, cdlp_params, cfg)
            pr, pr_s = timed_run("pr", g, pr_params, cfg)
        out[label] = (cd, pr)
        print(f"{label}: cdlp {cd_s:.6f}s for {cd.iterations} iterations "
              f"({inc_nnz * max(cd.iterations, 1) / cd_s:.6e} edges/s); "
              f"pr {pr_s:.6f}s for {PR_ITERS} iterations "
              f"({g.nnz * PR_ITERS / pr_s:.6e} nnz/s)", flush=True)
        if label == "kernel":
            # the main path ends here: what follows compares, it does not count
            launches = dict(kernels.launch_counts)
            for algo, params in (("cdlp", cdlp_params), ("pr", pr_params)):
                wall, dev_ms, top = profile_run(lambda: run_algorithm(algo, g, params, cfg))
                print(f"profile {algo} (kernel path): wall {wall:.6f}s, device busy "
                      f"{dev_ms:.3f} ms, idle share {1 - dev_ms / 1e3 / wall:.3f}; top: "
                      + "; ".join(f"{k} {ms:.3f} ms" for k, ms in top), flush=True)

    (kcd, kpr), (pcd, ppr) = out["kernel"], out["plain"]
    check(kcd.values.shape == (g.n,), "cdlp output shape")
    check(bool(((kcd.values >= 0) & (kcd.values < g.n)).all()), "cdlp labels out of range")
    check(np.array_equal(kcd.values, pcd.values), "cdlp labels differ, kernel vs plain")
    check(kcd.iterations == pcd.iterations, "cdlp iteration counts differ")
    check(kpr.values.shape == (g.n,) and bool(np.isfinite(kpr.values).all()), "pr output")
    mass = float(kpr.values.astype(np.float64).sum())
    check(abs(mass - 1.0) < 1e-3, f"pr rank mass {mass} is not 1")
    rel = float(np.max(np.abs(kpr.values.astype(np.float64) - ppr.values) / np.abs(ppr.values)))
    check(rel <= PR_RTOL, f"pr kernel vs plain max relative error {rel} > {PR_RTOL}")
    print(f"real size: cdlp labels identical ({kcd.iterations} iterations, "
          f"{len(np.unique(kcd.values))} communities); pr max relative error {rel:.3e}, "
          f"rank mass {mass:.9f}", flush=True)
    return g, cdlp_plan, pr_plan, launches


def phase_kernels(g, cdlp_plan, pr_plan, device):
    """Each kernel against its plain version at the path's shapes."""
    import torch

    from graphtpu_torch.ops.gather import gather_rows, gather_rows_plain
    from graphtpu_torch.ops.minmode import (
        _iter0_minmode, slab_minmode, slab_minmode_plain,
    )
    from graphtpu_torch.ops.spmv import slab_spmv_sum, slab_spmv_sum_plain

    gen = torch.Generator(device=device).manual_seed(0)
    n = g.n
    res = {}

    # K1: C = 1 at the assembly gather (n labels by inv_perm), every dtype;
    # C = 128 at dma_row_gather's shape (2^17 rows of a [2^16, 128] table)
    err = 0.0
    idx1 = cdlp_plan.inv_perm
    idx128 = torch.randint(0, 1 << 16, (1 << 17,), generator=gen, device=device,
                           dtype=torch.int32)
    for dtype in (torch.int32, torch.float32, torch.int64, torch.float64):
        for table, idx in (
            (torch.randint(0, n, (n,), generator=gen, device=device).to(dtype), idx1),
            (torch.randint(0, 1 << 30, (1 << 16, 128), generator=gen, device=device).to(dtype),
             idx128),
        ):
            got, want = gather_rows(table, idx), gather_rows_plain(table, idx)
            check(torch.equal(got, want), f"gather_rows {dtype} {tuple(table.shape)} differs")
            err = max(err, max_abs_err(got, want))
    labels = torch.arange(n, dtype=torch.int32, device=device)
    res["gather_rows"] = dict(
        max_abs_err=err,
        times=(cuda_ms(lambda: gather_rows(labels, idx1)),
               cuda_ms(lambda: gather_rows_plain(labels, idx1))),
        shape=f"C=1 int32, table {n}, {idx1.shape[0]} indices",
    )

    # K2: every bucket of the CDLP plan in all three modes, with the labels
    # after iteration 0; then widths 1..4096 on random slabs
    lab1 = _iter0_minmode(cdlp_plan, labels)
    for b in cdlp_plan.slabs:
        for mode in ("gather", "identity", "min"):
            lab = lab1 if mode == "gather" else None
            check(torch.equal(slab_minmode(b.slab, mode, n, lab),
                              slab_minmode_plain(b.slab, mode, n, lab)),
                  f"slab_minmode {mode} W={b.slab.shape[0]} differs")
    for w in (1, 2, 3, 5, 8, 13, 16, 31, 32, 33, 64, 100, 255, 256, 257, 1000, 2048, 4096):
        slab = torch.randint(0, 4000, (w, 2048), generator=gen, device=device, dtype=torch.int32)
        deg = torch.randint(0, w + 1, (2048,), generator=gen, device=device)
        slab[torch.arange(w, device=device)[:, None] >= deg[None, :]] = -1
        lab = torch.randint(0, 50, (4000,), generator=gen, device=device, dtype=torch.int32)
        for mode in ("gather", "identity", "min"):
            lm = lab if mode == "gather" else None
            check(torch.equal(slab_minmode(slab, mode, 4000, lm),
                              slab_minmode_plain(slab, mode, 4000, lm)),
                  f"slab_minmode {mode} W={w} (random) differs")
    res["slab_minmode"] = dict(
        max_abs_err=0.0,
        times=(cuda_ms(lambda: [slab_minmode(b.slab, "gather", n, lab1)
                                for b in cdlp_plan.slabs]),
               cuda_ms(lambda: [slab_minmode_plain(b.slab, "gather", n, lab1)
                                for b in cdlp_plan.slabs])),
        shape="gather mode, all CDLP buckets (one full step's bucket work)",
    )

    # K3: every bucket of the PR plan, float32 and float64
    err = 0.0
    x = torch.rand(n, generator=gen, device=device) / n
    for b in pr_plan.slabs:
        for xd, rtol in ((x, F32_SUM_RTOL), (x.double(), 1e-12)):
            got, want = slab_spmv_sum(b.slab, xd), slab_spmv_sum_plain(b.slab, xd)
            bad = (got.double() - want.double()).abs() > rtol * want.double().abs()
            check(not bool(bad.any()), f"slab_spmv_sum {xd.dtype} W={b.slab.shape[0]} differs")
            if xd.dtype == torch.float32:
                err = max(err, max_abs_err(got, want))
    res["slab_spmv_sum"] = dict(
        max_abs_err=err,
        times=(cuda_ms(lambda: [slab_spmv_sum(b.slab, x) for b in pr_plan.slabs]),
               cuda_ms(lambda: [slab_spmv_sum_plain(b.slab, x) for b in pr_plan.slabs])),
        shape="float32, all PR buckets (one full step's bucket work)",
    )
    for name, r in res.items():
        (k_dev, k_stream), (p_dev, p_stream) = r["times"]
        r["ms"], r["plain_ms"] = k_dev, p_dev
        print(f"kernel {name} ({r['shape']}): device {k_dev:.6f} ms vs plain {p_dev:.6f} ms; "
              f"stream span {k_stream:.6f} ms vs plain {p_stream:.6f} ms; "
              f"max abs err {r['max_abs_err']:.3e}", flush=True)
    return res


SOURCES = {
    "gather_rows": ("graphtpu_torch/csrc/gather_rows.cu", "graphtpu/ops/pallas_gather.py:95"),
    "slab_minmode": ("graphtpu_torch/csrc/slab_minmode.cu", "graphtpu/ops/minmode.py:55"),
    "slab_spmv_sum": ("graphtpu_torch/csrc/slab_spmv.cu", "graphtpu/ops/spmv.py:82"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: needs a CUDA card")
    sys.path.insert(0, str(ROOT))  # the checkout's package, whatever the cwd
    from graphtpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda:0")
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    built = (f"built in {kernels.build_seconds:.3f}s" if kernels.build_seconds is not None
             else "already built")
    print(f"kernels: {lib.name} {built} ({time.perf_counter() - t0:.3f}s to load)", flush=True)

    kernels.reset_launch_counts()
    phase_goldens(device)
    g, cdlp_plan, pr_plan, launches = phase_real_size(device)
    print(f"launches on the main path: {launches}; peak device memory allocated "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB", flush=True)
    for name in kernels.KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")

    res = phase_kernels(g, cdlp_plan, pr_plan, device)
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
         "plain_ms": res[name]["plain_ms"]}
        for name in kernels.KERNELS
    ]}
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
