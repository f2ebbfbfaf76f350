#!/usr/bin/env python3
"""Smoke run of graphtpu_torch on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. Device and build: needs a CUDA card (exits non-zero without one),
   prints the card's name and power limit, builds the hand-written kernels
   from the checkout's sources.
2. Goldens, through the platform lifecycle on cuda:0, validated against the
   golden outputs: PageRank, CDLP (auto, the adaptive path, and slab), BFS,
   WCC and SSSP (default impls and device) on example-directed and
   example-undirected, BFS, WCC and SSSP on test-{bfs,wcc,sssp}-
   {directed,undirected}, LCC under auto and sweep on its four goldens, and
   SSSP under delta on its four.
2b. The benchmark harness on cuda:0: BenchmarkSuite over example-directed
   and example-undirected x six algorithms, once with each job in a child
   process (job-isolation=subprocess) and once in process; all 12 of each
   must validate, and each job's makespan prints beside its processing
   time. A job under fault-injection=hang:bfs must be recorded as a timeout
   and killed within its 30 s timeout + 10 s, and the job after it must
   validate. The CLI: `devices` must name the card, `benchmark --config`
   on a copy of config-template/benchmark.properties (PageRank under
   pr-impl=scan on example-directed) must exit 0, and `run --profile-dir`
   must write a trace that holds K7 records.
3. Real size: the benchmark graph (RMAT scale 20, edge factor 32,
   undirected, seed 42) and the SSSP benchmark graph (RMAT scale 20, edge
   factor 16, weighted, undirected, seed 42), both cached under
   intermediate/. Each path runs through run_algorithm on the kernels, then
   as plain PyTorch on the card: CDLP under auto and slab (itermax 10),
   PageRank (20 iterations, d = 0.85) under auto (the slab arm, K3) and
   scan (the segment-sum arm, K7 in mode sum), BFS from vertex 0 under auto,
   device and hybrid, WCC under auto, adaptive and device, SSSP from vertex 0
   under auto, device, delta and hybrid (the hybrids: host steps for sparse
   levels and rounds, K7 sweeps for the heavy ones). LCC runs under auto on
   the benchmark graph: the
   wedge plan's prep is timed cold and from the oriented cache, its counts
   print, and the plain path is one pass of K10's plain version over every
   bucket (phase 5), whose numerators must equal the kernel path's; on two
   RMAT scale-14 graphs (directed, undirected) oriented must equal sweep.
   Kernel and plain results must be identical (PageRank
   within 1e-4 relative, and scan within 1e-4 of auto), every impl of an
   algorithm must give the same result, and iteration and phase counts must agree between kernel and
   plain runs; the phase counts print beside the JAX package's for the same
   graphs. Results are also checked edge by edge: BFS levels, WCC labels
   and SSSP distances are fixed points of their relaxations. Each
   kernel-path run is profiled (top device ops, idle share, named ranges).
4. Launch counts: each path runs with the counts set to 0 just before it
   and read just after; every kernel of a path must have launched in it,
   and PageRank under scan must launch K7 in mode sum 20 times a run and
   nothing else.
   vreg_shuffle has no path in the system, and no LCC path launches
   edgehash_probe (K10 closes wedges by a search of the plan's closing CSR;
   only K10's plain version probes the hash), and no algorithm calls
   masked_spgemm (the GraphBLAS surface): each has its own phase, and its
   count is that phase's. Every profiler trace's count of each hand
   kernel is held against the wrappers' launch counts, and a trace that
   lost records is taken again.
5. Each kernel against its plain PyTorch version at the path's shapes and
   on small hand-made cases, with both device times (profiler) and stream
   spans (CUDA events). Beside each time stands the kernel's bound: the
   bytes the function must move at these inputs (each input read once, each
   output written once; stored slots that are pad are not counted) over the
   card's published memory rate, or its operations over the float32 peak,
   whichever is larger, and never less than the measured time of a kernel
   that returns at once (bound_by "launch"); and, where one PyTorch call computes the same
   function (index_select, a CSR product, gather), that call's time. The
   library calls are yardsticks: the port never calls them. K7 is held and
   timed on the full pull CSRs (max_i32, min_plus float32) and on the WCC
   slab plan's heavy rows, and in mode sum (its own row in the JSON line) on
   the benchmark graph's pull CSR in float32 and float64 (within 1e-5 and
   1e-12 relative of the plain version's float64 row sums; a hub of 10^6
   edges over many blocks, runs of empty rows and an edgeless CSR by hand),
   against one CSR product (cuSPARSE); K5 at the CDLP tier and at BFS's top tier with a
   frontier that fills it; both run twice on the same inputs and must give
   the same bits. K9 runs at 2^22 probes drawn from the benchmark graph's
   wedge plan (half present pairs, half random ones), binned by partitions
   of the table sized from the card's L2 (three launches a call: histogram,
   scatter, probe; the single pass over the caller's order is timed and
   held beside it), K10 per bucket and
   over all buckets of that plan, both twice for the same bits (K10's
   bound counts merge steps: the wedges plus the out-list entries its
   search reads). A kernel
   that returns at once gives the floor under the launch-sized rows.
5b. K11 masked_spgemm: against its plain version on the card for each add
   monoid (plus.times, min.plus, max.second, lor.land) and each value type
   (float32, float64, int32, structural) on RMAT scale 14 (A its oriented
   structure U, B its stored CSR, the mask every stored edge; float plus
   sums within 1e-5 / 1e-12 relative, the rest bit for bit); then one call
   at the benchmark graph's size, C<U> = U.U under plus.pair over its
   degree-oriented structure (30.3M mask entries), whose sum must be the
   triangle count that the LCC numerators give (their sum / 6), held bit
   for bit against one pass of the plain version in chunks of the mask (the
   whole slab does not fit in device memory); its launch count is this
   call's and must be the number its plan states (one per task list: warp
   rows, block rows, column windows). K11's time is its launches alone;
   a whole call's device time and wall time (planning on the card
   included) print beside it, and the bound takes the lesser of the two
   designs' operation counts (a search per term, or a read and a lookup
   per row-wise B entry).

6. Ingest: both RMAT graphs written once as .v/.e text under intermediate/
   (each unordered pair once, weights in 17 significant digits), loaded
   back through load_graph on the native library (parser, fused relabel)
   three times each, and the benchmark graph once on the numpy arm (parse
   and relabel timed apart, the relabel with the host sort and again with
   the card's sort); every Graph must equal its RMAT graph bit for bit and
   the native call counts must show the library ran. The device sort (the
   sort a Graph takes where a card is visible) of the benchmark graph's
   60.7M stored edges in a shuffled order must equal the native counting
   sort of the same stream; its host-to-device, sort and device-to-host
   times print apart. This phase runs after the kernel timings of 5, so
   that its 3 GiB on the card and its host load come after them. The
   numbers go into the JSON line's "ingest" object.

7. The port bench: ``python -m graphtpu_torch.bench`` in a child process on
   cuda:0 at its defaults, on the graphs phase 3 cached, 3 timed runs a
   value. Its JSON line must say backend cuda and hold no error, only the
   first rung of each ladder, positive rates, every sol_pct in (0, 100],
   and the step counts (the JAX package's where JAX_STEPS has them) and
   LCC nonzeros that phase 3 measured; its headline values print beside
   the card's name and power limit.
8. The distributed loops over a one-rank NCCL group on cuda:0, each through
   try_run_distributed on the bench graphs: the naive loops (PageRank
   segment, BFS, SSSP and WCC dense, CDLP sort, LCC sweep, the last on RMAT
   s14/ef16: at the bench size it takes over a minute), then the JAX
   package's defaults (slab PageRank, slab CDLP 10 iterations, adaptive BFS
   and SSSP from vertex 0, slab-adaptive WCC, oriented LCC on phase 3's
   wedge plan). Each is bit for bit equal to run_algorithm's one-device
   twin (PageRank within 1e-4 relative), and each run's launch counts show
   the kernels its rank routes to. The defaults' step counts print beside
   the twin's and the JAX package's: SSSP's rounds, full and active rounds
   and BFS's levels must equal both, every iteration count but WCC's the
   twin's. Each run prints its warm time, its first time (the host plans'
   build and install) and the twin's. Then a 2-rank gloo mesh's start is
   timed and dryrun_multichip(2) runs over it on the CPU.

Exits non-zero if any phase fails. The last lines of stdout are the
card's name and power limit, one JSON line of per-kernel results, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures" / "graphs"
INTERMEDIATE = ROOT / "intermediate"
BENCH_GRAPH = "bench-rmat-s20-ef32"
SSSP_GRAPH = "bench-rmat-s20-ef16-w"
CDLP_ITERS, PR_ITERS, DAMPING = 10, 20, 0.85
# the JAX package's step counts on the same graphs from vertex 0, default
# configuration (BENCH_r05.json:26-54): BFS levels and its tier (by edge
# budget) / bottom-up / dense steps; WCC and SSSP iterations, full and
# active steps
JAX_STEPS = {
    "bfs": (5, {65536: 2, 262144: 1, 1048576: 0, 4194304: 0}, 2, 0),
    "wcc": (4, 3, 1),
    "sssp": (9, 5, 4),
}
RANGES = ("cdlp.", "bfs.", "wcc.", "sssp.")  # the named profiler ranges of the loops
# device kernel names (substrings of the profiler's keys) -> the wrappers whose
# every launch runs exactly one such kernel (K9 and K11 launch several a call)
TRACE_KERNELS = {
    ("gather_scalar_kernel", "gather_row_kernel"): ("gather_rows",),
    ("minmode_small_kernel", "minmode_wide_kernel"): ("slab_minmode",),
    ("slab_spmv_kernel",): ("slab_spmv_sum", "slab_spmv_min"),
    ("vreg_shuffle_kernel",): ("vreg_shuffle",),
    ("frontier_expand_kernel",): ("frontier_expand",),
    ("k7_reduce",): ("csr_pull_reduce", "csr_pull_reduce_sum"),
    ("push_relax_min_kernel",): ("push_relax_min",),
    ("k9_count_kernel", "k9_scatter_kernel", "k9_probe_kernel", "k9_unbin_kernel",
     "k9_single_kernel"): ("edgehash_probe",),
    ("wedge_rowblock_kernel",): ("wedge_rowblock",),
    ("k11_warp_kernel", "k11_block_kernel"): ("masked_spgemm",),
}
TRACE_KERNELS_OF = {name: pats for pats, names in TRACE_KERNELS.items() for name in names}
TRACE_TRIES = 5  # traces taken before a kernel count that stays wrong fails the run
PR_RTOL = 1e-4        # the validator's EPSILON (graphtpu/harness/validator.py:40)
F32_SUM_RTOL = 1e-5   # float32 sums in another order than torch's
F64_SUM_RTOL = 1e-12  # float64 sums in another order
ALGOS = ["bfs", "pr", "wcc", "cdlp", "lcc", "sssp"]
HANG_TIMEOUT_S = 30   # the hung job's timeout; it must be killed within 10 s of it
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12      # H100 SXM, published, outside the tensor cores


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps=10, empty_kernel=False, only=None):
    """(device ms, stream ms) per call of fn(), over reps calls after a
    warm-up. Device ms is the device time the profiler attributes to the
    calls' kernels and copies; stream ms is the CUDA-event span per call,
    which also holds the time the device waits for the host to launch. A
    profiler trace now and then loses device records (none at all, fewer
    hand-kernel records than the wrappers launched, or a record whose
    count is not a multiple of reps, as every call of fn launches the same
    kernels): it is taken again, and after three such traces the stream
    span stands in for the device time, with a line that says so.
    ``empty_kernel`` says that fn is the kernel that returns at once,
    which otherwise is left out; it opens and closes every trace. Its time
    is the mean of the records a trace kept, if it kept at least ``reps``
    (a lost record biases no mean of one kernel's records). ``only`` (names)
    counts the device time of the records whose name holds one of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphtpu_torch.ops import kernels

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    stream_ms = start.elapsed_time(end) / reps
    lost = []
    for _ in range(3):
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kernels.launch_empty(torch.device("cuda:0"))  # see _device_events
            for _ in range(reps):
                fn()
            kernels.launch_empty(torch.device("cuda:0"))
            torch.cuda.synchronize()
        # with empty_kernel the trace's two bracketing calls are calls like the others
        calls = reps + 2 * empty_kernel
        events = _device_events(prof, empty_kernel)
        device_us = sum(e.self_device_time_total for e in events
                        if only is None or any(n in e.key for n in only))
        kept = sum(e.count for e in events)
        if empty_kernel and device_us > 0 and kept >= reps:
            # one kernel only: the mean of the records the trace kept is its
            # time, whichever of the calls lost theirs
            return device_us / 1e3 / kept, stream_ms
        lost = trace_mismatch(prof) if device_us > 0 else ["no device time at all"]
        lost += [f"{e.key[:48]}: {e.count} records in {calls} calls" for e in events
                 if e.count % calls]
        if not lost:
            return device_us / 1e3 / calls, stream_ms
    print(f"cuda_ms: three profiler traces lost device records ({'; '.join(lost)}); the "
          f"CUDA-event span {stream_ms:.6f} ms stands in", flush=True)
    return stream_ms, stream_ms


def trace_mismatch(prof):
    """What a trace lost: for each hand kernel, the device records the
    trace holds against the launches the wrappers counted since the counts
    were last set to 0. Empty when they agree."""
    from graphtpu_torch.ops import kernels

    events = [e for e in prof.key_averages() if _on_device(e)]
    lost = []
    for patterns, names in TRACE_KERNELS.items():
        traced = sum(e.count for e in events if any(p in e.key for p in patterns))
        launched = sum(kernels.launch_counts[n] for n in names)
        if traced != launched:
            lost.append(f"{'/'.join(names)}: {traced} traced, {launched} launched")
    return lost


def _on_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).endswith("CUDA")


def _device_events(prof, empty_kernel=False):
    """The profiler's device-side rows (kernels, copies, memsets); the
    rows of torch ops repeat their kernels' time and are left out, and so
    are the device spans of the named ranges (``cdlp.*``, ``bfs.*``,
    ``wcc.*``, ``sssp.*``), which cover their kernels and the gaps between
    them. So is the kernel that returns at once: every trace starts with
    one, because a trace now and then loses its first device record, and
    that record should not be one that is measured (cuda_ms's traces also
    end with one)."""
    return [
        e for e in prof.key_averages()
        if _on_device(e) and e.self_device_time_total > 0 and not e.key.startswith(RANGES)
        and (empty_kernel or "empty_kernel" not in e.key)
    ]


def profile_run(fn):
    """(wall seconds, device ms, top kernels, named ranges) of one profiled
    call of fn(). A named range (one per step kind of the adaptive loops:
    ``cdlp.*``, ``bfs.*``, ``wcc.*``, ``sssp.*``) gives its count, its host
    wall ms (the waits for the device included) and its device span ms
    (first to last kernel, gaps included). The trace's count of each hand
    kernel must equal the wrappers' launch counts: a trace that lost records
    is taken again, and the run fails after TRACE_TRIES such traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphtpu_torch.ops import kernels

    for attempt in range(1, TRACE_TRIES + 1):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kernels.launch_empty(torch.device("cuda:0"))  # see _device_events
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        lost = trace_mismatch(prof)
        if not lost:
            break
        print(f"profile_run: trace {attempt} lost device records ({'; '.join(lost)})",
              flush=True)
        check(attempt < TRACE_TRIES, f"{TRACE_TRIES} traces in a row lost device records")
    events = sorted(_device_events(prof), key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = [(e.key[:48], e.self_device_time_total / 1e3) for e in events[:6]]
    ranges = {}
    for e in prof.key_averages():
        if e.key.startswith(RANGES):
            count, host, span = ranges.get(e.key, (0, 0.0, 0.0))
            if _on_device(e):
                span += e.device_time_total / 1e3
            else:
                count, host = e.count, host + e.cpu_time_total / 1e3
            ranges[e.key] = (count, host, span)
    return wall, device_ms, top, ranges


def card_state():
    """The card's SM clock, power draw and temperature now (nvidia-smi),
    printed beside the longest kernel timings: a card that slows under
    load shows there."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def bound_ms(nbytes, ops, launch_ms):
    """(ms, "bytes", "operations" or "launch"): the least time the card
    could take, the largest of the bytes over the memory rate, the
    operations over the float32 peak, and ``launch_ms``, the measured time
    of a kernel that returns at once (no launch takes less)."""
    return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), (ops / F32_OPS_PER_S * 1e3, "operations"),
               (launch_ms, "launch"), key=lambda t: t[0])


def plan_counts(plan):
    """(stored slots that are not pad, padded slots, bucket rows) of a plan."""
    real = sum(int((b.slab >= 0).sum()) for b in plan.slabs)
    return real, sum(b.slab.numel() for b in plan.slabs), plan.table.total


def plan_csr(plan, n, dtype):
    """The buckets of a plan as one CSR matrix of ones [bucket rows, n]:
    rows in plan order, each row's ids in slab order, pads left out."""
    import torch

    cols, counts = [], []
    for b in plan.slabs:
        valid = b.slab >= 0
        cols.append(b.slab.t()[valid.t()])
        counts.append(valid.sum(0, dtype=torch.int32))
    col, counts = torch.cat(cols), torch.cat(counts)
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0, dtype=torch.int32)])
    return torch.sparse_csr_tensor(crow, col, torch.ones(col.shape[0], dtype=dtype,
                                                         device=col.device),
                                   size=(plan.table.total, n))


def max_abs_err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_goldens(device):
    from graphtpu_torch.harness.platform import GraphTorchPlatform
    from graphtpu_torch.harness.validator import validate_result
    from graphtpu_torch.utils.config import GraphSpec, PlatformConfig

    runs = []
    for name in ("example-directed", "example-undirected"):
        runs += [(name, "pr", {}), (name, "cdlp", {"cdlp_impl": "auto"}),
                 (name, "cdlp", {"cdlp_impl": "slab"})]
        for algo in ("bfs", "wcc", "sssp"):
            runs += [(name, algo, {}), (name, algo, {f"{algo}_impl": "device"})]
    for algo in ("bfs", "wcc", "sssp"):
        runs += [(f"test-{algo}-{kind}", algo, {}) for kind in ("directed", "undirected")]
    for name in ("example-directed", "example-undirected", "test-lcc-directed",
                 "test-lcc-undirected"):
        runs += [(name, "lcc", {"lcc_impl": impl}) for impl in ("auto", "sweep")]
    for name in ("example-directed", "example-undirected", "test-sssp-directed",
                 "test-sssp-undirected"):
        runs.append((name, "sssp", {"sssp_impl": "delta"}))
    for name, algo, impl in runs:
        spec = GraphSpec.from_properties(FIXTURES / f"{name}.properties")
        plat = GraphTorchPlatform(PlatformConfig(
            device=str(device), intermediate_dir=str(INTERMEDIATE), **impl,
        ))
        plat.verify_setup()
        plat.load_graph(spec)
        plat.startup()
        plat.prepare(spec, algo)
        res = plat.run(spec, algo)
        metrics = plat.finalize()
        ok, msg = validate_result(
            res, plat.graphs[spec.name], str(FIXTURES / f"{name}-{algo.upper()}")
        )
        what = f"{name} {algo} ({', '.join(f'{k}={v}' for k, v in impl.items()) or 'default'})"
        print(f"golden {what}: {'PASS' if ok else 'FAIL'} ({msg}), "
              f"processing {metrics.processing_time_seconds}s", flush=True)
        check(ok, f"golden {what} failed: {msg}")


def _cli(*argv, cwd=None, timeout=600):
    """``python -m graphtpu_torch.cli`` in a child process, the checkout's
    package first on its path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "graphtpu_torch.cli", *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _suite(device, tmp, label, algorithms, job_isolation, timeout_seconds=300,
           graphs=("example-directed", "example-undirected"), **platform_keys):
    """(records, wall seconds) of a BenchmarkSuite on ``device``, its
    reports under ``tmp/label``."""
    from graphtpu_torch.harness.suite import BenchmarkSuite
    from graphtpu_torch.utils.config import BenchmarkConfig, PlatformConfig

    cfg = BenchmarkConfig(graphs=list(graphs), algorithms=algorithms,
                          timeout_seconds=timeout_seconds, job_isolation=job_isolation,
                          graphs_root=str(FIXTURES), output_dir=str(tmp / label / "out"),
                          report_dir=str(tmp / label / "report"))
    t0 = time.perf_counter()
    records = BenchmarkSuite(cfg, PlatformConfig(
        device=str(device), intermediate_dir=str(INTERMEDIATE), **platform_keys)).run()
    wall = time.perf_counter() - t0
    for r in records:
        print(f"suite {label} {r.graph}/{r.algorithm}: success {r.success}, validated "
              f"{r.validated}, processing {r.processing_time_seconds} s, makespan "
              f"{r.makespan_seconds} s{', ' + r.error if r.error else ''}", flush=True)
    return records, wall


def phase_harness(device):
    """The benchmark harness on the card: the suite in both job-isolation
    modes, a hung job killed at its timeout, and the CLI's devices,
    benchmark and run --profile-dir."""
    import torch

    from graphtpu_torch.utils.config import GraphSpec

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp_name:
        tmp = Path(tmp_name)
        for mode in ("subprocess", "inprocess"):
            records, wall = _suite(device, tmp, mode, ALGOS, mode)
            good = [r for r in records if r.success and r.validated is True]
            spans = sorted(r.makespan_seconds for r in records)
            summary = json.loads((tmp / mode / "report" / "summary.json").read_text())
            print(f"suite {mode}: {len(good)}/{len(records)} jobs validate in {wall:.3f} s; "
                  f"makespan per job min {spans[0]} median {spans[len(spans) // 2]} max "
                  f"{spans[-1]} s; processing per job summed "
                  f"{sum(r.processing_time_seconds for r in records):.3f} s", flush=True)
            check(len(records) == 12 and len(good) == 12, f"suite {mode}: {len(good)}/12 validate")
            check(summary["platform"] == "graphtpu_torch" and summary["succeeded"] == 12,
                  f"suite {mode}: summary {summary}")

        records, _ = _suite(device, tmp, "hang", ["bfs", "pr"], "subprocess", HANG_TIMEOUT_S,
                            graphs=["example-directed"], fault_injection="hang:bfs")
        hung, after = records
        check(not hung.success and "timeout" in hung.error, f"the hung job: {hung}")
        check(hung.makespan_seconds <= HANG_TIMEOUT_S + 10,
              f"the hung job was killed after {hung.makespan_seconds} s")
        check(after.success and after.validated is True, f"the job after the hung one: {after}")
        print(f"hung job: killed after {hung.makespan_seconds} s (timeout {HANG_TIMEOUT_S} s); "
              f"the next job on the card validates", flush=True)

        r = _cli("devices", timeout=120)
        check(r.returncode == 0, f"cli devices: {r.stderr[-2000:]}")
        info = json.loads(r.stdout.strip().splitlines()[-1])
        check(info["backend"] == "cuda" and torch.cuda.get_device_name(0) in info["devices"],
              f"cli devices: {info}")
        print(f"cli devices: {info}", flush=True)
        props = tmp / "platform.properties"
        props.write_text("platform.graphtpu.pr-impl = scan\n")
        conf = tmp / "benchmark.properties"
        conf.write_text((ROOT / "config-template" / "benchmark.properties").read_text().replace(
            "graphs.root-directory = ../tests/fixtures/graphs",
            f"graphs.root-directory = {FIXTURES}"))
        t0 = time.perf_counter()
        # one subprocess job: a job's child process takes 9-13 s to start (PERF.md §5)
        r = _cli("benchmark", "--config", str(conf), "--graphs", "example-directed",
                 "--algorithms", "pr", "--device", str(device), "--intermediate-dir",
                 str(INTERMEDIATE), "--platform-properties", str(props), cwd=tmp)
        check(r.returncode == 0, f"cli benchmark exited {r.returncode}: {r.stdout[-2000:]}")
        print(f"cli benchmark (PageRank under pr-impl=scan on example-directed, a subprocess "
              f"job): exit 0 in {time.perf_counter() - t0:.3f} s: "
              f"{r.stdout.strip().splitlines()[-1]}", flush=True)

        spec_path = FIXTURES / "example-directed.properties"
        r = _cli("run", "--graph-properties", str(spec_path), "--algorithm", "pr",
                 "--device", str(device), "--intermediate-dir", str(INTERMEDIATE),
                 "--platform-properties", str(props), "--profile-dir", str(tmp / "prof"),
                 "--validation-file", str(FIXTURES / "example-directed-PR"))
        check(r.returncode == 0 and "validation: PASS" in r.stdout,
              f"cli run --profile-dir: {r.stdout[-2000:]}")
        traces = list((tmp / "prof").glob("example-directed-pr-*.json"))
        check(len(traces) == 1, f"cli run --profile-dir wrote {len(traces)} traces")
        events = json.loads(traces[0].read_text())["traceEvents"]
        k7 = sum(1 for e in events if e.get("cat") == "kernel" and "k7_reduce" in e.get("name", ""))
        iters = GraphSpec.from_properties(spec_path).params["pr"].num_iterations
        check(k7 > 0, "the --profile-dir trace holds no K7 record")
        print(f"cli run --profile-dir: {traces[0].name}, {len(events)} events, {k7} K7 kernel "
              f"records for {iters} iterations", flush=True)


def load_graph(name, scale, edge_factor, weighted):
    """An undirected RMAT graph (seed 42) from intermediate/, generated and
    cached on the first call (the bench's cache)."""
    from graphtpu_torch.bench import load_or_make
    from graphtpu_torch.ingest import cache as cache_mod

    source = "cache" if cache_mod.exists(INTERMEDIATE, name) else "generated"
    return load_or_make(str(INTERMEDIATE), name, scale, edge_factor, weighted), source


RUNS_PER_PATH = 4  # timed_run's warm-up and its three timed runs


def timed_run(algo, g, params, cfg, reps=RUNS_PER_PATH - 1):
    """(result, seconds of each of ``reps`` warm runs) after one warm-up
    run that puts the plan on the device."""
    import torch

    from graphtpu_torch.algorithms.common import run_algorithm

    run_algorithm(algo, g, params, cfg)
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_algorithm(algo, g, params, cfg)  # values come back to the host
        secs.append(time.perf_counter() - t0)
    return res, secs


# the main paths at real size: name -> (algorithm, config, kernels it must launch)
PATHS = {
    "cdlp-auto": ("cdlp", {"cdlp_impl": "auto"},
                  ("gather_rows", "slab_minmode", "frontier_expand")),
    "cdlp-slab": ("cdlp", {"cdlp_impl": "slab"}, ("gather_rows", "slab_minmode")),
    "pr": ("pr", {}, ("gather_rows", "slab_spmv_sum")),
    "pr-scan": ("pr", {"pr_impl": "scan"}, ("csr_pull_reduce_sum",)),
    "bfs-auto": ("bfs", {"bfs_impl": "auto"}, ("gather_rows", "frontier_expand")),
    "bfs-device": ("bfs", {"bfs_impl": "device"}, ("csr_pull_reduce",)),
    "bfs-hybrid": ("bfs", {"bfs_impl": "hybrid"}, ("csr_pull_reduce",)),
    "wcc-auto": ("wcc", {"wcc_impl": "auto"}, ("slab_spmv_min", "frontier_expand")),
    "wcc-adaptive": ("wcc", {"wcc_impl": "adaptive"}, ("csr_pull_reduce", "frontier_expand")),
    "wcc-device": ("wcc", {"wcc_impl": "device"}, ("csr_pull_reduce",)),
    "sssp-auto": ("sssp", {"sssp_impl": "auto"},
                  ("csr_pull_reduce", "frontier_expand", "push_relax_min")),
    "sssp-device": ("sssp", {"sssp_impl": "device"}, ("csr_pull_reduce",)),
    "sssp-delta": ("sssp", {"sssp_impl": "delta"},
                   ("csr_pull_reduce", "frontier_expand", "push_relax_min")),
    "sssp-hybrid": ("sssp", {"sssp_impl": "hybrid"}, ("csr_pull_reduce",)),
    "lcc": ("lcc", {"lcc_impl": "auto"}, ("gather_rows", "wedge_rowblock")),
}
# the plain path of LCC is one pass of K10's plain version over every bucket,
# made once, in phase_lcc_kernels
NO_PLAIN_RUN = ("lcc",)


def _rate(algo, res, secs, g, gw, inc_nnz):
    """The path's end-to-end metric for the median of ``secs``."""
    med = sorted(secs)[len(secs) // 2]
    if algo == "cdlp":
        return f"{inc_nnz * max(res.iterations, 1) / med:.6e} edges/s"
    if algo == "pr":
        return f"{g.nnz * PR_ITERS / med:.6e} nnz/s"
    if algo == "bfs":
        return f"bfs_gteps {g.nnz / med / 1e9:.6f} ({g.nnz} stored edges)"
    return f"{algo}_s {med:.6f} ({(gw if algo == 'sssp' else g).nnz} stored edges)"


def prepare_lcc_plan(g, device):
    """The benchmark graph's wedge plan, prepared cold and then from the
    oriented cache, both timed; the second plan is left memoized on the
    graph for the lcc path. Prints the plan's counts."""
    import numpy as np
    import torch

    from graphtpu_torch.ops.triangles import prepare_wedge_plan, wedge_plan

    cache = INTERMEDIATE / g.name / "wedge-v2.npz"
    cache.unlink(missing_ok=True)
    secs = []
    for _ in ("cold", "from the oriented cache"):
        plan = None  # the first plan's tensors go before the second is built
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = prepare_wedge_plan(g, cache_dir=INTERMEDIATE, device=device)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check(cache.exists(), "the oriented cache was not written")
    g.memo["wedge_plan", str(device)] = plan
    check(wedge_plan(g, INTERMEDIATE, device=device) is plan, "the wedge plan is not memoized")
    d_plus = np.bincount(plan.ex, minlength=plan.n).astype(np.int64)
    real = int((d_plus * (d_plus - 1) // 2).sum())
    padded = sum(b.slab.shape[0] * (b.slab.shape[0] - 1) // 2 * b.slab.shape[1]
                 for b in plan.buckets)
    table = plan.ehash.table
    print(f"lcc prep: {secs[0]:.3f} s cold, {secs[1]:.3f} s from the oriented cache "
          f"({cache.stat().st_size} bytes); {plan.ex.shape[0]} oriented edges, max d+ "
          f"{int(d_plus.max())}, {real} real wedges, {padded} padded probes of the plain "
          f"version; table {plan.ehash.rows} rows, {table.numel() * 4} bytes; closing CSR "
          f"{sum(t.numel() * t.element_size() for t in plan.closing)} bytes; "
          f"{int(plan.spilled.sum())} spilled keys; buckets (W, R_pad, rows): "
          + ", ".join(f"({b.slab.shape[0]}, {b.slab.shape[1]}, {b.r_real})"
                      for b in plan.buckets), flush=True)
    return plan, real


def check_fixed_points(g, gw, out):
    """BFS levels, WCC labels and SSSP distances are fixed points of their
    relaxations over every stored edge (host numpy)."""
    import numpy as np

    from graphtpu_torch.core.types import UNREACHABLE

    s, d = g.src.astype(np.int64), g.dst.astype(np.int64)
    lev = out["kernel", "bfs-auto"].values
    reached = lev != UNREACHABLE
    check(lev[0] == 0 and int(reached.sum()) > 1, "bfs: source level or reach")
    check(bool((~reached[s] | (lev[d] <= lev[s] + 1)).all()), "bfs: an edge skips a level")
    parent = np.zeros(g.n, dtype=bool)
    parent[d[reached[s] & (lev[s] == lev[d] - 1)]] = True
    parent[0] = True
    check(bool((parent | ~reached).all()), "bfs: a reached vertex has no parent a level up")
    lab = out["kernel", "wcc-auto"].values  # original ids, which are the dense ids here
    check(bool((lab[s] == lab[d]).all()), "wcc: an edge joins two components")
    check(bool((lab[lab] == lab).all() and (lab <= np.arange(g.n)).all()),
          "wcc: a label is not its component's smallest id")
    dist = out["kernel", "sssp-auto"].values.astype(np.float32)  # computed in float32
    ws, wd = gw.src.astype(np.int64), gw.dst.astype(np.int64)
    w32 = gw.w.astype(np.float32)
    check(dist[0] == 0 and bool((dist[wd] <= dist[ws] + w32).all()),
          "sssp: an edge still relaxes a distance")
    return int(reached.sum()), len(np.unique(lab)), int(np.isfinite(dist).sum())


def phase_real_size(device):
    """Returns the graphs, the CDLP adaptive prep, the PR plan, the wedge
    plan with its count of real wedges and the LCC result, and the main
    paths' launch counts."""
    import numpy as np
    import torch

    from graphtpu_torch.algorithms.bfs import _bfs_kernel, bfs_adaptive_run
    from graphtpu_torch.algorithms.cdlp import build_incidence
    from graphtpu_torch.algorithms.common import run_algorithm
    from graphtpu_torch.algorithms.pr import _pull_plan_cached
    from graphtpu_torch.algorithms.sssp import (
        _sssp_kernel, sssp_adaptive_run, sssp_delta_run, sssp_prep,
    )
    from graphtpu_torch.algorithms.wcc import _wcc_kernel, wcc_adaptive_run
    from graphtpu_torch.ops import kernels
    from graphtpu_torch.ops.active import cdlp_adaptive_device_run, prepare_cdlp_adaptive
    from graphtpu_torch.ops.spmv import pull_csr
    from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    t0 = time.perf_counter()
    g, source = load_graph(BENCH_GRAPH, 20, 32, weighted=False)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gw, wsource = load_graph(SSSP_GRAPH, 20, 16, weighted=True)
    wgen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    centers, neigh = build_incidence(g)
    deg = np.bincount(centers, minlength=g.n).astype(np.int32)
    prep = prepare_cdlp_adaptive(g, centers, neigh, deg, PlatformConfig(device=str(device)))
    cdlp_plan = prep.plan
    pr_plan = _pull_plan_cached(g, torch.float32, device)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    heavy = 0 if cdlp_plan.heavy_rows is None else int(cdlp_plan.heavy_rows.shape[0])
    widths = [int(b.slab.shape[0]) for b in cdlp_plan.slabs]
    print(f"graph {BENCH_GRAPH}: n={g.n} stored edges={g.nnz} ({source} in {gen_s:.3f}s)")
    print(f"graph {SSSP_GRAPH}: n={gw.n} stored edges={gw.nnz} ({wsource} in {wgen_s:.3f}s)")
    print(f"host prep: graph {gen_s:.3f}s, incidence + CDLP (slab and adaptive) and PR plans "
          f"built and copied to {device} in {plan_s:.3f}s; CDLP buckets {widths}, "
          f"heavy rows {heavy} ({int(cdlp_plan.heavy_neigh.shape[0]) if heavy else 0} edges)",
          flush=True)
    wplan, real_wedges = prepare_lcc_plan(g, device)

    params = {"cdlp": AlgorithmParams(max_iterations=CDLP_ITERS),
              "pr": AlgorithmParams(damping_factor=DAMPING, num_iterations=PR_ITERS),
              "bfs": AlgorithmParams(source_vertex=0), "wcc": AlgorithmParams(),
              "sssp": AlgorithmParams(source_vertex=0), "lcc": AlgorithmParams()}
    cfgs = {name: PlatformConfig(device=str(device), intermediate_dir=str(INTERMEDIATE), **over)
            for name, (_, over, _) in PATHS.items()}
    graph_of = {algo: (gw if algo == "sssp" else g) for algo in params}
    inc_nnz = int(centers.shape[0])

    out, launches, medians = {}, {}, {}
    for label, scope in (("kernel", None), ("plain", kernels.plain_torch)):
        for name, (algo, _, _) in PATHS.items():
            if label == "plain" and name in NO_PLAIN_RUN:
                continue
            kernels.reset_launch_counts()
            with scope() if scope else contextlib.nullcontext():
                t0 = time.perf_counter()
                res, secs = timed_run(algo, graph_of[algo], params[algo], cfgs[name])
            if label == "kernel":
                launches[name] = dict(kernels.launch_counts)
            out[label, name] = res
            medians[label, name] = sorted(secs)[len(secs) // 2]
            print(f"{label} {name}: {res.iterations} iterations, runs "
                  + ", ".join(f"{t:.6f}" for t in secs) + f" s (warm-up and prep "
                  f"{time.perf_counter() - t0 - sum(secs):.3f} s); median "
                  f"{sorted(secs)[len(secs) // 2]:.6f} s = "
                  + _rate(algo, res, secs, g, gw, inc_nnz), flush=True)
        if label == "kernel":
            # what follows compares and profiles: it does not count
            for name, (algo, _, _) in PATHS.items():
                wall, dev_ms, top, ranges = profile_run(
                    lambda: run_algorithm(algo, graph_of[algo], params[algo], cfgs[name]))
                print(f"profile {name} (kernel path): wall {wall:.6f}s, device busy "
                      f"{dev_ms:.3f} ms, idle share {1 - dev_ms / 1e3 / wall:.3f}; top: "
                      + "; ".join(f"{k} {ms:.3f} ms" for k, ms in top)
                      + "".join(f"; range {k} x{c}: host {h:.3f} ms, device span {d:.3f} ms"
                                for k, (c, h, d) in ranges.items()),
                      flush=True)
    # the traversal loops alone, without what run_algorithm adds around them
    # (the source lookup, the result's copy to the host and its conversion)
    f32 = torch.float32
    loops = {
        "bfs-auto": lambda: bfs_adaptive_run(g, 0, cfgs["bfs-auto"]),
        "bfs-device": lambda: _bfs_kernel(pull_csr(g, device), 0, g.n),
        "wcc-auto": lambda: wcc_adaptive_run(g, cfgs["wcc-auto"]),
        "wcc-adaptive": lambda: wcc_adaptive_run(g, cfgs["wcc-adaptive"]),
        "wcc-device": lambda: _wcc_kernel(pull_csr(g, device), g.n),
        "sssp-auto": lambda: sssp_adaptive_run(gw, 0, cfgs["sssp-auto"], f32),
        "sssp-device": lambda: _sssp_kernel(sssp_prep(gw, f32, device), 0, gw.n, f32),
    }
    for name, loop in loops.items():
        secs = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        med = sorted(secs[1:])[1]
        print(f"loop {name} (kernel path): median {med:.6f} s of the loop alone; run_algorithm "
              f"adds {medians['kernel', name] - med:.6f} s", flush=True)
    steps = {}
    for label, scope in (("kernel", None), ("plain", kernels.plain_torch)):
        with scope() if scope else contextlib.nullcontext():
            _, it, stats = cdlp_adaptive_device_run(
                g, centers, neigh, deg, CDLP_ITERS, cfgs["cdlp-auto"], prep=prep,
                with_stats=True)
            _, bn, bst = bfs_adaptive_run(g, 0, cfgs["bfs-auto"], with_stats=True)
            wcc = {name: wcc_adaptive_run(g, cfgs[name], with_stats=True)[1:]
                   for name in ("wcc-auto", "wcc-adaptive")}
            _, sn, sst = sssp_adaptive_run(gw, 0, cfgs["sssp-auto"], torch.float32,
                                           with_stats=True)
            _, dn, dst = sssp_delta_run(gw, 0, cfgs["sssp-delta"], torch.float32,
                                        with_stats=True)
        print(f"adaptive steps ({label}): {it} iterations, full_steps {stats['full_steps']}, "
              f"active_steps {stats['active_steps']} (tier {stats['k_cap']} rows, "
              f"{stats['e_cap']} edges)", flush=True)
        steps[label] = (
            (it, stats["full_steps"]),
            (bn, bst["tier_steps"], bst["bu_steps"], bst["dense_steps"]),
            {name: (wn, wst["full_steps"], wst["active_steps"]) for name, (wn, wst) in wcc.items()},
            (sn, sst["full_steps"], sst["active_steps"]),
            (dn, dst),
        )
        _, bfs_steps, wcc_steps, sssp_steps, _ = steps[label]
        print(f"sssp-delta steps ({label}): {dn} relaxation steps at delta {dst['delta']}: "
              f"{dst['buckets']} buckets, light frontier {dst['light_active']}, light dense "
              f"{dst['light_dense']}, heavy frontier {dst['heavy_active']}, heavy dense "
              f"{dst['heavy_dense']} (capacities {dst['k_cap']} rows, {dst['e_cap']} edges)",
              flush=True)
        print(f"bfs-auto steps ({label}): {bfs_steps[0]} levels; tier steps by edge budget "
              f"{bfs_steps[1]}, bottom-up {bfs_steps[2]}, dense {bfs_steps[3]} (JAX package, "
              f"same graph: {JAX_STEPS['bfs'][0]} levels; {JAX_STEPS['bfs'][1]}, bottom-up "
              f"{JAX_STEPS['bfs'][2]}, dense {JAX_STEPS['bfs'][3]}: "
              f"{'equal' if bfs_steps == JAX_STEPS['bfs'] else 'DIFFERENT'})", flush=True)
        for name, (wn, wf, wa) in wcc_steps.items():
            print(f"{name} steps ({label}): {wn} iterations, full {wf}, active {wa} (JAX "
                  f"package auto: {JAX_STEPS['wcc']}: "
                  f"{'equal' if (wn, wf, wa) == JAX_STEPS['wcc'] else 'DIFFERENT'})", flush=True)
        print(f"sssp-auto steps ({label}): {sssp_steps[0]} rounds, full {sssp_steps[1]}, active "
              f"{sssp_steps[2]}, tiers {sst['tiers']} by tier {sst['tier_steps']} (JAX package: "
              f"{JAX_STEPS['sssp']}: "
              f"{'equal' if sssp_steps == JAX_STEPS['sssp'] else 'DIFFERENT'})",
              flush=True)
        print(f"bfs-auto tier steps ({label}), in order of (rows, edge slots) tier: "
              + ", ".join(f"({k}, {e}) x{bst['tier_steps'][e]}" for k, e in bst["tiers"]),
              flush=True)
        check(bfs_steps == JAX_STEPS["bfs"], f"bfs-auto steps ({label}) differ from JAX's")
        for name, counts in wcc_steps.items():
            check(counts == JAX_STEPS["wcc"], f"{name} steps ({label}) differ from JAX's")
        check(sssp_steps == JAX_STEPS["sssp"], f"sssp-auto steps ({label}) differ from JAX's")
    check(steps["kernel"] == steps["plain"], "phase counts differ, kernel vs plain")

    auto, slab, pcd = out["kernel", "cdlp-auto"], out["kernel", "cdlp-slab"], out["plain", "cdlp-auto"]
    kpr, ppr = out["kernel", "pr"], out["plain", "pr"]
    check(auto.values.shape == (g.n,), "cdlp output shape")
    check(bool(((auto.values >= 0) & (auto.values < g.n)).all()), "cdlp labels out of range")
    check(np.array_equal(auto.values, slab.values), "cdlp labels differ, adaptive vs slab")
    check(np.array_equal(auto.values, pcd.values), "cdlp labels differ, kernel vs plain")
    check(np.array_equal(slab.values, out["plain", "cdlp-slab"].values),
          "cdlp slab labels differ, kernel vs plain")
    check(len({auto.iterations, slab.iterations, pcd.iterations,
               out["plain", "cdlp-slab"].iterations}) == 1, "cdlp iteration counts differ")
    check(kpr.values.shape == (g.n,) and bool(np.isfinite(kpr.values).all()), "pr output")
    mass = float(kpr.values.astype(np.float64).sum())
    check(abs(mass - 1.0) < 1e-3, f"pr rank mass {mass} is not 1")
    rel = float(np.max(np.abs(kpr.values.astype(np.float64) - ppr.values) / np.abs(ppr.values)))
    check(rel <= PR_RTOL, f"pr kernel vs plain max relative error {rel} > {PR_RTOL}")
    kscan, pscan = out["kernel", "pr-scan"], out["plain", "pr-scan"]
    check(kscan.values.shape == (g.n,) and bool(np.isfinite(kscan.values).all()), "pr-scan output")
    rel_scan = float(np.max(np.abs(kscan.values.astype(np.float64) - pscan.values)
                            / np.abs(pscan.values)))
    check(rel_scan <= PR_RTOL, f"pr-scan kernel vs plain max relative error {rel_scan} > {PR_RTOL}")
    rel_arms = float(np.max(np.abs(kscan.values.astype(np.float64) - kpr.values)
                            / np.abs(kpr.values)))
    check(rel_arms <= PR_RTOL, f"pr-scan vs pr (slab) max relative error {rel_arms} > {PR_RTOL}")
    print(f"real size: cdlp labels identical, adaptive vs slab vs plain ({auto.iterations} "
          f"iterations, {len(np.unique(auto.values))} communities); pr max relative error "
          f"{rel:.3e}, rank mass {mass:.9f}; pr-scan max relative error {rel_scan:.3e} vs its "
          f"plain path, {rel_arms:.3e} vs the slab arm", flush=True)
    for algo in ("bfs", "wcc", "sssp"):
        names = [name for name, (a, _, _) in PATHS.items() if a == algo]
        first = out["kernel", names[0]].values
        check(first.shape == (graph_of[algo].n,), f"{algo} output shape")
        for name in names:
            for label in ("kernel", "plain"):
                check(np.array_equal(out[label, name].values, first),
                      f"{algo} results differ: {label} {name} vs kernel {names[0]}")
            check(out["kernel", name].iterations == out["plain", name].iterations,
                  f"{name} iteration counts differ, kernel vs plain")
    reached, components, finite = check_fixed_points(g, gw, out)
    print(f"real size: bfs levels identical, auto vs device vs hybrid, kernel vs plain "
          f"({reached} reached); wcc labels identical, auto vs adaptive vs device "
          f"({components} components); sssp distances identical, auto vs device vs delta vs "
          f"hybrid ({finite} finite); all fixed points over every edge", flush=True)

    lcc = out["kernel", "lcc"].values
    check(lcc.shape == (g.n,) and lcc.dtype == np.float64, "lcc output shape or dtype")
    check(bool(((lcc >= 0) & (lcc <= 1)).all()) and float(lcc.max()) > 0, "lcc outside [0, 1]")
    # oriented (K10) against the sweep oracle (K1 gathers) on graphs small
    # enough for the sweep, with multiplicities 1 and 2
    for directed in (True, False):
        small = rmat_graph(14, 16, directed=directed, seed=7)
        by_impl = {impl: run_algorithm("lcc", small, params["lcc"], PlatformConfig(
            device=str(device), intermediate_dir=str(INTERMEDIATE), lcc_impl=impl)).values
            for impl in ("oriented", "sweep")}
        check(np.array_equal(by_impl["oriented"], by_impl["sweep"]),
              f"lcc oriented differs from sweep (RMAT s14/ef16, directed={directed})")
        print(f"lcc oriented = sweep on RMAT s14/ef16 {'directed' if directed else 'undirected'} "
              f"({small.nnz} stored edges; mean coefficient {by_impl['sweep'].mean():.6f})",
              flush=True)
    return g, gw, prep, pr_plan, (wplan, real_wedges, lcc), launches, steps["kernel"]


def write_text_graph(g, name):
    """The undirected graph ``g`` as Graphalytics text under
    intermediate/<name>/: <name>.v, one vertex id a line, and <name>.e, each
    unordered pair once (weights in 17 significant digits, which read back
    to the same float64). Written once, as the RMAT graphs are cached.
    Returns the two paths and the seconds the write took (None: cached)."""
    import numpy as np

    from graphtpu_torch.bench import write_text

    vpath, epath = (INTERMEDIATE / name / f"{name}{s}" for s in (".v", ".e"))
    if vpath.exists() and epath.exists():
        return vpath, epath, None
    t0 = time.perf_counter()
    vpath.parent.mkdir(parents=True, exist_ok=True)
    once = g.src < g.dst
    cols = [g.src[once], g.dst[once]]
    if g.weighted:
        w = g.w[once]
        cols.append(np.array(list(map("%.17g".__mod__, w.tolist())), dtype="S24"))
    write_text(vpath, [g.mapping])
    write_text(epath, cols)
    return vpath, epath, time.perf_counter() - t0


def _median(xs):
    return sorted(xs)[len(xs) // 2]


# load_graph runs a graph on the native arm; the bench phase times the
# benchmark graph's native parse and relabel (one warm-up, BENCH_REPS runs)
INGEST_NATIVE_RUNS = {BENCH_GRAPH: 1, SSSP_GRAPH: 3}


def phase_ingest(g, gw, smi):
    """The text ingest at real size: both RMAT graphs written as .v/.e text,
    loaded back through load_graph on the native arm (the weighted graph 3
    runs; the benchmark graph once, as the bench phase times its native
    parse and relabel) and, for the benchmark graph, once on the numpy arm
    with parse and relabel apart;
    every Graph must equal the RMAT one bit for bit. Then the device sort
    (which a Graph takes where a card is visible) of the benchmark graph's
    stored edges in a shuffled order against the native counting sort of
    the same stream. Returns the numbers for the JSON line."""
    import numpy as np
    import torch

    from graphtpu_torch.core import graph as graph_mod
    from graphtpu_torch.ingest import native
    from graphtpu_torch.ingest.loader import load_graph
    from graphtpu_torch.ingest.relabel import (
        _parse_edges_numpy, _parse_vertices_numpy, parse_edge_file, parse_vertex_file,
    )

    def same(a, b, what):
        for name in ("src", "dst", "w", "mapping"):
            x, y = getattr(a, name), getattr(b, name)
            check(x.dtype == y.dtype and np.array_equal(x, y),
                  f"ingest: {what} differs from the RMAT graph in {name}")

    check(native.available(), "ingest: the native library is off (no C++ compiler?)")
    report = {"card": smi, "graphs": {}}
    for name, gr in ((BENCH_GRAPH, g), (SSSP_GRAPH, gw)):
        vpath, epath, write_s = write_text_graph(gr, name)
        lines = int((gr.src < gr.dst).sum())
        print(f"ingest {name}: text {vpath.stat().st_size + epath.stat().st_size} bytes, "
              f"{gr.n} vertex lines, {lines} edge lines, "
              + (f"written in {write_s:.3f} s" if write_s is not None else "cached"), flush=True)
        native.reset_call_counts()
        secs = []
        runs = INGEST_NATIVE_RUNS[name]
        for _ in range(runs):
            t0 = time.perf_counter()
            back = load_graph(str(vpath), str(epath), directed=False, weighted=gr.weighted)
            secs.append(time.perf_counter() - t0)
            same(back, gr, f"{name} loaded natively")
            del back
        calls = dict(native.call_counts)
        check(calls["gtio_relabel_edges"] == runs and calls["gtio_parse_edges"] == runs,
              f"ingest: {name} did not go through the native library {runs} times: {calls}")
        t0 = time.perf_counter()
        vids = parse_vertex_file(str(vpath))
        es, ed, ew = parse_edge_file(str(epath), gr.weighted)
        t1 = time.perf_counter()
        graph_mod.Graph.from_original_ids(vids, es, ed, ew, False, gr.weighted)
        t2 = time.perf_counter()
        del vids, es, ed, ew
        entry = {"edge_lines": lines, "write_s": write_s, "native_load_s": secs,
                 "native_parse_s": t1 - t0, "native_relabel_s": t2 - t1, "native_calls": calls}
        print(f"ingest {name} native: load_graph {', '.join(f'{x:.3f}' for x in secs)} s, "
              f"median {_median(secs):.3f} s; parse {t1 - t0:.3f} s, relabel {t2 - t1:.3f} s; "
              f"Graph equal to the RMAT graph bit for bit; native calls {calls} ({smi})",
              flush=True)
        report["graphs"][name] = entry

    # the numpy arm, once, on the benchmark graph
    vpath, epath = (INTERMEDIATE / BENCH_GRAPH / f"{BENCH_GRAPH}{s}" for s in (".v", ".e"))
    prev = os.environ.get("GRAPHTPU_NATIVE_LIB"), graph_mod.DEVICE_SORT_MIN
    os.environ["GRAPHTPU_NATIVE_LIB"] = os.devnull
    try:
        check(not native.available(), "ingest: GRAPHTPU_NATIVE_LIB=/dev/null left it on")
        t0 = time.perf_counter()
        vids = _parse_vertices_numpy(str(vpath))
        es, ed, _ = _parse_edges_numpy(str(epath), False)
        t1 = time.perf_counter()
        graph_mod.DEVICE_SORT_MIN = 1 << 62  # the host sort
        back = graph_mod.Graph.from_original_ids(vids, es, ed, None, False, False)
        t2 = time.perf_counter()
        same(back, g, f"{BENCH_GRAPH} loaded by numpy")
        del back
        graph_mod.DEVICE_SORT_MIN = prev[1]  # the card's sort, as without a compiler
        graph_mod.last_device_sort.clear()
        t3 = time.perf_counter()
        back = graph_mod.Graph.from_original_ids(vids, es, ed, None, False, False)
        t4 = time.perf_counter()
        check(bool(graph_mod.last_device_sort), "ingest: the numpy relabel did not sort on "
              "the card")
        same(back, g, f"{BENCH_GRAPH} loaded by numpy with the card's sort")
    finally:
        graph_mod.DEVICE_SORT_MIN = prev[1]
        if prev[0] is None:
            del os.environ["GRAPHTPU_NATIVE_LIB"]
        else:
            os.environ["GRAPHTPU_NATIVE_LIB"] = prev[0]
    del back, vids, es, ed
    report["graphs"][BENCH_GRAPH].update(numpy_parse_s=t1 - t0, numpy_relabel_s=t2 - t1,
                                         numpy_relabel_device_sort_s=t4 - t3)
    print(f"ingest {BENCH_GRAPH} numpy: parse {t1 - t0:.3f} s, relabel {t2 - t1:.3f} s with "
          f"the host sort, {t4 - t3:.3f} s with the card's sort; Graphs equal bit for bit "
          f"({smi})", flush=True)

    # the device sort against the native sort of one shuffled stream
    perm = np.random.default_rng(42).permutation(g.nnz)
    src, dst = g.src[perm], g.dst[perm]
    del perm
    t0 = time.perf_counter()
    ns, nd, _ = graph_mod._native_sort_edges(src, dst, None, g.n, "src", True)
    nat = time.perf_counter() - t0
    check(np.array_equal(ns, g.src) and np.array_equal(nd, g.dst),
          "ingest: the native sort of the shuffled stream is not the graph's order")
    dev = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(3):  # the first also allocates the pinned host buffers
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = graph_mod._device_sort_edges(src, dst, None, "src", True)
        dev.append({"total_s": time.perf_counter() - t0, **graph_mod.last_device_sort})
        check(out is not None, "ingest: the device sort declined on the card")
        check(np.array_equal(out[0], ns) and np.array_equal(out[1], nd) and out[2] is None,
              "ingest: the device sort differs from the native sort")
        del out
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    torch.cuda.empty_cache()
    report["sort"] = {"edges": int(g.nnz), "native_s": nat, "device": dev,
                      "device_peak_gib": peak}
    print(f"ingest sort of {g.nnz} shuffled edges: native counting sort {nat:.3f} s; device "
          f"peak memory {peak:.3f} GiB above what was allocated ({smi})", flush=True)
    for i, d in enumerate(dev):
        print(f"ingest device sort, run {i}: {d['total_s']:.3f} s (host-to-device "
              f"{d['h2d_s']:.3f}, sort and dedup {d['sort_s']:.3f}, device-to-host "
              f"{d['d2h_s']:.3f}); identical to the native sort ({smi})", flush=True)
    return report


BENCH_REPS = 3  # the bench phase's timed runs a value (GRAPHTPU_BENCH_REPS)
# the bench's ladders and their first rungs
BENCH_FIRST_RUNGS = {"wcc": "auto:slab-adaptive", "sssp": "adaptive", "lcc": "wedge",
                     "ingest": "text"}
BENCH_RATES = ("cdlp_edges_per_s", "pr_nnz_per_s", "bfs_gteps", "wcc_edges_per_s",
               "ingest_rows_per_s", "ingest_parse_rows_per_s")


def phase_bench(smi, real_steps, lcc_nonzero):
    """``python -m graphtpu_torch.bench`` in a child process on cuda:0 at its
    defaults, on the graphs cached by phase 3, with BENCH_REPS timed runs a
    value. Its JSON line must say backend cuda, hold no error and only
    first rungs, positive rates, every sol_pct in (0, 100], and the step
    counts and LCC nonzeros that phase 3 measured (the JAX package's counts
    where JAX_STEPS has them). Returns the bench's JSON object."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("GRAPHTPU_BENCH_")}
    env.update(GRAPHTPU_BENCH_REPS=str(BENCH_REPS), GRAPHTPU_BENCH_CACHE=str(INTERMEDIATE),
               PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "graphtpu_torch.bench"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    d = out["details"]
    check(out["metric"] == "cdlp_edges_per_s" and d["backend"] == "cuda", "bench: not on cuda")
    errors = [k for k in d if k.endswith(("_error", "_errors"))]
    check(not errors, f"bench: {[(k, d[k]) for k in errors]}")
    for name, rung in BENCH_FIRST_RUNGS.items():
        check(d.get(f"{name}_impl_used") == rung,
              f"bench: {name} ran {d.get(f'{name}_impl_used')}, not its first rung {rung}")
    for k in BENCH_RATES:
        check(d[k] > 0, f"bench: {k} = {d[k]}")
    shares = {k: v for k, v in d.items() if k.endswith("_sol_pct") or k.endswith("_volume")}
    check(len(shares) == 5 and all(0 < v <= 100 for v in shares.values()),
          f"bench: shares outside (0, 100]: {shares}")
    (it, full), (bn, tiers, bu, dense), wcc, sssp, _ = real_steps
    bench_bfs = (d["bfs_iters"],
                 {int(k[5:]): v for k, v in d["bfs_phase_steps"].items() if k.startswith("tier_")},
                 d["bfs_phase_steps"]["bottom_up"], d["bfs_phase_steps"]["dense"])
    got = {"cdlp": (d["cdlp_iters"], d["cdlp_full_steps"], d["cdlp_active_steps"]),
           "bfs": bench_bfs,
           "wcc": (d["wcc_iters"], d["wcc_full_steps"], d["wcc_active_steps"]),
           "sssp": (d["sssp_rounds"], d["sssp_full_steps"], d["sssp_active_steps"])}
    want = {"cdlp": (max(it, 1), full, it - full), "bfs": (bn, tiers, bu, dense),
            "wcc": wcc["wcc-auto"], "sssp": sssp}
    for name in got:
        check(got[name] == want[name],
              f"bench: {name} steps {got[name]}, phase 3 measured {want[name]}")
        if name in JAX_STEPS:
            check(got[name] == JAX_STEPS[name], f"bench: {name} steps differ from JAX's")
    check(d["lcc_nonzero"] == lcc_nonzero,
          f"bench: lcc_nonzero {d['lcc_nonzero']}, phase 3 {lcc_nonzero}")
    print(f"bench ({smi}; {BENCH_REPS} timed runs a value, child process {wall:.3f} s): "
          f"cdlp_edges_per_s {d['cdlp_edges_per_s']:.6e} (median {d['cdlp_s']:.6f} s, min "
          f"{d['cdlp_s_min']:.6f}, max {d['cdlp_s_max']:.6f}, event span "
          f"{d['cdlp_s_event_s']:.6f}); pr_nnz_per_s {d['pr_nnz_per_s']:.6e}; bfs_gteps "
          f"{d['bfs_gteps']:.6f}; wcc_s {d['wcc_s']:.6f}; sssp_s {d['sssp_s']:.6f}; lcc_s "
          f"{d['lcc_s']:.6f} (cold {d['lcc_cold_s']:.6f}, prep {d['lcc_prep_s']:.6f}); ingest "
          f"parse {d['ingest_parse_s']:.6f} s, relabel {d['ingest_relabel_s']:.6f} s "
          f"({d['ingest_parser']}); steps equal phase 3's and the JAX package's", flush=True)
    print("bench sol_pct: " + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
          + "; peak device bytes: " + ", ".join(
              f"{k[:-len('_peak_device_bytes')]} {v}" for k, v in d.items()
              if k.endswith("_peak_device_bytes")), flush=True)
    return out


# the distributed loops, each through try_run_distributed, against
# run_algorithm's one-device twin: name -> (algorithm, the impl that selects
# the distributed loop, the twin's impl, the kernels its ranks launch). The
# naive loops first, then the JAX package's defaults.
PARALLEL_RUNS = {
    "pr_dist": ("pr", {"pr_impl": "segment"}, {"pr_impl": "scan"}, ("csr_pull_reduce_sum",)),
    "bfs_dist": ("bfs", {"bfs_impl": "dense"}, {"bfs_impl": "device"}, ("csr_pull_reduce",)),
    "sssp_dist": ("sssp", {"sssp_impl": "dense"}, {"sssp_impl": "device"},
                  ("csr_pull_reduce",)),
    "wcc_dist": ("wcc", {"wcc_impl": "dense"}, {"wcc_impl": "device"},
                 ("csr_pull_reduce", "gather_rows")),
    "cdlp_dist": ("cdlp", {"cdlp_impl": "sort"}, {"cdlp_impl": "sort"}, ("gather_rows",)),
    "lcc_dist": ("lcc", {"lcc_impl": "sweep"}, {"lcc_impl": "sweep"}, ("gather_rows",)),
    "pr_slab_dist": ("pr", {"pr_impl": "slab"}, {"pr_impl": "slab"},
                     ("gather_rows", "slab_spmv_sum")),
    "cdlp_slab_dist": ("cdlp", {"cdlp_impl": "slab"}, {"cdlp_impl": "slab"}, ("slab_minmode",)),
    "bfs_adaptive_dist": ("bfs", {"bfs_impl": "adaptive"}, {"bfs_impl": "adaptive"},
                          ("frontier_expand", "gather_rows")),
    "sssp_adaptive_dist": ("sssp", {"sssp_impl": "adaptive"}, {"sssp_impl": "adaptive"},
                           ("frontier_expand", "push_relax_min", "csr_pull_reduce")),
    "wcc_adaptive_dist": ("wcc", {"wcc_impl": "auto"}, {"wcc_impl": "auto"},
                          ("slab_spmv_min", "frontier_expand")),
    "lcc_oriented_dist": ("lcc", {"lcc_impl": "auto"}, {"lcc_impl": "auto"},
                          ("wedge_rowblock",)),
}
PARALLEL_LCC_SCALE = 14  # the sweep's graph: RMAT s14/ef16, as phase 3's oracle check


def _dist_steps(name, sg, cfg):
    """The step counts of a default distributed loop, from one more run
    with its statistics (outside the counted run): BFS levels and (tier
    steps by edge budget, bottom-up, dense); SSSP and WCC (rounds, full,
    active); None for the others."""
    from graphtpu_torch.parallel.adaptive_bfs import bfs_adaptive_dist
    from graphtpu_torch.parallel.adaptive_sssp import sssp_adaptive_dist
    from graphtpu_torch.parallel.adaptive_wcc import wcc_adaptive_dist

    if name == "bfs_adaptive_dist":
        _, it, st = bfs_adaptive_dist(sg, 0, cfg, with_stats=True)
        return it, st["tier_steps"], st["bu_steps"], st["dense_steps"]
    if name == "sssp_adaptive_dist":
        _, it, st = sssp_adaptive_dist(sg, 0, cfg, with_stats=True)
        return it, st["full_steps"], st["active_steps"]
    if name == "wcc_adaptive_dist":
        _, it, st = wcc_adaptive_dist(sg, cfg, with_stats=True)
        return it, st["full_steps"], st["active_steps"]
    return None


def phase_parallel(g, gw, device, smi, real_steps):
    """The distributed loops (graphtpu_torch/parallel/) over a one-rank NCCL
    group on cuda:0, each through try_run_distributed with num-devices 1, on
    the bench graphs (the naive LCC sweep on RMAT s14/ef16): first the naive
    loops, then the JAX package's defaults (slab PageRank and CDLP, adaptive
    BFS, SSSP and WCC, oriented-wedge LCC, the last on phase 3's memoized
    wedge plan). Each equals run_algorithm under its one-device twin bit for
    bit (PageRank within PR_RTOL), each run's launch counts show the kernels
    its rank routes to, and the default loops' step counts print beside the
    twin's and the JAX package's (``real_steps``, phase 3's): SSSP's rounds,
    full and active rounds and BFS's levels must equal them, as must CDLP's
    iterations the twin's; BFS's phases and WCC's rounds follow per-rank
    budgets and gates of their own, which tests/test_torch_dist_adaptive.py
    holds against the JAX package's distributed functions. The host plan
    builds and installs are timed (a first run's extra time). Then
    dryrun_multichip(2) over gloo on the CPU. Returns the times, launches and
    step counts."""
    import numpy as np
    import torch

    from graphtpu_torch.algorithms.common import run_algorithm
    from graphtpu_torch.entry import dryrun_multichip
    from graphtpu_torch.ops import kernels
    from graphtpu_torch.parallel import dispatch
    from graphtpu_torch.parallel.mesh import current_mesh, make_mesh
    from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig
    from graphtpu_torch.utils.synth import rmat_graph

    mesh = make_mesh(1, device)
    check((mesh.size, mesh.backend, mesh.device) == (1, "nccl", torch.device("cuda", 0)),
          f"parallel: mesh {mesh.size} x {mesh.backend} on {mesh.device}")
    small = rmat_graph(PARALLEL_LCC_SCALE, 16, directed=False, seed=7)
    params = {"pr": AlgorithmParams(damping_factor=DAMPING, num_iterations=PR_ITERS),
              "bfs": AlgorithmParams(source_vertex=0), "sssp": AlgorithmParams(source_vertex=0),
              "wcc": AlgorithmParams(), "cdlp": AlgorithmParams(max_iterations=CDLP_ITERS),
              "lcc": AlgorithmParams()}
    _, (bn, btiers, bbu, bdense), wcc_steps, sssp_steps, _ = real_steps
    twin_steps = {"bfs_adaptive_dist": (bn, btiers, bbu, bdense),
                  "sssp_adaptive_dist": sssp_steps,
                  "wcc_adaptive_dist": wcc_steps["wcc-auto"]}
    report = {}
    for name, (algo, dist_impl, one_impl, needed) in PARALLEL_RUNS.items():
        gr = small if name == "lcc_dist" else gw if algo == "sssp" else g
        cfg = PlatformConfig(device=str(device), intermediate_dir=str(INTERMEDIATE),
                             num_devices=1, **dist_impl)
        secs = []
        for _ in range(2):  # the first run builds the host plans and installs them
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = dispatch.try_run_distributed(algo, gr, params[algo], cfg)
            secs.append(time.perf_counter() - t0)
            counts = {k: v for k, v in kernels.launch_counts.items() if v}
        check(res is not None, f"parallel: {name} declined")
        for k in needed:
            check(counts.get(k, 0) > 0, f"parallel: {name} launched no {k}: {counts}")
        one_cfg = PlatformConfig(device=str(device), intermediate_dir=str(INTERMEDIATE),
                                 **one_impl)
        for _ in range(2):  # the first run builds and copies the one-device plan
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one = run_algorithm(algo, gr, params[algo], one_cfg)
            one_s = time.perf_counter() - t0
        check(res.values.shape == one.values.shape, f"parallel: {name} shape differs")
        if name != "wcc_adaptive_dist":  # its rounds follow its own gate (docstring)
            check(res.iterations == one.iterations,
                  f"parallel: {name} {res.iterations} iterations, the one-device twin "
                  f"{one.iterations}")
        if algo == "pr":
            err = float(np.max(np.abs(res.values - one.values) / np.abs(one.values)))
            check(err <= PR_RTOL, f"parallel: {name} max relative error {err} > {PR_RTOL}")
        else:
            err = 0.0
            check(np.array_equal(res.values, one.values),
                  f"parallel: {name} differs from the one-device {one_impl}")
        steps = _dist_steps(name, dispatch._sharded(gr, cfg, np.float32), cfg)
        report[name] = {"s": secs[1], "first_s": secs[0], "one_device_s": one_s,
                        "launches": counts, "max_rel_err": err, "iterations": res.iterations}
        said = ""
        if steps is not None:
            report[name]["steps"] = steps
            jax_steps = JAX_STEPS[algo]
            said = (f"; steps {steps}, the one-device twin's {twin_steps[name]}, the JAX "
                    f"package's one-device {jax_steps}")
            if algo == "sssp":
                check(steps == twin_steps[name] == jax_steps,
                      f"parallel: {name} steps {steps} differ from the twin's or JAX's")
            if algo == "bfs":
                check(steps[0] == bn == jax_steps[0], f"parallel: {name} levels {steps[0]}")
        print(f"parallel {name} (1 NCCL rank, {smi}): {secs[1]:.6f} s warm ({secs[0]:.6f} s "
              f"with the host plans' build and install), one-device {one_impl} {one_s:.6f} s "
              f"warm; {'max relative error %.3e' % err if algo == 'pr' else 'equal bit for bit'}"
              f", {res.iterations} iterations{said}; launches {counts}", flush=True)
    for gr in (g, gw, small):
        dispatch.purge_sharded(gr)
    check(current_mesh() is None, "parallel: the mesh outlived the last sharded graph")
    # a gloo mesh's start (its worker's import of torch and the group's
    # rendezvous), what a num-devices job's warm-up pays; the dry run reuses it
    t0 = time.perf_counter()
    make_mesh(2, "cpu")
    start_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dryrun_multichip(2)
    check(current_mesh() is None, "parallel: the dry run left its mesh running")
    report["gloo_mesh_2_start_s"] = start_s
    print(f"parallel: a 2-rank gloo mesh started in {start_s:.3f} s; dryrun_multichip(2) over "
          f"it on the CPU passed in {time.perf_counter() - t0:.3f} s ({smi})", flush=True)
    return report


def phase_vreg_shuffle(device):
    """K4's own drive: it has no path in the system. Returns its launches."""
    import torch

    from graphtpu_torch.ops import kernels
    from graphtpu_torch.ops.pallas_gather import vreg_shuffle

    gen = torch.Generator(device=device).manual_seed(1)
    tbl8 = torch.randn(8, 128, generator=gen, device=device)
    ind = torch.randint(0, 8, (8, 128), generator=gen, device=device, dtype=torch.int32)
    kernels.reset_launch_counts()
    out = vreg_shuffle(tbl8, ind)
    count = kernels.launch_counts["vreg_shuffle"]
    check(count == 1, f"vreg_shuffle launched {count} times, expected 1")
    check(torch.equal(out, tbl8.gather(0, ind.long())), "vreg_shuffle result")
    return count


def phase_kernels(g, prep, pr_plan, device):
    """Each kernel against its plain version at the path's shapes."""
    import torch

    from graphtpu_torch.ops.frontier import (
        compact, compact_stream, expand, frontier_deg_sum, frontier_expand,
        frontier_expand_plain, mask_status,
    )
    from graphtpu_torch.ops.pallas_gather import vreg_shuffle, vreg_shuffle_plain
    from graphtpu_torch.utils.config import PlatformConfig

    from graphtpu_torch.ops.gather import gather_rows, gather_rows_plain
    from graphtpu_torch.ops.minmode import (
        _iter0_minmode, slab_minmode, slab_minmode_buckets, slab_minmode_plain,
    )
    from graphtpu_torch.ops.slab import result_buffer
    from graphtpu_torch.ops.spmv import (
        slab_spmv_sum, slab_spmv_sum_buckets, slab_spmv_sum_plain,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    n = g.n
    cdlp_plan = prep.plan
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
        bytes=4 * (n + 2 * idx1.shape[0]), ops=0,  # the table, the indices, the output
        library=("torch.index_select", lambda: torch.index_select(labels, 0, idx1)),
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
    # all buckets of the plan at once (the path's two launches a step)
    total = cdlp_plan.table.total
    for mode in ("gather", "identity", "min"):
        lab = lab1 if mode == "gather" else None
        buf = result_buffer(cdlp_plan, torch.int32)
        slab_minmode_buckets(cdlp_plan, mode, n, lab, buf)
        want = torch.cat([slab_minmode_plain(b.slab, mode, n, lab) for b in cdlp_plan.slabs])
        check(torch.equal(buf[:total], want), f"slab_minmode_buckets {mode} differs")
    real, padded, rows = plan_counts(cdlp_plan)
    buf = result_buffer(cdlp_plan, torch.int32)
    res["slab_minmode"] = dict(
        max_abs_err=0.0,
        times=(cuda_ms(lambda: slab_minmode_buckets(cdlp_plan, "gather", n, lab1, buf)),
               cuda_ms(lambda: [slab_minmode_plain(b.slab, "gather", n, lab1)
                                for b in cdlp_plan.slabs])),
        shape=(f"gather mode, all {len(cdlp_plan.slabs)} CDLP buckets (one full step's bucket "
               f"work): {real} stored slots ({padded} with pad), {rows} rows"),
        bytes=4 * (real + n + rows), ops=real,  # slab ids, labels, results; a count per slot
        library=None,  # no single call: a gather, a sort and a run-length pass
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
    total = pr_plan.table.total
    for xd, rtol in ((x, F32_SUM_RTOL), (x.double(), 1e-12)):
        got, again = result_buffer(pr_plan, xd.dtype), result_buffer(pr_plan, xd.dtype)
        slab_spmv_sum_buckets(pr_plan, xd, got)
        slab_spmv_sum_buckets(pr_plan, xd, again)
        check(torch.equal(got[:total], again[:total]),
              f"slab_spmv_sum_buckets {xd.dtype}: two runs differ")
        want = torch.cat([slab_spmv_sum_plain(b.slab, xd) for b in pr_plan.slabs]).double()
        bad = (got[:total].double() - want).abs() > rtol * want.abs()
        check(not bool(bad.any()), f"slab_spmv_sum_buckets {xd.dtype} differs")
    real, padded, rows = plan_counts(pr_plan)
    csr = plan_csr(pr_plan, n, torch.float32)
    y_lib = torch.mv(csr, x)  # cuSPARSE's SpMV
    got = result_buffer(pr_plan, torch.float32)
    slab_spmv_sum_buckets(pr_plan, x, got)
    check(torch.allclose(y_lib, got[:total], rtol=F32_SUM_RTOL, atol=0),
          "the CSR product differs from slab_spmv_sum")
    res["slab_spmv_sum"] = dict(
        max_abs_err=err,
        times=(cuda_ms(lambda: slab_spmv_sum_buckets(pr_plan, x, got)),
               cuda_ms(lambda: [slab_spmv_sum_plain(b.slab, x) for b in pr_plan.slabs])),
        shape=(f"float32, all {len(pr_plan.slabs)} PR buckets (one full step's bucket work): "
               f"{real} stored slots ({padded} with pad), {rows} rows"),
        bytes=4 * (real + n + rows), ops=real,  # slab ids, x, y; an add per slot
        library=("torch.mv of a sparse CSR matrix of ones", lambda: torch.mv(csr, x)),
    )

    # K4: random [8, 128] tables and indices
    for dtype in (torch.int32, torch.float32):
        tbl8 = torch.randint(-(1 << 30), 1 << 30, (8, 128), generator=gen,
                             device=device).to(dtype)
        ind = torch.randint(0, 8, (8, 128), generator=gen, device=device, dtype=torch.int32)
        check(torch.equal(vreg_shuffle(tbl8, ind), vreg_shuffle_plain(tbl8, ind)),
              f"vreg_shuffle {dtype} differs")
    res["vreg_shuffle"] = dict(
        max_abs_err=0.0,
        times=(cuda_ms(lambda: vreg_shuffle(tbl8, ind), reps=100),
               cuda_ms(lambda: vreg_shuffle_plain(tbl8, ind), reps=100)),
        shape="[8, 128] float32",
        bytes=3 * 8 * 128 * 4, ops=0,  # the table, the indices, the output
        library=("torch.gather", lambda ind64=ind.long(): torch.gather(tbl8, 0, ind64)),
    )

    # K5 at the path's shapes: the changed mask after the first full step,
    # compacted at k_max and expanded at e_max (truncated: far more edges
    # than slots), then the active set a tier step expands once the mask fits
    from graphtpu_torch.ops.active import cdlp_tiers
    from graphtpu_torch.ops.minmode import cdlp_step

    cfg = PlatformConfig(device=str(device))
    m = int(prep.neigh.shape[0])
    k_max, e_max = cdlp_tiers(cfg.cdlp_frontier_rows, cfg.cdlp_frontier_edges, m, cfg)[-1]
    deg_n = prep.deg_pad[:-1]

    def k5_inputs(ids, deg_pad=prep.deg_pad, indptr_pad=prep.indptr_pad, neigh=prep.neigh):
        lens = deg_pad[ids.long()]
        starts = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0, dtype=torch.int32)])
        return ids, starts, indptr_pad, neigh

    def k5_check(args, e_cap, what):
        for with_row_ids in (True, False):
            got = frontier_expand(*args, e_cap, with_row_ids)
            again = frontier_expand(*args, e_cap, with_row_ids)
            want = frontier_expand_plain(*args, e_cap, with_row_ids)
            for fname, a, a2, b in zip(("rows_local", "row_ids", "gpos", "neigh", "valid"),
                                       got, again, want):
                check((a is None and b is None) or torch.equal(a, b),
                      f"frontier_expand {what} {fname} differs")
                check(a is None or torch.equal(a, a2),
                      f"frontier_expand {what} {fname}: two runs differ")

    prev, cur = lab1, cdlp_step(lab1, cdlp_plan)  # labels after iterations 0 and 1
    full_ids, full_cnt = compact(cur != prev, k_max)
    full_args = k5_inputs(full_ids)
    k5_check(full_args, e_max, "full-step mask")
    steps = 2
    while True:
        cnt, ce = mask_status(cur != prev, deg_n).tolist()
        if cnt <= k_max and ce <= e_max:
            break
        check(steps < CDLP_ITERS, "the changed mask never fits the tier")
        prev, cur = cur, cdlp_step(cur, cdlp_plan)
        steps += 1
    ids, _ = compact(cur != prev, k_max)
    exp = expand(ids, prep.deg_pad, prep.indptr_pad, prep.neigh, e_max)
    tier_ids, tier_cnt = compact_stream(exp.neigh, exp.valid, k_max, n)
    tier_args = k5_inputs(tier_ids)
    k5_check(tier_args, e_max, "tier-step frontier")
    tier_edges = int(frontier_deg_sum(tier_ids, prep.deg_pad))
    # hand-made: empty rows around real ones, an empty frontier, truncation
    deg_pad = torch.tensor([0, 2, 0, 0, 3, 0, 1, 0], dtype=torch.int32, device=device)
    indptr = torch.cat([deg_pad.new_zeros(1), torch.cumsum(deg_pad[:-1], 0, dtype=torch.int32)])
    small_neigh = torch.arange(10, 16, dtype=torch.int32, device=device)
    for ids_list, e_cap in (([0, 1, 2, 3, 4, 5, 6, 7], 8), ([0, 2, 3, 7, 7], 4),
                            ([7, 7, 7], 5), ([1, 4, 6, 7], 3), ([4, 6, 7], 1)):
        ids_s = torch.tensor(ids_list, dtype=torch.int32, device=device)
        lens = deg_pad[ids_s.long()]
        starts = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0, dtype=torch.int32)])
        k5_check((ids_s, starts, indptr, small_neigh), e_cap, f"hand case {ids_list}/{e_cap}")
    # BFS's top push tier with a frontier that fills it: the rows of a random
    # sample, cut where their out-edges pass the tier's slots; and k = 1
    from graphtpu_torch.algorithms.bfs import BFS_TRUNC, bfs_adaptive_prep

    bprep = bfs_adaptive_prep(g, BFS_TRUNC, device)
    e_top = int(cfg.bfs_frontier_edges or 1 << 22)
    k_top = min(int(cfg.bfs_frontier_rows or 1 << 18), e_top, n)
    order = torch.randperm(n, generator=gen, device=device)[:k_top]
    filled = torch.cumsum(bprep.deg_pad[order].long(), 0) >= e_top
    top_cnt = int(filled.long().argmax()) + 1 if bool(filled.any()) else k_top
    top_ids = torch.full((k_top,), n, dtype=torch.int32, device=device)
    top_ids[:top_cnt] = order[:top_cnt].sort().values.to(torch.int32)
    top_args = k5_inputs(top_ids, bprep.deg_pad, bprep.push_indptr, bprep.push_dst)
    top_edges = int(top_args[1][-1])
    k5_check(top_args, e_top, "BFS top tier")
    k5_check(k5_inputs(top_ids[:1], bprep.deg_pad, bprep.push_indptr, bprep.push_dst), e_top,
             "BFS top tier, k = 1")
    top_times = (cuda_ms(lambda: frontier_expand(*top_args, e_top, False)),
                 cuda_ms(lambda: frontier_expand_plain(*top_args, e_top, False)))
    top_bytes = (4 * (2 * k_top + 1) + 4 * top_cnt + 4 * min(top_edges, e_top) + 13 * e_top)
    res["frontier_expand"] = dict(
        max_abs_err=0.0,
        times=(cuda_ms(lambda: frontier_expand(*tier_args, e_max, False)),
               cuda_ms(lambda: frontier_expand_plain(*tier_args, e_max, False))),
        other_shapes=[dict(
            shape=(f"BFS top tier: {k_top} ids ({top_cnt} real, {top_edges} edges) into "
                   f"{e_top} slots"),
            times=top_times, bytes=top_bytes, ops=e_top * 4)],
        shape=(f"tier step: {k_max} ids ({int(tier_cnt)} real, {tier_edges} edges, after "
               f"{steps} steps) into {e_max} slots; full-step mask: {int(full_cnt)} changed, "
               f"{k_max} kept"),
        # ids and starts, an indptr entry per real id, a neighbour per valid
        # slot; rows_local, gpos, neigh (int32) and valid (bool) per slot
        bytes=(4 * (2 * k_max + 1) + 4 * int(tier_cnt) + 4 * min(tier_edges, e_max)
               + 13 * e_max),
        ops=e_max * 16,  # a binary search of the row starts per slot
        library=None,  # no single call: a scatter, a cummax and three gathers
    )

    return res


def phase_traversal_kernels(g, gw, device):
    """K6, K7 and K8 against their plain versions at the traversal paths'
    shapes and on small hand-made cases."""
    import torch

    from graphtpu_torch.algorithms.sssp import _initial, _sssp_dense_step, sssp_prep, sssp_tiers
    from graphtpu_torch.algorithms.wcc import _wcc_slab_steps, wcc_slab_plan
    from graphtpu_torch.core.types import INT32_INF
    from graphtpu_torch.ops.frontier import compact, expand, mask_status, relax_min, relax_min_plain
    from graphtpu_torch.ops.slab import result_buffer
    from graphtpu_torch.ops.spmv import (
        CSR_ITEMS, PullCSR, csr_pull_reduce, csr_pull_reduce_plain, pull_csr, slab_spmv_min,
        slab_spmv_min_buckets, slab_spmv_min_plain,
    )
    from graphtpu_torch.utils.config import PlatformConfig

    n, res = g.n, {}

    # K6: every bucket of the WCC plan in both modes, with the labels after
    # iteration 0; then hand-made slabs (a column of pad only, ids past n)
    plan = wcc_slab_plan(g, device)
    lab1, _ = _wcc_slab_steps(plan, n)[1]()
    for b in plan.slabs:
        for x in (lab1, None):
            check(torch.equal(slab_spmv_min(b.slab, x, n), slab_spmv_min_plain(b.slab, x, n)),
                  f"slab_spmv_min {'identity' if x is None else 'gather'} "
                  f"W={b.slab.shape[0]} differs")
    hand = torch.tensor([[-1, 5, 2, 7], [-1, 9, -1, 0], [-1, 1, 3, 6]], dtype=torch.int32,
                        device=device)
    small_x = torch.tensor([4, -3, 8, 8, 0, 2, 1 << 30, 5], dtype=torch.int32, device=device)
    for x in (small_x, None):
        got = slab_spmv_min(hand, x, 8)
        check(torch.equal(got, slab_spmv_min_plain(hand, x, 8)) and int(got[0]) == INT32_INF,
              "slab_spmv_min hand case differs")
    total = plan.table.total
    for x in (lab1, None):
        buf = result_buffer(plan, torch.int32)
        slab_spmv_min_buckets(plan, x, n, buf)
        want = torch.cat([slab_spmv_min_plain(b.slab, x, n) for b in plan.slabs])
        check(torch.equal(buf[:total], want),
              f"slab_spmv_min_buckets {'identity' if x is None else 'gather'} differs")
    real, padded, rows = plan_counts(plan)
    res["slab_spmv_min"] = dict(
        max_abs_err=0.0,
        times=(cuda_ms(lambda: slab_spmv_min_buckets(plan, lab1, n, buf)),
               cuda_ms(lambda: [slab_spmv_min_plain(b.slab, lab1, n) for b in plan.slabs])),
        shape=(f"gather mode, all {len(plan.slabs)} WCC buckets (one full step's bucket work): "
               f"{real} stored slots ({padded} with pad), {rows} rows"),
        bytes=4 * (real + n + rows), ops=real,  # slab ids, x, y; a min per slot
        library=None,  # no single call: a gather, a where and a row min
    )

    # K7: the three modes on the full pull CSRs (BFS's frontier at level 1,
    # WCC's labels after iteration 0 and the stored ids, SSSP's distances
    # after two rounds in float32 and float64); then empty rows by hand
    pull = pull_csr(g, device)
    bfs_mask = torch.zeros(n, dtype=torch.int32, device=device)
    bfs_mask[pull.src[pull.indptr[0]:pull.indptr[1]].long()] = 1
    sp32, sp64 = sssp_prep(gw, torch.float32, device), sssp_prep(gw, torch.float64, device)
    dists = {}
    for sp, dtype in ((sp32, torch.float32), (sp64, torch.float64)):
        d = _initial(gw.n, 0, dtype, device)
        for _ in range(2):
            d, _ = _sssp_dense_step(d, sp.pull, sp.pull_w)
        dists[dtype] = d
    cases = [("max_i32", bfs_mask, pull, None), ("min_i32", lab1, pull, None),
             ("min_i32", None, pull, None),
             ("min_plus", dists[torch.float32], sp32.pull, sp32.pull_w),
             ("min_plus", dists[torch.float64], sp64.pull, sp64.pull_w)]
    # the heavy rows of the WCC slab plan alone: what WCC under auto launches
    heavy = PullCSR(plan.heavy_neigh, plan.heavy_indptr)
    cases += [("min_i32", lab1, heavy, None), ("min_i32", None, heavy, None)]
    for mode, x, csr, w in cases:
        got = csr_pull_reduce(mode, x, csr.src, csr.indptr, w)
        want = csr_pull_reduce_plain(mode, x, csr.src, csr.indptr, w)
        what = (f"csr_pull_reduce {mode} {None if x is None else x.dtype} "
                f"({csr.indptr.shape[0] - 1} rows)")
        check(torch.equal(got, want), f"{what} differs")
        check(torch.equal(got, csr_pull_reduce(mode, x, csr.src, csr.indptr, w)),
              f"{what}: two runs differ")
    def k7_agrees(mode, got, want):
        """Bit for bit, but for sums: within F32_SUM_RTOL or F64_SUM_RTOL of
        the plain version's float64 row sums."""
        if mode != "sum":
            return torch.equal(got, want)
        rtol = F32_SUM_RTOL if got.dtype == torch.float32 else F64_SUM_RTOL
        return bool(((got.double() - want.double()).abs() <= rtol * want.double().abs()).all())

    # by hand, per value size (a block takes CSR_ITEMS items of the merged
    # list of row ends and edges): rows ending exactly on a block's border,
    # runs of empty rows longer than a block, one row of 10^6 edges, hub rows
    # only, a single empty row
    hand_gen = torch.Generator(device=device).manual_seed(7)
    for mode, dtype, with_x in (("max_i32", torch.int32, True), ("min_i32", torch.int32, True),
                                ("min_i32", torch.int32, False),
                                ("min_plus", torch.float32, True),
                                ("min_plus", torch.float64, True),
                                ("sum", torch.float32, True), ("sum", torch.float64, True)):
        ipb = CSR_ITEMS[torch.empty(0, dtype=dtype).element_size()]
        runs = [ipb + 3, 1, 1, 2 * ipb - 5, 1]  # empty rows around rows of 7, 3 ipb, 1 edges
        shapes = {
            "border": [ipb - 1, 0, ipb - 2, 5, 0, 2 * ipb - 8, 3],
            "empty runs": sum(([0] * r + [d] for r, d in zip(runs, (7, 3 * ipb, 1, 0, 0))), []),
            "one row": [1_000_000],
            "hubs only": torch.randint(4097, 12000, (1351,), generator=hand_gen,
                                       device=device).tolist(),
            "single empty row": [0],
        }
        for name, deg in shapes.items():
            deg_t = torch.tensor(deg, dtype=torch.int32, device=device)
            ip = torch.cat([deg_t.new_zeros(1), torch.cumsum(deg_t, 0, dtype=torch.int32)])
            m_h = int(ip[-1])
            src_h = torch.randint(0, n, (m_h,), generator=hand_gen, device=device,
                                  dtype=torch.int32)
            x_h = w_h = None
            if mode == "min_plus":
                x_h = torch.rand(n, generator=hand_gen, device=device, dtype=dtype) * 9
                x_h[torch.rand(n, generator=hand_gen, device=device) < 0.3] = float("inf")
                w_h = torch.rand(m_h, generator=hand_gen, device=device, dtype=dtype) + 0.01
            elif mode == "sum":
                x_h = torch.rand(n, generator=hand_gen, device=device, dtype=dtype)
            elif with_x:  # negative under max: the identity 0 is for empty rows only
                x_h = torch.randint(-1000, -1, (n,), generator=hand_gen, device=device,
                                    dtype=torch.int32)
            got = csr_pull_reduce(mode, x_h, src_h, ip, w_h)
            what = f"csr_pull_reduce hand case {name} {mode} {dtype} x={'yes' if with_x else 'no'}"
            check(k7_agrees(mode, got, csr_pull_reduce_plain(mode, x_h, src_h, ip, w_h)),
                  f"{what} differs")
            check(torch.equal(got, csr_pull_reduce(mode, x_h, src_h, ip, w_h)),
                  f"{what}: two runs differ")
    indptr = torch.tensor([0, 0, 3, 3, 4, 4], dtype=torch.int32, device=device)
    src = torch.tensor([4, 0, 2, 1], dtype=torch.int32, device=device)
    xf = torch.tensor([0.5, float("inf"), 2.0, 1.0, 0.25], device=device)
    wf = torch.tensor([1.0, 0.75, 2.0, 3.0], device=device)
    for mode, x, w in (("max_i32", small_x[:5], None), ("min_i32", small_x[:5], None),
                       ("min_i32", None, None), ("min_plus", xf, wf)):
        check(torch.equal(csr_pull_reduce(mode, x, src, indptr, w),
                          csr_pull_reduce_plain(mode, x, src, indptr, w)),
              f"csr_pull_reduce hand case {mode} differs")
    def k7_times(case):
        mode, x, csr, w = case
        return (cuda_ms(lambda: csr_pull_reduce(mode, x, csr.src, csr.indptr, w)),
                cuda_ms(lambda: csr_pull_reduce_plain(mode, x, csr.src, csr.indptr, w)))

    m7, m7b, m7h = int(sp32.pull.src.shape[0]), int(pull.src.shape[0]), int(heavy.src.shape[0])
    rows_h = heavy.indptr.shape[0] - 1
    res["csr_pull_reduce"] = dict(
        max_abs_err=0.0, times=k7_times(cases[3]),
        shape=f"min_plus float32 over the SSSP graph's {gw.nnz} in-edges (one full round)",
        # indptr, src and w per edge, x, y; an add and a min per edge
        bytes=4 * (gw.n + 1) + 8 * m7 + 8 * gw.n, ops=2 * m7,
        library=None,  # no single call: a gather, an add and a segment reduction
        other_shapes=[
            dict(shape=f"max_i32 over the benchmark graph's {m7b} in-edges (one BFS sweep)",
                 times=k7_times(cases[0]), bytes=4 * (n + 1) + 4 * m7b + 8 * n, ops=m7b),
            # x counts once whole: 12.8M edges reach every label
            dict(shape=(f"min_i32 over the WCC slab plan's {rows_h} heavy rows, {m7h} edges "
                        f"(one full step of WCC auto)"),
                 times=k7_times(cases[5]), bytes=4 * (rows_h + 1) + 4 * m7h + 4 * n + 4 * rows_h,
                 ops=m7h),
        ],
    )

    # K7 in mode sum: PageRank's scan arm over the benchmark graph's pull CSR
    # (x like its contributions r / outdeg), float32 and float64, twice for
    # the same bits, against the plain version and one CSR product
    x32 = torch.rand(n, generator=hand_gen, device=device) / n
    sum_err = 0.0
    for xd, rtol in ((x32, F32_SUM_RTOL), (x32.double(), F64_SUM_RTOL)):
        got = csr_pull_reduce("sum", xd, pull.src, pull.indptr)
        want = csr_pull_reduce_plain("sum", xd, pull.src, pull.indptr)
        err = (got.double() - want.double()).abs()
        check(bool((err <= rtol * want.double().abs()).all()),
              f"csr_pull_reduce sum {xd.dtype} on the benchmark graph differs beyond {rtol}")
        check(torch.equal(got, csr_pull_reduce("sum", xd, pull.src, pull.indptr)),
              f"csr_pull_reduce sum {xd.dtype}: two runs differ")
        if xd.dtype == torch.float32:
            sum_err = float(err.max())
    ones = torch.sparse_csr_tensor(pull.indptr, pull.src, torch.ones(m7b, device=device),
                                   size=(n, n))
    y_lib = torch.mv(ones, x32)  # cuSPARSE's SpMV
    check(torch.allclose(y_lib, csr_pull_reduce("sum", x32, pull.src, pull.indptr),
                         rtol=F32_SUM_RTOL, atol=0), "the CSR product differs from K7 sum")
    res["csr_pull_reduce_sum"] = dict(
        max_abs_err=sum_err,
        times=(cuda_ms(lambda: csr_pull_reduce("sum", x32, pull.src, pull.indptr)),
               cuda_ms(lambda: csr_pull_reduce_plain("sum", x32, pull.src, pull.indptr))),
        shape=f"sum float32 over the benchmark graph's {m7b} in-edges (one PageRank scan pull)",
        # indptr, src, x, y; an add per edge
        bytes=4 * (n + 1) + 4 * m7b + 8 * n, ops=m7b,
        library=("torch.mv of a sparse CSR matrix of ones", lambda: torch.mv(ones, x32)),
        other_shapes=[dict(
            shape=f"sum float64 over the same {m7b} in-edges",
            times=(cuda_ms(lambda: csr_pull_reduce("sum", x32.double(), pull.src, pull.indptr)),
                   cuda_ms(lambda: csr_pull_reduce_plain("sum", x32.double(), pull.src,
                                                         pull.indptr))),
            bytes=4 * (n + 1) + 4 * m7b + 16 * n, ops=m7b)],
    )

    # K8: the first tier step of SSSP from vertex 0, in float32 and float64
    cfg = PlatformConfig(device=str(device))
    tiers = sssp_tiers(cfg.sssp_frontier_rows, cfg.sssp_frontier_edges, cfg)
    k_max = tiers[-1][0]
    mask = torch.zeros(gw.n, dtype=torch.bool, device=device)
    mask[0] = True
    d = _initial(gw.n, 0, torch.float32, device)
    for _ in range(gw.n):
        acnt, ae = mask_status(mask, sp32.deg_pad[:-1]).tolist()
        check(acnt > 0, "sssp converged before any tier step")
        tier = next((i for i, (k, e) in enumerate(tiers) if acnt <= k and ae <= e), None)
        if tier is not None:
            break
        d, mask = _sssp_dense_step(d, sp32.pull, sp32.pull_w)
    k_i, e_i = tiers[tier]
    ids, _ = compact(mask, k_max)
    exp = expand(ids[:k_i], sp32.deg_pad, sp32.push_indptr, sp32.push_dst, e_i)
    slots = (exp.row_ids, exp.neigh, exp.gpos, exp.valid)
    for dd, ww in ((d, sp32.push_w), (d.double(), sp64.push_w)):
        got, want = relax_min(dd, *slots, ww), relax_min_plain(dd, *slots, ww)
        check(torch.equal(got, want), f"push_relax_min {dd.dtype} tier step differs")
    dist3 = torch.tensor([0.0, float("inf"), float("inf")], device=device)
    two = torch.tensor([0, 0], dtype=torch.int32, device=device)
    w2 = torch.tensor([1.0, 1.0], device=device)
    target = torch.tensor([2, 2], dtype=torch.int32, device=device)
    gp = torch.tensor([0, 1], dtype=torch.int32, device=device)
    for valid in (torch.tensor([True, True], device=device),
                  torch.tensor([False, False], device=device)):
        got = relax_min(dist3, two, target, gp, valid, w2)
        check(torch.equal(got, relax_min_plain(dist3, two, target, gp, valid, w2)),
              "push_relax_min hand case differs")
    res["push_relax_min"] = dict(
        max_abs_err=0.0,
        times=(cuda_ms(lambda: relax_min(d, *slots, sp32.push_w)),
               cuda_ms(lambda: relax_min_plain(d, *slots, sp32.push_w))),
        shape=(f"float32, the first tier step from vertex 0: {k_i} rows / {e_i} slots, "
               f"{acnt} changed vertices with {ae} out-edges"),
        # dist read and its lowered copy written; row_ids, neigh, gpos (int32)
        # and valid (bool) per slot; a weight per valid slot
        bytes=8 * gw.n + 13 * e_i + 4 * int(exp.valid.sum()), ops=2 * int(exp.valid.sum()),
        library=None,  # no single call: two gathers, an add and a scatter-min
    )
    return res


def phase_lcc_kernels(g, wplan, real_wedges, lcc_values, device):
    """K9 and K10 against their plain versions on the benchmark graph's
    wedge plan. Returns their results, K9's launches in its own drive and
    the sum of the LCC numerators."""
    import numpy as np
    import torch

    from graphtpu_torch.ops import kernels
    from graphtpu_torch.ops.edgehash import (
        _U32, _hash_rows, _probe_kernel, _probe_lanes, edgehash_probe, k9_bins, k9_partition_shift,
        k9_parts, pair_key_halves, probe_edge_hash_xy,
    )
    from graphtpu_torch.ops.triangles import (
        coefficients, lcc_oriented_numerator, numerator_from_credits, wedge_rowblock,
    )
    from graphtpu_torch.tools.wedge_bucket_times import closing_keys, wedge_work

    res = {}
    eh, id_bits = wplan.ehash, wplan.id_bits
    gen = torch.Generator(device=device).manual_seed(9)

    # K9 at 2^22 probes: half oriented edges of the plan (present), half
    # random pairs (all but a few absent), shuffled
    p = 1 << 22
    m = wplan.ex.shape[0]
    pick = torch.randint(0, m, (p // 2,), generator=gen, device=device)
    ex = torch.from_numpy(wplan.ex.astype(np.int32)).to(device)
    ey = torch.from_numpy(wplan.ey.astype(np.int32)).to(device)
    rand = torch.randint(0, g.n, (2, p // 2), generator=gen, device=device, dtype=torch.int32)
    order = torch.randperm(p, generator=gen, device=device)
    x = torch.cat([ex[pick], rand[0]])[order].contiguous()
    y = torch.cat([ey[pick], rand[1]])[order].contiguous()
    present = (order < p // 2)
    # the probes binned by partition of the table, each partition's probes
    # grouped by row in a block: a histogram, a scatter, the probe and the
    # unbin launch
    pshift = k9_partition_shift(eh.rows, p)
    check(k9_bins(eh.rows, p), f"{p} probes of a {eh.rows}-row table are not binned")
    print(f"K9 bins: partitions of 2^{pshift} rows ({(512 << pshift) / 2**10:.0f} KB), "
          f"{k9_parts(eh.rows, pshift)} partitions of the {eh.rows}-row table; the card's L2 "
          f"{torch.cuda.get_device_properties(device).L2_cache_size} bytes", flush=True)
    kernels.reset_launch_counts()
    found, pay = probe_edge_hash_xy(eh, x, y, id_bits)  # K9's own drive: no LCC path calls it
    k9_launches = kernels.launch_counts["edgehash_probe"]
    check(k9_launches == 4, f"edgehash_probe launched {k9_launches} times, expected 4 (the "
          f"histogram, the scatter, the probe and the unbin)")
    klo, khi = pair_key_halves(x, y, id_bits)
    want_found, want_pay = _probe_lanes(eh, klo, khi)
    again = edgehash_probe(eh, klo, khi)
    single = _probe_kernel(eh, klo, khi, None)  # the probe alone, in the caller's order
    check(torch.equal(found, want_found) and torch.equal(pay, want_pay),
          "edgehash_probe differs from its plain version")
    check(torch.equal(found, again[0]) and torch.equal(pay, again[1]),
          "edgehash_probe: two runs differ")
    check(torch.equal(found, single[0]) and torch.equal(pay, single[1]),
          "edgehash_probe: the single pass differs from the binned passes")
    check(bool(found[present].all()) and bool((pay[present] >= 1).all()),
          "edgehash_probe missed an edge of the plan")
    check(not bool(pay[~found].any()), "edgehash_probe gave a payload for an absent key")
    del want_found, want_pay, again, single
    h = _hash_rows(klo.long() & _U32, khi.long() & _U32, eh.rows)
    distinct = int(torch.unique(h).shape[0])
    k9_names = TRACE_KERNELS_OF["edgehash_probe"]
    call_ms = cuda_ms(lambda: edgehash_probe(eh, klo, khi))[0]
    single_ms = cuda_ms(lambda: _probe_kernel(eh, klo, khi, None))[0]
    print(f"kernel edgehash_probe: one call {call_ms:.6f} ms of device time (its torch scan "
          f"included); the probe alone over the caller's order (the design before the bins) "
          f"{single_ms:.6f} ms; a row fetched per probe would move {p * (512 + 8 + 5)} bytes, "
          f"{p * (512 + 8 + 5) / HBM_BYTES_PER_S * 1e3:.6f} ms", flush=True)
    res["edgehash_probe"] = dict(
        max_abs_err=0.0,
        times=(cuda_ms(lambda: edgehash_probe(eh, klo, khi), only=k9_names),
               cuda_ms(lambda: _probe_lanes(eh, klo, khi), reps=3)),
        call_ms=call_ms, single_pass_ms=single_ms,
        shape=(f"{p} probes of the benchmark graph's edge hash ({eh.rows} rows, "
               f"{eh.table.numel() * 4} bytes): {int(found.sum())} found, "
               f"{distinct} distinct rows"),
        # the table is an input read once: each distinct row probed, 512 B;
        # per probe the two key halves, found (1 B) and payload (4 B)
        bytes=distinct * 512 + p * (8 + 5), ops=p * 64 * 3,
        # what the binned design moves when each distinct row reaches the
        # card once: the rows; the keys read by the histogram and the
        # scatter, the bins (8 B) and places (4 B) it writes, the bins the
        # probe reads and its packed results (4 B), the places and results
        # the unbin reads and the results it writes (5 B)
        traffic=(distinct * 512 + p * (8 + 8 + 12 + 8 + 4 + 8 + 5),
                 "each distinct row fetched once, the keys, bins, places and results"),
        library=("torch.index_select of the rows alone",
                 lambda h=h: torch.index_select(eh.table, 0, h)),
    )

    # K10, bucket by bucket: kernel against plain, bit for bit, twice; the
    # plain pass is made once, timed with CUDA events, and its credits give
    # the plain path's numerators. The kernel searches the closing CSR; the
    # plain version probes the edge hash.
    closing = wplan.closing
    keys = closing_keys(wplan, device)
    check(torch.equal(keys >> id_bits, torch.repeat_interleave(
        torch.arange(g.n, device=device), closing.indptr.diff().long()))
          and torch.equal(keys & ((1 << id_bits) - 1), closing.ids.long()),
          "the closing CSR is not the hash's keys")
    buckets = []
    kernel_credits, plain_credits = [], []
    real_entries = reads = 0
    print(f"card before the K10 timings: {card_state()}", flush=True)
    for b in wplan.buckets:
        args = (b.slab, b.mslab, eh, id_bits, b.chunk_cols, closing)
        got = wedge_rowblock(*args)
        again = wedge_rowblock(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with kernels.plain_torch():
            start.record()
            want = wedge_rowblock(*args)
            end.record()
        torch.cuda.synchronize()
        w, r_pad = b.slab.shape
        what = f"wedge_rowblock bucket W={w} R_pad={r_pad}"
        for name, a, a2, c in zip(("u_cred", "edge_cred"), got, again, want):
            check(torch.equal(a, c), f"{what} {name} differs from its plain version")
            check(torch.equal(a, a2), f"{what} {name}: two runs differ")
        check(not bool(got[0][b.r_real:].any()), f"{what}: credits in pad rows")
        kernel_credits.append(got)
        plain_credits.append(want)
        entries, wedges, b_reads = wedge_work(b.slab, keys, id_bits)
        real_entries += entries
        reads += b_reads
        k_ms = cuda_ms(lambda: wedge_rowblock(*args), reps=3)[0]
        buckets.append(dict(W=w, R_pad=r_pad, rows=b.r_real, real_wedges=wedges,
                            list_reads=b_reads, ms=k_ms, plain_ms=start.elapsed_time(end)))
        print(f"kernel wedge_rowblock bucket W={w} R_pad={r_pad} ({b.r_real} rows, {wedges} "
              f"real wedges, {b_reads} out-list entries read): device {k_ms:.6f} ms "
              f"({wedges / k_ms / 1e6:.3f} G searches/s, {b_reads * 4 / 1e9:.3f} GB of lists "
              f"read, {b_reads * 4 / k_ms / 1e6:.3f} GB/s) vs plain "
              f"{buckets[-1]['plain_ms']:.3f} ms", flush=True)
    check(sum(bk["real_wedges"] for bk in buckets) == real_wedges, "real wedges by bucket")
    kernel_num = numerator_from_credits(wplan, kernel_credits)
    plain_num = numerator_from_credits(wplan, plain_credits)
    check(np.array_equal(kernel_num, plain_num), "lcc numerators differ, kernel vs plain path")
    check(np.array_equal(coefficients(kernel_num, wplan.deg_s), lcc_values),
          "the lcc path's coefficients are not those of these numerators")
    check(np.array_equal(lcc_oriented_numerator(wplan), kernel_num),
          "lcc numerators: two runs differ")
    num_sum = int(kernel_num.sum())
    print(f"real size: lcc numerators identical, kernel path vs plain path (sum {num_sum}, "
          f"{int((kernel_num > 0).sum())} vertices in a triangle; mean coefficient "
          f"{lcc_values.mean():.6f})", flush=True)
    del kernel_credits, plain_credits

    def all_buckets():
        for b in wplan.buckets:
            wedge_rowblock(b.slab, b.mslab, eh, id_bits, b.chunk_cols, closing)

    plain_ms = sum(bk["plain_ms"] for bk in buckets)
    # read once: the real slab and mslab entries, the closing CSR (ids and
    # multiplicities of every list, the indptr); written once: u_cred per
    # row and edge_cred per real entry
    rows = sum(b.r_real for b in wplan.buckets)
    small = real_entries * 8 + rows * 4 + real_entries * 4
    nbytes = small + closing.ids.numel() * 5 + closing.indptr.numel() * 4
    k10_times = cuda_ms(all_buckets, reps=3)
    print(f"card after the K10 timings: {card_state()}", flush=True)
    res["wedge_rowblock"] = dict(
        max_abs_err=0.0,
        times=(k10_times, (plain_ms, plain_ms)),
        shape=(f"all {len(wplan.buckets)} buckets of the benchmark graph's wedge plan (one LCC "
               f"run's wedge work): {real_wedges} real wedges, {real_entries} slab entries, "
               f"{rows} rows, {reads} out-list entries read, closing CSR of "
               f"{closing.ids.numel()} heads; plain version: one pass, CUDA events"),
        # merge steps: intersecting each entry's later entries (a) with out(x)
        # up to the row's largest id (b) takes a + b steps, summed: the
        # wedges plus the list entries read
        bytes=nbytes, ops=real_wedges + reads,
        library=None,  # no single call: pair enumeration, a search, three scatter-adds
        buckets=buckets,
        traffic=(reads * 4 + small,
                 "each out-list entry read from device memory for every entry that reads it"),
    )
    return res, k9_launches, num_sum


SPGEMM_SCALE = 14    # (a): small enough for the plain slab, the bench graph's edge factor
SPGEMM_SLOTS = 1 << 27  # padded slab slots per chunk of the plain pass at the bench size
# (a): a semiring per add monoid
SPGEMM_SEMIRINGS = ("plus.times", "min.plus", "max.second", "lor.land")


def plan_summary(plan):
    """K11's task lists of a plan, in words."""
    def entries(t):
        return int((t[:, 2] - t[:, 1]).sum()) if t.shape[0] else 0

    return (f"{plan.warp_tasks.shape[0]} warp rows ({entries(plan.warp_tasks)} mask entries), "
            f"{plan.block_tasks.shape[0]} block rows ({entries(plan.block_tasks)}), "
            f"{plan.win_tasks.shape[0]} column windows ({entries(plan.win_tasks)}); "
            f"{plan.launches} launches; mask "
            f"{'regrouped by row' if plan.idx is not None else 'in row order'}")


def plain_in_chunks(semiring, a, b, rows_h, cols_h):
    """K11's plain version over the mask in chunks of at most SPGEMM_SLOTS
    padded slab slots (the whole slab does not fit in device memory at the
    bench size): the same buckets, entry by entry, as one call."""
    import numpy as np
    import torch

    from graphtpu_torch.core.spgemm import _bucket_bounds, masked_spgemm_plain
    from graphtpu_torch.ops import kernels

    a_ip = a.indptr.cpu().numpy()
    deg = np.diff(a_ip)[rows_h]
    bounds = np.array(_bucket_bounds(int(np.diff(a_ip).max())))
    slots = np.cumsum(bounds[np.searchsorted(bounds, deg)])
    cuts = np.searchsorted(slots, np.arange(SPGEMM_SLOTS, slots[-1] + SPGEMM_SLOTS, SPGEMM_SLOTS))
    edges = np.unique(np.concatenate([[0], np.minimum(cuts, rows_h.size), [rows_h.size]]))
    with kernels.plain_torch():
        parts = [masked_spgemm_plain(semiring, a, b, rows_h[lo:hi], cols_h[lo:hi],
                                     a_indptr_host=a_ip) for lo, hi in zip(edges[:-1], edges[1:])]
    return torch.cat(parts), len(parts)


def phase_spgemm(g, num_sum, device):
    """K11 masked_spgemm. (a) Against its plain version on the card, for each
    add monoid and each value type, on RMAT scale SPGEMM_SCALE (the bench
    graph's edge factor): A = its oriented structure U with values, B = its
    stored CSR with values (rows longer than A's), the mask = every stored
    edge. (b) One call at the bench graph's size: C<U> = U.U under plus.pair,
    whose sum over the mask is the triangle count, a sixth of the LCC
    numerators' sum; against one pass of its plain version in chunks.
    Returns K11's result and its launches in (b)."""
    import numpy as np
    import torch

    from graphtpu_torch.core.semiring import BY_NAME, PLUS_PAIR
    from graphtpu_torch.core.spgemm import (
        CSR, masked_spgemm, masked_spgemm_rows, plan_masked_spgemm,
    )
    from graphtpu_torch.ops import kernels
    from graphtpu_torch.ops.spmv import int32_tensor
    from graphtpu_torch.tools.spgemm_times import oriented_csr, spgemm_work
    from graphtpu_torch.utils.synth import rmat_graph

    gen = torch.Generator(device=device).manual_seed(11)
    small = rmat_graph(SPGEMM_SCALE, 32, directed=False, seed=42)
    u, sym, su_rows, su_cols = oriented_csr(small, device)
    # the mask: every stored edge (rows in sorted order, cols = S's columns)
    mrows, mcols = int32_tensor(small.src, device), sym.col
    rows_h, cols_h = small.src.astype(np.int32), small.dst.astype(np.int32)

    def values(n, dtype, name):
        if name == "lor.land":
            return torch.randint(0, 2, (n,), generator=gen, device=device).to(dtype)
        if dtype == torch.int32:
            return torch.randint(1, 10, (n,), generator=gen, device=device, dtype=torch.int32)
        return (torch.rand(n, generator=gen, device=device, dtype=dtype) * 4 + 0.5)

    worst = 0.0
    plan = plan_masked_spgemm(u, sym, mrows, mcols)
    print(f"masked_spgemm plan on RMAT s{SPGEMM_SCALE}/ef32 (mask: every stored edge): "
          f"{plan_summary(plan)}", flush=True)
    check(plan.launches == 3, "the s14 mask does not reach all three task lists")
    for name in SPGEMM_SEMIRINGS:
        for vt in (torch.float32, torch.float64, torch.int32, None):
            a = CSR(u.indptr, u.col, None if vt is None else values(u.col.numel(), vt, name))
            b = CSR(sym.indptr, sym.col, None if vt is None else values(sym.col.numel(), vt, name))
            before = kernels.launch_counts["masked_spgemm"]
            got = masked_spgemm_rows(BY_NAME[name], a, b, mrows, mcols)
            check(kernels.launch_counts["masked_spgemm"] == before + plan.launches,
                  f"masked_spgemm {name}: one call did not count its plan's "
                  f"{plan.launches} launches")
            what = f"masked_spgemm {name} {vt or 'structural'} (RMAT s{SPGEMM_SCALE}/ef32)"
            check(torch.equal(got, masked_spgemm_rows(BY_NAME[name], a, b, mrows, mcols)),
                  f"{what}: two calls differ")
            with kernels.plain_torch():
                want = masked_spgemm(BY_NAME[name], a, b, rows_h, cols_h)
            check(got.dtype == want.dtype and got.shape == want.shape, f"{what}: dtype or shape")
            if name.startswith("plus") and got.dtype.is_floating_point and vt is not None:
                rtol = F32_SUM_RTOL if got.dtype == torch.float32 else F64_SUM_RTOL
                rel = float(((got.double() - want.double()).abs() / want.double().abs()
                             .clamp(min=1e-300)).max())
                check(rel <= rtol, f"{what}: relative error {rel} > {rtol}")
            else:
                check(torch.equal(got, want), f"{what} differs from its plain version")
            worst = max(worst, max_abs_err(got, want))
            ident = BY_NAME[name].add.identity(got.dtype)
            check(int((got != ident).sum()) > 0, f"{what}: no mask entry is reached")
    print(f"masked_spgemm = plain on RMAT s{SPGEMM_SCALE}/ef32 ({small.nnz} mask entries, A = U "
          f"{u.col.numel()} entries, B {sym.col.numel()}), semirings {SPGEMM_SEMIRINGS} x float32, "
          f"float64, int32, structural (plus over floats within {F32_SUM_RTOL} / {F64_SUM_RTOL} "
          f"relative; max abs err {worst:.3e}); two calls equal", flush=True)
    s_terms, s_steps, s_reads = spgemm_work(u, u, su_rows)
    with kernels.plain_torch():
        s_plain = cuda_ms(lambda: masked_spgemm(PLUS_PAIR, u, u, su_rows.cpu().numpy(),
                                                su_cols.cpu().numpy()), reps=3)
    small_shape = dict(
        shape=(f"C<U> = U.U plus.pair on RMAT s{SPGEMM_SCALE}/ef32: {su_rows.numel()} mask "
               f"entries, {s_terms} terms, {s_steps} search steps, {s_reads} row-wise reads; "
               f"K11's launches alone"),
        times=(cuda_ms(lambda: masked_spgemm_rows(PLUS_PAIR, u, u, su_rows, su_cols),
                       only=TRACE_KERNELS_OF["masked_spgemm"]), s_plain),
        bytes=su_rows.numel() * 12 + u.indptr.numel() * 4 + u.col.numel() * 4,
        ops=min(s_steps, 2 * s_reads))
    del u, sym, mrows, mcols, su_rows, su_cols

    # (b) the bench graph
    u, _, rows, cols = oriented_csr(g, device)
    terms, steps, reads = spgemm_work(u, u, rows)
    m = rows.numel()
    plan = plan_masked_spgemm(u, u, rows, cols)
    check(plan.idx is None, "U's entries are sorted by row: the plan should keep their order")
    print(f"masked_spgemm plan on {BENCH_GRAPH} (mask: U): {plan_summary(plan)}", flush=True)
    del plan
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = masked_spgemm_rows(PLUS_PAIR, u, u, rows, cols)
    torch.cuda.synchronize()
    one_call = time.perf_counter() - t0
    launches = kernels.launch_counts["masked_spgemm"]
    stated = plan_masked_spgemm(u, u, rows, cols).launches
    check(launches == stated, f"masked_spgemm launched {launches} times in one call; its plan "
          f"states {stated}")
    check(one_call < 60, f"one masked_spgemm call at the bench size took {one_call:.1f} s")
    check(got.dtype == torch.float32 and got.shape == (m,) and bool(torch.isfinite(got).all()),
          "masked_spgemm at the bench size: dtype, shape or a value not finite")
    triangles = int(got.double().sum())  # every value a count below 2^24: exact
    check(triangles * 6 == num_sum,
          f"C<U> = U.U sums to {triangles} triangles; the LCC numerators give {num_sum} / 6")
    check(torch.equal(got, masked_spgemm_rows(PLUS_PAIR, u, u, rows, cols)),
          "masked_spgemm: two runs differ")
    k11_call = lambda: masked_spgemm_rows(PLUS_PAIR, u, u, rows, cols)  # noqa: E731
    k11_times = cuda_ms(k11_call, reps=3, only=TRACE_KERNELS_OF["masked_spgemm"])
    call_ms = cuda_ms(k11_call, reps=3)[0]
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k11_call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    call_wall_ms = sorted(walls)[1]
    # the plain pass last: profiler traces taken after it lost records
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    rows_h, cols_h = rows.cpu().numpy(), cols.cpu().numpy()
    start.record()
    want, chunks = plain_in_chunks(PLUS_PAIR, u, u, rows_h, cols_h)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    check(torch.equal(got, want), "masked_spgemm differs from its plain version at the bench size")
    del want
    torch.cuda.empty_cache()
    print(f"masked_spgemm C<U> = U.U (plus.pair) on {BENCH_GRAPH}: {m} mask entries, {terms} "
          f"terms, {steps} search steps (the first design's operations), {reads} row-wise reads "
          f"and as many lookups (this design's: {2 * reads}); first call {one_call:.3f} s, "
          f"{launches} launches; a call {call_ms:.6f} ms of device time (planning included), "
          f"{call_wall_ms:.3f} ms of wall time; sum {triangles} triangles = the LCC numerators' "
          f"{num_sum} / 6; identical to one pass of the plain version in {chunks} chunks "
          f"({plain_ms:.3f} ms)", flush=True)
    res = dict(
        max_abs_err=0.0,
        times=(k11_times, (plain_ms, plain_ms)),
        shape=(f"C<U> = U.U plus.pair over the bench graph's degree-oriented structure: {m} "
               f"mask entries, {terms} terms, {steps} search steps, {reads} row-wise reads; "
               f"K11's {launches} launches alone; plain version: one pass in {chunks} chunks, "
               f"CUDA events"),
        call_ms=call_ms, call_wall_ms=call_wall_ms,
        # read once: the mask (rows, cols), U's indptr and columns (A and B
        # are one CSR); written once: a float32 per mask entry. Operations:
        # the lesser of the two designs' counts, the search steps of one
        # search per term or a read and a lookup per row-wise B entry
        bytes=m * 12 + u.indptr.numel() * 4 + u.col.numel() * 4, ops=min(steps, 2 * reads),
        ops_by_design={"search per term": steps, "row-wise read and lookup": 2 * reads},
        library=None,  # none: torch has no masked SpGEMM (sampled_addmm takes dense factors)
        other_shapes=[small_shape],
    )
    return {"masked_spgemm": res}, launches


def report_kernel(name, r, empty_ms):
    """Complete kernel ``name``'s result ``r`` with its times, bound and
    library call's time (measured now), and print them."""
    for o in r.get("other_shapes", ()):
        (o["ms"], _), (o["plain_ms"], _) = o.pop("times")
        o["bound_ms"], o["bound_by"] = bound_ms(o["bytes"], o.pop("ops"), empty_ms)
        print(f"kernel {name} ({o['shape']}): device {o['ms']:.6f} ms vs plain "
              f"{o['plain_ms']:.6f} ms; bound {o['bound_ms']:.6f} ms by {o['bound_by']} "
              f"({o['bytes']} bytes): {100 * o['bound_ms'] / o['ms']:.1f} % of it",
              flush=True)
    (k_dev, k_stream), (p_dev, p_stream) = r["times"]
    r["ms"], r["plain_ms"] = k_dev, p_dev
    r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["ops"], empty_ms)
    r["library_ms"], lib = None, "library call: none"
    if r["library"] is not None:
        lib_name, lib_fn = r["library"]
        r["library_ms"] = cuda_ms(lib_fn, reps=100 if name == "vreg_shuffle" else 10)[0]
        lib = f"library call ({lib_name}) {r['library_ms']:.6f} ms"
    print(f"kernel {name} ({r['shape']}): device {k_dev:.6f} ms vs plain {p_dev:.6f} ms; "
          f"stream span {k_stream:.6f} ms vs plain {p_stream:.6f} ms; "
          f"max abs err {r['max_abs_err']:.3e}; bound {r['bound_ms']:.6f} ms by "
          f"{r['bound_by']} ({r['bytes']} bytes at {HBM_BYTES_PER_S / 1e12} TB/s, "
          f"{r['ops']} operations at {F32_OPS_PER_S / 1e12} Tops/s, both published): "
          f"{100 * r['bound_ms'] / k_dev:.1f} % of it; {lib}", flush=True)
    for design, ops in r.get("ops_by_design", {}).items():
        print(f"kernel {name}: {ops} operations by the {design} design, a bound of "
              f"{ops / F32_OPS_PER_S * 1e3:.6f} ms; the kernel takes "
              f"{100 * ops / F32_OPS_PER_S * 1e3 / k_dev:.1f} % of it", flush=True)
    if "call_ms" in r:
        print(f"kernel {name}: a whole call {r['call_ms']:.6f} ms of device time"
              + (f", {r['call_wall_ms']:.3f} ms of wall time (planning included)"
                 if "call_wall_ms" in r else "")
              + (f"; the single pass {r['single_pass_ms']:.6f} ms" if "single_pass_ms" in r
                 else ""), flush=True)
    if "traffic" in r:
        traffic, how = r.pop("traffic")
        r["traffic_ms"] = traffic / HBM_BYTES_PER_S * 1e3
        print(f"kernel {name}: {how} would move {traffic} bytes, {r['traffic_ms']:.6f} ms at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s (the design's traffic, no bound: what many "
              f"read need not move twice); the kernel takes "
              f"{100 * k_dev / r['traffic_ms']:.1f} % of that", flush=True)


SOURCES = {
    "gather_rows": ("graphtpu_torch/csrc/gather_rows.cu", "graphtpu/ops/pallas_gather.py:95"),
    "slab_minmode": ("graphtpu_torch/csrc/slab_minmode.cu", "graphtpu/ops/minmode.py:55"),
    "slab_spmv_sum": ("graphtpu_torch/csrc/slab_spmv.cu", "graphtpu/ops/spmv.py:82"),
    "vreg_shuffle": ("graphtpu_torch/csrc/vreg_shuffle.cu", "graphtpu/ops/pallas_gather.py:69"),
    "frontier_expand": ("graphtpu_torch/csrc/frontier_expand.cu", "graphtpu/ops/frontier.py:103"),
    "slab_spmv_min": ("graphtpu_torch/csrc/slab_spmv.cu", "graphtpu/ops/spmv.py:82"),
    "csr_pull_reduce": ("graphtpu_torch/csrc/csr_pull_reduce.cu", "graphtpu/algorithms/sssp.py:72"),
    "csr_pull_reduce_sum": ("graphtpu_torch/csrc/csr_pull_reduce.cu",
                            "graphtpu/algorithms/pr.py:71"),
    "push_relax_min": ("graphtpu_torch/csrc/push_relax.cu", "graphtpu/algorithms/sssp.py:140"),
    "edgehash_probe": ("graphtpu_torch/csrc/edgehash_probe.cu", "graphtpu/ops/edgehash.py:159"),
    "wedge_rowblock": ("graphtpu_torch/csrc/wedge_rowblock.cu", "graphtpu/ops/triangles.py:555"),
    "masked_spgemm": ("graphtpu_torch/csrc/masked_spgemm.cu", "graphtpu/core/spgemm.py:146"),
}


def main() -> int:
    t_start = time.perf_counter()
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
    from graphtpu_torch.ingest import native

    check(native.available(), "the native ingest library is off (no C++ compiler?)")
    built = (f"built in {native.build_seconds:.3f}s" if native.build_seconds is not None
             else "already built")
    print(f"native ingest library: {native.library_path().name} {built}", flush=True)

    phase_goldens(device)
    t0 = time.perf_counter()
    phase_harness(device)
    print(f"harness phase: {time.perf_counter() - t0:.3f} s", flush=True)
    g, gw, prep, pr_plan, (wplan, real_wedges, lcc_values), path_launches, real_steps = \
        phase_real_size(device)
    for path, (_, _, needed) in PATHS.items():
        per_run = {k: v / RUNS_PER_PATH for k, v in path_launches[path].items() if v}
        print(f"launches on path {path} ({RUNS_PER_PATH} runs): {path_launches[path]}; per run: "
              f"{per_run}", flush=True)
        for name in needed:
            check(path_launches[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path")
    scan = {k: v for k, v in path_launches["pr-scan"].items() if v}
    check(scan == {"csr_pull_reduce_sum": RUNS_PER_PATH * PR_ITERS},
          f"pr-scan launched {scan} in {RUNS_PER_PATH} runs, expected K7 sum {PR_ITERS} a run "
          f"and nothing else")
    k10 = path_launches["lcc"]["wedge_rowblock"]
    check(k10 == RUNS_PER_PATH * len(wplan.buckets),
          f"wedge_rowblock launched {k10} times in {RUNS_PER_PATH} lcc runs, expected one per "
          f"bucket ({len(wplan.buckets)})")
    launches = {name: sum(c[name] for c in path_launches.values()) for name in kernels.COUNTERS}
    launches["vreg_shuffle"] = phase_vreg_shuffle(device)
    print(f"peak device memory allocated {torch.cuda.max_memory_allocated(device) / 2**30:.3f} "
          f"GiB", flush=True)
    res = phase_kernels(g, prep, pr_plan, device)
    res.update(phase_traversal_kernels(g, gw, device))
    lcc_res, launches["edgehash_probe"], num_sum = phase_lcc_kernels(
        g, wplan, real_wedges, lcc_values, device)
    res.update(lcc_res)
    empty_ms = cuda_ms(lambda: kernels.launch_empty(device), reps=100, empty_kernel=True)[0]
    print(f"kernel that returns at once (one block of one thread): device {empty_ms:.6f} ms, "
          f"the floor under the launch-sized rows", flush=True)
    for name, r in res.items():
        report_kernel(name, r, empty_ms)
    # after the other kernels' timings: in a run where K11's phase came
    # first, every profiler trace taken after its chunked plain pass lost
    # records
    t0 = time.perf_counter()
    spgemm_res, launches["masked_spgemm"] = phase_spgemm(g, num_sum, device)
    print(f"spgemm phase: {time.perf_counter() - t0:.3f} s", flush=True)
    for name, r in spgemm_res.items():
        report_kernel(name, r, empty_ms)
    res.update(spgemm_res)
    t0 = time.perf_counter()
    ingest = phase_ingest(g, gw, smi)
    print(f"ingest phase: {time.perf_counter() - t0:.3f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench = phase_bench(smi, real_steps, int((lcc_values > 0).sum()))
    print(f"bench phase: {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    parallel = phase_parallel(g, gw, device, smi, real_steps)
    print(f"parallel phase: {time.perf_counter() - t0:.3f} s", flush=True)
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
         "plain_ms": res[name]["plain_ms"], "bound_ms": res[name]["bound_ms"],
         "bound_by": res[name]["bound_by"], "bytes": res[name]["bytes"],
         "library_ms": res[name]["library_ms"],
         "other_shapes": res[name].get("other_shapes", []),
         **{k: res[name][k] for k in ("buckets", "traffic_ms", "call_ms", "call_wall_ms",
                                      "single_pass_ms", "ops_by_design") if k in res[name]}}
        for name in kernels.COUNTERS
    ], "empty_kernel_ms": empty_ms, "ingest": ingest, "bench": bench, "parallel": parallel}
    print(f"chip_smoke total: {time.perf_counter() - t_start:.3f} s", flush=True)
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
