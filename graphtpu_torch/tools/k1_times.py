#!/usr/bin/env python3
"""K1 ``gather_rows`` against its plain version and ``torch.index_select``
at the CDLP assembly gather's shape, on one CUDA card, measured three ways,
before and after a device sort of a 60.7M-edge stream.

    python3 graphtpu_torch/tools/k1_times.py [--reps 10] [--traces 5]

The shape is chip_smoke.py's K1 row: a table of 2^20 int32 labels gathered
by 2^20 int32 indices (a random permutation here, the plan's ``inv_perm``
there). The plain version and the library call are the same call
(``index_select``), so they must agree. Each is measured

* by the profiler, as chip_smoke.py's ``cuda_ms`` does: ``--traces`` traces
  of ``--reps`` calls, each led by the kernel that returns at once, and as
  many again that also end with it. Every trace prints each device
  record's name, its count and its mean us: a trace that lost records
  shows as a count that is not a multiple of ``--reps``;
* by CUDA events around a CUDA graph of ``--reps`` calls, replayed 20
  times: the device time per call plus the gaps between the graph's
  kernels;
* by CUDA events around 1000 calls launched one after another: the
  stream's time per call, which the host's launch rate bounds.

Then it sorts a stream of 60,685,550 random edges over 2^20 vertices on the
card (``graphtpu_torch.core.graph._device_sort_edges``, about 3 GiB of
device memory at its peak) and measures all three again.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
N = 1 << 20
SORT_EDGES = 60_685_550


def on_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).endswith("CUDA")


def traces(fn, reps, count, trailing, device):
    """One line per trace: (device us per call over reps, whether every
    record's count is a multiple of reps, the records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphtpu_torch.ops import kernels

    out = []
    for _ in range(count):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kernels.launch_empty(device)
            for _ in range(reps):
                fn()
            if trailing:
                kernels.launch_empty(device)
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
                if on_device(e) and e.self_device_time_total > 0]
        timed = [r for r in rows if "empty_kernel" not in r[0]]
        whole = all(c % reps == 0 for _, c, _ in timed) and bool(timed)
        out.append((sum(t for _, _, t in timed) / reps, whole, rows))
    return out


def graph_ms(fn, reps):
    """ms per call from CUDA events around a captured graph of reps calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (20 * reps)


def stream_ms(fn, calls=1000):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10, help="calls per trace and per graph")
    ap.add_argument("--traces", type=int, default=5, help="profiler traces per variant")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_times: needs a CUDA card")
    sys.path.insert(0, str(HERE))
    from graphtpu_torch.core import graph as graph_mod
    from graphtpu_torch.ops import kernels
    from graphtpu_torch.ops.gather import gather_rows, gather_rows_plain

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    kernels.build()
    kernels.library()
    device = torch.device("cuda:0")
    gen = torch.Generator(device=device).manual_seed(0)
    labels = torch.arange(N, dtype=torch.int32, device=device)
    idx = torch.randperm(N, generator=gen, device=device).to(torch.int32)
    calls = {
        "K1 gather_rows": lambda: gather_rows(labels, idx),
        "plain (index_select)": lambda: gather_rows_plain(labels, idx),
        "library torch.index_select": lambda: torch.index_select(labels, 0, idx),
    }
    if not torch.equal(calls["K1 gather_rows"](), calls["library torch.index_select"]()):
        raise SystemExit("k1_times: K1 differs from index_select")
    bound_us = 4 * 3 * N / 3.35e12 * 1e6
    print(f"shape: table {N} int32, {N} indices; bytes bound {bound_us:.3f} us at 3.35 TB/s",
          flush=True)

    def measure(when):
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            for trailing in (False, True):
                ends = "at both ends" if trailing else "leading"
                for i, (us, whole, rows) in enumerate(
                        traces(fn, args.reps, args.traces, trailing, device)):
                    recs = "; ".join(f"{k[:48]} x{c} mean {t / c:.3f} us" for k, c, t in rows)
                    lost = "all records" if whole else "RECORDS LOST"
                    print(f"[{when}] {name} trace {i} (empty kernel {ends}): {us:.3f} us per "
                          f"call, {lost}: {recs}", flush=True)
            g_us, s_us = 1e3 * graph_ms(fn, args.reps), 1e3 * stream_ms(fn)
            print(f"[{when}] {name}: CUDA graph of {args.reps} calls {g_us:.3f} us per call; "
                  f"eager stream {s_us:.3f} us per call ({smi})", flush=True)

    measure("before the sort")
    rng = np.random.default_rng(1)
    src = rng.integers(0, N, SORT_EDGES, dtype=np.int32)
    dst = rng.integers(0, N, SORT_EDGES, dtype=np.int32)
    torch.cuda.reset_peak_memory_stats()
    out = graph_mod._device_sort_edges(src, dst, None, "src", True)
    if out is None:
        raise SystemExit("k1_times: the device sort declined")
    print(f"device sort of {SORT_EDGES} edges: {graph_mod.last_device_sort}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({smi})", flush=True)
    del out, src, dst
    measure("after the sort")
    return 0


if __name__ == "__main__":
    sys.exit(main())
