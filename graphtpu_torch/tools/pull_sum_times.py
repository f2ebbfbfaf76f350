#!/usr/bin/env python3
"""K7 in mode sum (PageRank's pull) on its sliced pull and on the merge path,
and K8's int32 mode, on one CUDA card.

    python3 graphtpu_torch/tools/pull_sum_times.py [--root CHECKOUT] [--tag NAME]
        [--variants DEFINES;DEFINES...] [--out FILE]

Takes the pull CSR of the benchmark graph (RMAT scale 20, edge factor 32,
undirected, seed 42; cached under intermediate/ of the checkout that holds
this script) and the heavy rows of its PageRank slab plan, x like
PageRank's contributions, and prints device us per call (the profiler's
device time) beside the bytes bound of each design's own inputs (each read
once, each output written once, over the card's published 3.35 TB/s):

* the sliced pull (``build_pull_slices``) at two slice widths: the
  kernel's (49,152 float32 entries, 24,576 float64) and two thirds of it
  (32,768, 16,384), each layout's build seconds, bytes, runs and tiles,
  and the device us of each of its three kernels (pass 1, the carries'
  fixup, pass 2), and which design the path's rule (``SLICE_RUN_EDGES``)
  takes there;
  float32 and float64 on the full CSR, float32 on the heavy rows and per
  in-degree class (0; 1-4; 5-32; 33-256; 257-4,096; above 4,096), each
  class a CSR of its own;
* the merge-path design (K7's mode 4/5, what mode sum ran on before, and
  where the runs are short still does) at the same shapes;
* ``--variants``: builds of the kernel with other K7S_THREADS, or with a
  K7S_PROBE that leaves a part of pass 1 out (csrc/csr_pull_reduce.cu:
  wrong sums, timed all the same), each ``NAME=VALUE,NAME=VALUE``, builds
  separated by ``;``, on the full CSR in float32, with layouts built to
  their tiles, timed by CUDA events (stream us a call, launch gaps in),
  beside the path's build timed the same way;
* K8 in its int32 mode at the distributed WCC's active step (160 real
  slots of 2^18, into 2^20 labels), fed the real-slot count, or the mask
  where the version's wrapper takes one;
* a kernel that returns at once.

``--root`` names another checkout whose ``graphtpu_torch`` is timed
instead (a version without the sliced pull is timed through its
``csr_pull_reduce``), so that two versions run in one call on one card.
``--out`` also writes the table to a file.
"""

from __future__ import annotations

import argparse
import runpy
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
BENCH_GRAPH = "bench-rmat-s20-ef32"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
WIDTHS = {4: (49152, 32768), 8: (24576, 16384)}

# device ms per call from traces whose record counts are whole, and the
# per-class sub-CSRs; loaded by path, as --root may make graphtpu_torch
# another checkout's
device_ms = runpy.run_path(str(Path(__file__).with_name("trace_times.py")))["device_ms"]
_rows = runpy.run_path(str(Path(__file__).with_name("csr_row_times.py")))
sub_csr, CLASSES, Progress = _rows["sub_csr"], _rows["CLASSES"], _rows["Progress"]


def event_ms(fn, reps=20):
    """Stream ms per call of fn() between two CUDA events, after a warm-up
    (launch gaps included)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def csr_bytes(rows, edges, n_x, itemsize):
    """The merge path's: indptr, src, the entries of x the edges reach, y."""
    return 4 * (rows + 1) + 4 * edges + itemsize * n_x + itemsize * rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--variants", default="", help="other builds: NAME=V,NAME=V;...")
    ap.add_argument("--out", default=None, help="also write the table to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("pull_sum_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.algorithms.pr import _pull_plan_cached
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.ops import kernels, spmv
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
    n = g.n
    sliced = hasattr(spmv, "build_pull_slices")
    lines = Progress()
    lines.append(f"card: {smi}; version {args.tag} ({args.root}, "
                 f"{'sliced pull' if sliced else 'merge path only'}); graph {BENCH_GRAPH} "
                 f"(n={n}, {g.nnz} stored edges)")
    lines.append(f"empty kernel: {device_ms(lambda: kernels.launch_empty(device), 100) * 1e3:.1f} "
                 f"us")

    pull = spmv.pull_csr(g, device)
    plan = _pull_plan_cached(g, torch.float32, device)
    heavy = spmv.PullCSR(plan.heavy_neigh, plan.heavy_indptr)
    gen = torch.Generator(device=device).manual_seed(0)
    x32 = torch.rand(n, generator=gen, device=device) / n
    deg = pull.indptr.diff()
    shapes = [("full", pull, x32), ("full", pull, x32.double()), ("heavy", heavy, x32)]
    for lo, hi in CLASSES:
        in_class = (deg >= lo) if hi is None else (deg >= lo) & (deg <= hi)
        rows = in_class.nonzero().reshape(-1)
        name = f"class {lo}+" if hi is None else (f"class {lo}" if lo == hi else
                                                  f"class {lo}-{hi}")
        ip, s, _ = sub_csr(pull.indptr, pull.src, None, rows)
        shapes.append((name, spmv.PullCSR(s, ip), x32))

    lines.append("sum: shape dtype rows edges design width runs tiles layout_bytes build_s "
                 "device_us bound_us")
    for name, csr, x in shapes:
        rows, edges, item = csr.indptr.shape[0] - 1, csr.src.shape[0], x.element_size()
        dname = str(x.dtype).replace("torch.", "")
        n_x = int(csr.src.max()) + 1 if edges else 0
        head = f"sum: {name} {dname} {rows} {edges}"
        code = spmv.CSR_MODES["sum"][0][x.dtype]
        ms = device_ms(lambda: spmv._csr_pull_reduce_launch(code, x.dtype, x, csr.src,
                                                            csr.indptr, None))
        lines.append(f"{head} merge-path - - - - - {ms * 1e3:.1f} "
                     f"{csr_bytes(rows, edges, n_x, item) / HBM_BYTES_PER_S * 1e6:.1f}")
        if not sliced:
            ms = device_ms(lambda: spmv.csr_pull_reduce("sum", x, csr.src, csr.indptr))
            lines.append(f"{head} csr_pull_reduce - - - - - {ms * 1e3:.1f} -")
            continue
        for width in WIDTHS[item]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sl = spmv.build_pull_slices(csr.src, csr.indptr, item, width)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            want = spmv.csr_pull_reduce_plain("sum", x, csr.src, csr.indptr)
            # the sliced kernel itself, whichever design the path's rule picks
            call = lambda: spmv._pull_slices_launch(x, sl, rows, edges)  # noqa: E731
            got = call()
            rtol = 1e-5 if item == 4 else 1e-12
            if not bool(((got.double() - want.double()).abs()
                         <= rtol * want.double().abs()).all()):
                raise SystemExit(f"pull_sum_times: the sliced sum of {name} {dname} at width "
                                 f"{width} differs from the plain version")
            ms = device_ms(call)
            path = "sliced" if sl.runs * spmv.SLICE_RUN_EDGES <= sl.edges else "merge-path"
            kinds = ("k7_reduce_sliced", "k7_fixup", "k7_fold_slices")
            passes = "/".join(f"{device_ms(call, only=(k,)) * 1e3:.1f}" if edges else "-"
                              for k in kinds)
            lines.append(f"{head} sliced {width} {sl.runs} "
                         f"{sl.tile_slice.shape[0]} {sl.nbytes()} {took:.3f} {ms * 1e3:.1f} "
                         f"{sl.moved_bytes() / HBM_BYTES_PER_S * 1e6:.1f} (passes "
                         f"{passes}; the path takes {path})")
            del sl, got, want
    if sliced and args.variants:
        sl = spmv.build_pull_slices(pull.src, pull.indptr, 4)
        ms = event_ms(lambda: spmv._pull_slices_launch(x32, sl, n, pull.src.shape[0]))
        lines.append(f"sum: full float32 {n} {pull.src.shape[0]} path-build(events) {sl.width} "
                     f"{sl.runs} {sl.tile_slice.shape[0]} {sl.nbytes()} - {ms * 1e3:.1f} "
                     f"{sl.moved_bytes() / HBM_BYTES_PER_S * 1e6:.1f}")
        del sl
    for spec in filter(None, args.variants.split(";")):
        if not sliced:
            break
        defines = tuple(d.strip() for d in spec.split(","))
        vals = dict(d.split("=") for d in defines)
        items = int(vals.get("K7S_THREADS", 512)) * spmv.SLICE_GROUP
        lib = kernels.library(defines)
        sl = spmv.build_pull_slices(pull.src, pull.indptr, 4, items=items)
        call_args, y, keep = spmv.pull_slices_args(x32, sl, n, pull.src.shape[0])

        def call():
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.gt_csr_pull_slices(*call_args, stream)
            if rc:
                raise RuntimeError(f"variant {spec}: error {rc} "
                                   f"({lib.gt_error_string(rc).decode()})")

        try:
            call()
            want = spmv.csr_pull_reduce_plain("sum", x32, pull.src, pull.indptr)
            ok = bool(((y.double() - want.double()).abs() <= 1e-5 * want.double().abs()).all())
            # a probe's sums are wrong by design: timed all the same, by CUDA
            # events (the profiler loses records of calls into a second library)
            took = f"{event_ms(call) * 1e3:.1f}" if ok or "K7S_PROBE" in vals else "differs"
        except RuntimeError as err:
            took = f"refused({str(err).split('(')[-1].rstrip(')').replace(' ', '_')})"
        lines.append(f"sum: full float32 {n} {pull.src.shape[0]} variant[{spec}] {sl.width} "
                     f"{sl.runs} {sl.tile_slice.shape[0]} {sl.nbytes()} - {took} "
                     f"{sl.moved_bytes() / HBM_BYTES_PER_S * 1e6:.1f}")
        del sl, y, keep
    # K8's int32 mode at the distributed WCC's active step: 160 real slots of
    # 2^18 into 2^20 labels (the real ones a prefix, as an expansion fills
    # them); a version whose wrapper takes a mask gets slot < 160
    import inspect

    from graphtpu_torch.ops.frontier import relax_min_i32

    e_cap, real = 1 << 18, 160
    labels = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    row_ids = torch.randint(0, n, (e_cap,), generator=gen, device=device, dtype=torch.int32)
    neigh = torch.randint(0, n, (e_cap,), generator=gen, device=device, dtype=torch.int32)
    takes_total = "total" in inspect.signature(relax_min_i32).parameters
    real_slots = (torch.tensor(real, dtype=torch.int32, device=device) if takes_total
                  else torch.arange(e_cap, device=device) < real)
    ms = device_ms(lambda: relax_min_i32(n, labels, row_ids, neigh, real_slots))
    # the real-slot count or the mask, and per real slot row_ids, neigh and a label;
    # the INT32_INF fill of the n labels written
    nbytes = (4 if takes_total else e_cap) + 12 * real + 4 * n
    lines.append(f"k8: min_i32 {e_cap} slots {real} real into {n} labels "
                 f"({'total' if takes_total else 'valid mask'}) {ms * 1e3:.2f} us, bound "
                 f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f} us")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
