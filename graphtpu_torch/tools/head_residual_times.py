#!/usr/bin/env python3
"""LCC's head-credit sums (K16 against K7 ``sum_i64``) and BFS's residual
test (K17 against K7 ``max_i32``) on one CUDA card.

    python3 graphtpu_torch/tools/head_residual_times.py [--root CHECKOUT] [--tag NAME]
        [--out FILE]

Takes the benchmark graph (RMAT scale 20, edge factor 32, undirected, seed
42; cached under intermediate/ of the checkout that holds this script), its
wedge plan and K10's credits of every bucket, and BFS auto's bottom-up
residual tests from vertex 0 (taken from a run), and prints device us per
call (the profiler's device time), stream us per call between two CUDA
events (launch gaps included) and the device records (kernels, memsets,
copies) a call makes:

* K16 ``lcc_head_credits`` (the path's build) against K7 ``sum_i64`` over
  the plan's head order (``_aggregate_heads``), the kernels alone, then
  the whole aggregation, old (the ``torch.cat`` of the credit slabs, K7,
  the apex credits' cat and indexed add) against new (one K16 call);
  then builds of K16 with other windows (K16_HUBS 16,384, 8,192, 28,672,
  and 0: every head a global atomic; the path's is 24,576) and a probe
  that adds nothing (K16_PROBE=1: wrong sums, the stream's time) beside
  the path's build, each twice, timed by CUDA events in turns (the
  profiler loses records of calls into a second library); the bound (each
  real entry's head and credit read once, each apex row's id and credit,
  num written once) and one ``index_add_`` of pre-widened int64 credits by
  head, the yardstick;
* K17 ``residual_claim`` against K7 ``max_i32`` over the clamped row
  starts (``residual_hits``' launch), the kernels alone, then the whole
  test from the levels to the claimed ids, old (the frontier mask, the
  indptr, K7, the where) against new (one K17 call); one
  ``torch.segment_reduce`` "max" over pre-gathered hits, the yardstick;
* a kernel that returns at once.

Every new result is held bit for bit against the old one. ``--root`` names
another checkout whose ``graphtpu_torch`` is timed instead (one without K16
or K17 is timed on its K7 designs alone; one whose BFS auto is a host loop
has its run's calls taken), so that two versions run in one call on one
card. ``--out`` also writes the table to a file.
"""

from __future__ import annotations

import argparse
import functools
import runpy
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
BENCH_GRAPH = "bench-rmat-s20-ef32"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
# the path's build, then other window sizes (0: every head takes a global
# atomic) and layouts, and a probe that adds nothing (wrong sums, time only)
K16_BUILDS = ((), ("K16_HUBS=16384",), ("K16_HUBS=8192",), ("K16_HUBS=28672",),
              ("K16_HUBS=0",), ("K16_PROBE=1",))

# device ms per call from traces whose record counts are whole; loaded by
# path, as --root may make graphtpu_torch another checkout's
device_ms = runpy.run_path(str(Path(__file__).with_name("trace_times.py")))["device_ms"]
_pull = runpy.run_path(str(Path(__file__).with_name("pull_sum_times.py")))
event_ms, Progress = _pull["event_ms"], _pull["Progress"]


def records(fn, reps=5):
    """Device records (kernels, memsets, copies) per call of fn()."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kept = sum(e.count for e in prof.key_averages()
               if getattr(e.device_type, "name", str(e.device_type)).endswith("CUDA"))
    return kept / reps


def both(fn):
    """'device us / stream us / records' of fn(); 'lost' for the device us
    where every trace lost records."""
    try:
        dev = f"{device_ms(fn) * 1e3:.1f}"
    except RuntimeError:
        dev = "lost"
    return f"{dev} / {event_ms(fn) * 1e3:.1f} / {records(fn):g}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--out", default=None, help="also write the table to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("head_residual_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.algorithms import bfs as bfs_mod
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.ops import frontier, kernels, triangles
    from graphtpu_torch.ops.spmv import csr_pull_reduce
    from graphtpu_torch.tools.minmode_times import captured
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
    n = g.n
    has_k16 = hasattr(triangles, "lcc_head_credits")
    has_k17 = hasattr(frontier, "residual_claim")
    lines = Progress()
    lines.append(f"card: {smi}; version {args.tag} ({args.root}; K16 {has_k16}, K17 {has_k17}); "
                 f"graph {BENCH_GRAPH} (n={n}, {g.nnz} stored edges)")
    lines.append(f"empty kernel: {device_ms(lambda: kernels.launch_empty(device), 100) * 1e3:.2f}"
                 f" us")

    # ---- K16: the head sums over the wedge plan's buckets
    plan = triangles.prepare_wedge_plan(g, device=device)
    credits = [triangles.wedge_rowblock(b.slab, b.mslab, plan.ehash, plan.id_bits,
                                        b.chunk_cols, plan.closing) for b in plan.buckets]
    slabs = [b.slab for b in plan.buckets]
    creds = [e for _, e in credits]
    u_real = [u[:b.r_real] for b, (u, _) in zip(plan.buckets, credits)]
    flat = torch.cat([e.reshape(-1) for e in creds])
    m_pos, rows = int(plan.edge_pos.shape[0]), int(plan.bucket_rows.shape[0])

    def old_whole():
        f = torch.cat([e.reshape(-1) for e in creds])
        num = triangles._aggregate_heads(f, plan.edge_pos, plan.head_indptr)
        num[plan.bucket_rows] += torch.cat(u_real).long()
        return num

    want = old_whole()
    heads64 = torch.cat([torch.where(s >= 0, s, n).reshape(-1) for s in slabs]).long()
    cred64 = flat.long()
    edge_only = torch.zeros(n + 1, dtype=torch.int64, device=device).index_add_(0, heads64,
                                                                                cred64)[:n]
    share = [100 * int(edge_only[-h:].sum()) / max(int(cred64.sum()), 1) for h in (8192, 16384)]
    lines.append(f"k16: {len(slabs)} buckets, {flat.shape[0]} slab entries "
                 f"({int((heads64 < n).sum())} real, {int((flat != 0).sum())} nonzero credits), "
                 f"{rows} apex rows, {n} heads; the top 8,192 heads take {share[0]:.1f} % of the "
                 f"edge credits, the top 16,384 {share[1]:.1f} %; largest sum {int(want.max())}")
    bound = 8 * m_pos + 12 * rows + 8 * n
    padded = 8 * flat.shape[0] + 12 * rows + 8 * n
    lines.append(f"k16: bound {bound / HBM_BYTES_PER_S * 1e6:.1f} us ({bound} B: entries' heads "
                 f"and credits, apex ids and credits, num); edge part alone "
                 f"{(8 * m_pos + 8 * n) / HBM_BYTES_PER_S * 1e6:.1f} us; the padded slabs "
                 f"streamed whole {padded / HBM_BYTES_PER_S * 1e6:.1f} us")
    lines.append("k16: design: device us / stream us / device records a call")
    k7 = lambda: triangles._aggregate_heads(flat, plan.edge_pos, plan.head_indptr)  # noqa: E731
    lines.append(f"k16: K7 sum_i64 kernel alone: {both(k7)}")
    lines.append(f"k16: old whole aggregation (cat, K7, apex add): {both(old_whole)}")
    acc = torch.zeros(n + 1, dtype=torch.int64, device=device)
    lines.append(f"k16: library index_add_ of int64 credits by head (one call): "
                 f"{device_ms(lambda: acc.index_add_(0, heads64, cred64)) * 1e3:.1f} us")
    if has_k16:
        apex = (u_real, plan.bucket_rows)
        new = lambda: triangles.lcc_head_credits(n, slabs, creds, apex)  # noqa: E731
        if not torch.equal(new(), want):
            raise SystemExit("head_residual_times: K16 differs from K7's head sums")
        lines.append(f"k16: new (one K16 call, {kernels.query('lcc_head_credits_hubs')} hubs): "
                     f"{both(new)}")
        table = triangles.head_credit_table(slabs, creds, apex)
        out = torch.empty(n, dtype=torch.int64, device=device)
        times = {d: [] for d in K16_BUILDS}
        for d in K16_BUILDS + K16_BUILDS[::-1]:  # in turns: each build twice
            lib = kernels.library(d)

            def call(lib=lib):
                rc = lib.gt_lcc_head_credits(table.ctypes.data, table.shape[0], n,
                                             out.data_ptr(),
                                             torch.cuda.current_stream(device).cuda_stream)
                if rc:
                    raise RuntimeError(f"K16 build {d}: error {rc}")

            call()
            if not torch.equal(out, want) and "K16_PROBE=1" not in d:
                raise SystemExit(f"head_residual_times: K16 build {d} differs")
            times[d].append(event_ms(call) * 1e3)
        for d, t in times.items():
            lines.append(f"k16: build {','.join(d) or 'path'}: stream us "
                         f"{', '.join(f'{x:.1f}' for x in t)}"
                         f"{' (a probe: wrong sums)' if 'K16_PROBE=1' in d else ''}")

    # ---- K17: BFS auto's bottom-up residual tests from vertex 0
    cfg = PlatformConfig(device=str(device))
    if has_k17:
        if hasattr(bfs_mod, "_walk"):  # the loop is one CUDA graph: its steps, from the host
            from graphtpu_torch.tools.minmode_times import bfs_eager

            run = functools.partial(bfs_eager, bfs_mod)
        else:
            run = bfs_mod.bfs_adaptive_run
        calls = captured(bfs_mod, "residual_claim", lambda: run(g, 0, cfg))
    else:
        calls = []
        lines.append("k17: not in this checkout (its residual test runs K7 on the path)")
    for i, (levels, level, exp, e_cap, rids, pad) in enumerate(calls):
        def old_test():
            fmask = torch.cat([(levels == level).to(torch.int32), levels.new_zeros(1)])
            return torch.where(frontier.residual_hits(fmask, exp, e_cap), rids, pad)

        new = lambda: frontier.residual_claim(levels, level, exp, e_cap, rids, pad)  # noqa: E731
        got = new()
        if not torch.equal(got, old_test()):
            raise SystemExit("head_residual_times: K17 differs from K7's residual test")
        fmask = torch.cat([(levels == level).to(torch.int32), levels.new_zeros(1)])
        ip = frontier.residual_indptr(exp, e_cap)
        lines.append(f"k17: bottom-up step {i} (level {int(level)}): {rids.shape[0]} row slots, "
                     f"{int((exp.seg_starts.diff() > 0).sum())} rows with edges, "
                     f"{int(exp.edge_count)} edges in {e_cap} slots, "
                     f"{int((got != pad).sum())} claimed")
        lines.append(f"k17: K7 max_i32 kernel alone: "
                     f"{both(lambda: csr_pull_reduce('max_i32', fmask, exp.neigh, ip))}")
        lines.append(f"k17: new kernel (one K17 call): {both(new)}")
        lines.append(f"k17: old whole test (mask, indptr, K7, where): {both(old_test)}")
        hits, offsets = fmask[exp.neigh.long()].float(), ip.long()
        lib = lambda: torch.segment_reduce(hits, "max", offsets=offsets, unsafe=True)  # noqa: E731
        lines.append(f"k17: library segment_reduce max over pre-gathered hits (one call): "
                     f"{device_ms(lib) * 1e3:.1f} us")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
