#!/usr/bin/env python3
"""K15 ``lcc_sweep_member`` timed on one CUDA card, bucket by bucket and
over the whole sweep of the bench graph, and the whole sweep call.

    python3 graphtpu_torch/tools/lcc_sweep_times.py [--root CHECKOUT] [--tag NAME] [--out FILE]
                                                    [--units 32,64,128,256]

On the bench graph (RMAT scale 20, edge factor 32, undirected, seed 42;
cached under intermediate/ of the checkout that holds this script), the
sweep's degree buckets as ``lcc_sweep_numerator`` forms them. For the
c-row design (``algorithms/lcc.py:sweep_plan``) it prints per bucket: its
pad, plan entries, neighbour searches (the sum of d(c)), search steps (d(c)
times ceil(log2(d(o) + 1))), work items, atomics at most (a lane of an item
per x), and the device ms of K15 over the bucket under the path's launch
(``K15_UNIT``, ``k15_ilp``), under each unit of ``--units`` at 1 and 4
searches a lane in step, and under the probes of the kernel's own
K15_PROBES build (``kernels.library(("K15_PROBES",))``: atomics dropped;
every search cut to a few steps; both; wrong numerators, time only). A
time whose every trace lost records prints "not measured". Every variant
without a probe has its numerators checked equal to the path's launch.
Then the whole sweep under each variant.

Last, for any version, the wall seconds of ``lcc_sweep_numerator`` on the
card (the call a user's LCC makes when it sweeps: host plan, copies, the
launches, the numerators back), one warm-up and ``--calls`` calls, and of
its host prep alone (``sweep_plan`` with its symmetry check on the card,
or ``prepare_lcc`` where there is no plan).

``--root`` names the checkout whose ``graphtpu_torch`` is timed (this one by
default). A version without the c-row plan (one entry per A-edge,
``prepare_lcc``'s lists, a warp an A-edge) is timed per bucket and over the
whole sweep under its own launch.
"""

from __future__ import annotations

import argparse
import ctypes
import runpy
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
BENCH_GRAPH = "bench-rmat-s20-ef32"

device_ms = runpy.run_path(str(Path(__file__).with_name("trace_times.py")))["device_ms"]


def try_ms(fn):
    """device_ms of fn over 3 calls, or None where every trace lost
    records (printed "not measured")."""
    try:
        return device_ms(fn, reps=3)
    except RuntimeError as e:
        print(f"k15: not measured: {e}", flush=True)
        return None


def said(ms):
    return "not measured" if ms is None else f"{ms:.6f}"


def bench_graph():
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.utils.synth import rmat_graph

    inter = HERE / "intermediate"
    if cache_mod.exists(inter, BENCH_GRAPH):
        return cache_mod.load(inter, BENCH_GRAPH)
    g = rmat_graph(20, 32, directed=False, weighted=False, seed=42)
    cache_mod.save(g, inter, BENCH_GRAPH)
    return g


def counts(s_deg, c, o):
    """(entries, searches, search steps) of plan entries (c, o)."""
    import numpy as np

    dc = s_deg[c]
    return c.shape[0], int(dc.sum()), int((dc * np.ceil(np.log2(s_deg[o] + 1.0))).sum())


def old_design(lcc_mod, g, device, lines):
    """A checkout whose sweep takes prepare_lcc's A-edge lists."""
    import numpy as np
    import torch

    s_indptr, s_dst, s_deg, c, o, dc = lcc_mod.prepare_lcc(g)
    iters = max(1, int(np.ceil(np.log2(max(int(s_deg.max()), 2) + 1))))
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    indptr, col = dev(s_indptr), dev(s_dst)
    num = torch.zeros(g.n, dtype=torch.int64, device=device)
    buckets = []
    for pad in lcc_mod._bucket_bounds(int(s_deg.max())):
        sel = (dc > (0 if pad == 16 else pad // 8)) & (dc <= pad)
        if sel.any():
            buckets.append((pad, dev(c[sel]), dev(o[sel]), counts(s_deg, c[sel], o[sel])))

    def sweep(parts):
        for pad, cb, ob, _ in parts:
            lcc_mod._lcc_bucket_sweep(num, indptr, col, cb, ob, pad, iters)

    lines.append("k15: pad a_edges searches steps ms")
    for b in buckets:
        ms = device_ms(lambda b=b: sweep([b]), reps=3)
        lines.append(f"k15: {b[0]} {b[3][0]} {b[3][1]} {b[3][2]} {ms:.6f}")
        print(lines[-1], flush=True)
    num.zero_()
    sweep(buckets)
    total = num.sum().item()
    ms = device_ms(lambda: sweep(buckets), reps=3)
    lines.append(f"k15: whole sweep, its own design: {ms:.6f} ms (numerator sum {total})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--out", default=None, help="also write the table to this file")
    ap.add_argument("--units", default="32,64,128,256", help="threads per item to time")
    ap.add_argument("--calls", type=int, default=3, help="timed calls of lcc_sweep_numerator")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("lcc_sweep_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.algorithms import lcc as lcc_mod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda:0")
    g = bench_graph()
    lines = [f"card: {smi}; version {args.tag} ({args.root}); graph {BENCH_GRAPH}: n={g.n}, "
             f"{g.nnz} stored edges"]
    if not hasattr(lcc_mod, "sweep_plan"):
        old_design(lcc_mod, g, device, lines)
        whole_call(lcc_mod, g, device, lines, args.calls)
        return finish(lines, args.out)

    plan = lcc_mod.sweep_plan(g, device)
    iters = lcc_mod.search_iters_of(plan.s_deg)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    indptr, col = dev(plan.s_indptr), dev(plan.s_dst)
    buckets = []  # (pad, c, o, items, counts, items, atomics at most)
    for pad, sel in lcc_mod.plan_buckets(plan):
        c, o = plan.c[sel], plan.o[sel]
        items = lcc_mod.sweep_items(c, plan.s_deg)
        lanes = np.minimum(lcc_mod.K15_TILE, plan.s_deg[c[items[:, 0]]] - items[:, 2])
        buckets.append((pad, dev(c), dev(o), dev(items), counts(plan.s_deg, c, o),
                        items.shape[0], int(lanes.sum())))
    num = torch.zeros(g.n, dtype=torch.int64, device=device)
    variants = [("path", {})]
    variants += [(f"unit_{u}_ilp_{i}", {"unit": u, "ilp": i})
                 for u in map(int, args.units.split(",")) for i in (1, 4)]
    probe_fn = probe_launch(torch)
    probes = [(f"probe_{what}", {"probe": bits})
              for what, bits in (("no_atomics", 1), ("depth", 2), ("both", 3))]

    def sweep(parts, kw):
        for pad, cb, ob, items, *_ in parts:
            if "probe" in kw:
                probe_fn(num, indptr, col, cb, ob, items, plan.weight, lcc_mod.K15_UNIT,
                         lcc_mod.k15_ilp(pad), kw["probe"])
            else:
                lcc_mod._lcc_bucket_sweep(num, indptr, col, cb, ob, pad, iters, plan.weight,
                                          items, **kw)

    def numerators(parts, kw):
        num.zero_()
        sweep(parts, kw)
        return num.clone()

    lines.append(f"k15: path launch: ilp {lcc_mod.K15_ILP} from pad {lcc_mod.K15_ILP_FROM_PAD} "
                 f"(1 below), unit {lcc_mod.K15_UNIT}, K15_STEPS {lcc_mod.K15_STEPS}, weight "
                 f"{plan.weight}")
    lines.append("k15: pad entries searches steps items atomics_at_most "
                 + " ".join(f"ms_{name}" for name, _ in variants + probes))
    for b in buckets:
        want = numerators([b], {})
        row = []
        for name, kw in variants + probes:
            if "probe" not in kw:
                assert torch.equal(numerators([b], kw), want), (b[0], name)
            row.append(try_ms(lambda kw=kw: sweep([b], kw)))
        e, s, st = b[4]
        lines.append(f"k15: {b[0]} {e} {s} {st} {b[5]} {b[6]} "
                     + " ".join(said(ms) for ms in row))
        print(lines[-1], flush=True)
    total = numerators(buckets, {}).sum().item()
    e = sum(b[4][0] for b in buckets)
    s = sum(b[4][1] for b in buckets)
    st = sum(b[4][2] for b in buckets)
    lines.append(f"k15: whole plan: {e} entries, {s} searches, {st} search steps, "
                 f"{sum(b[5] for b in buckets)} items, {sum(b[6] for b in buckets)} atomics at "
                 f"most, numerator sum {total}")
    for name, kw in variants + probes:
        ms = try_ms(lambda kw=kw: sweep(buckets, kw))
        lines.append(f"k15: whole sweep, {name}: {said(ms)} ms")
        print(lines[-1], flush=True)
    whole_call(lcc_mod, g, device, lines, args.calls)
    return finish(lines, args.out)


def probe_launch(torch):
    """A launcher of gt_lcc_sweep_member_probe from the K15_PROBES build."""
    from graphtpu_torch.ops import kernels

    lib = kernels.library(("K15_PROBES",))
    fn = lib.gt_lcc_sweep_member_probe
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = (p, p, p, p, p, i64, i32, i32, i32, i32, p, p)
    fn.restype = ctypes.c_int

    def launch(num, indptr, col, c, o, items, weight, unit, ilp, probe):
        rc = fn(indptr.data_ptr(), col.data_ptr(), c.data_ptr(), o.data_ptr(), items.data_ptr(),
                items.shape[0], weight, unit, ilp, probe, num.data_ptr(),
                torch.cuda.current_stream(num.device).cuda_stream)
        if rc:
            raise RuntimeError(f"gt_lcc_sweep_member_probe failed: error {rc}")

    return launch


def whole_call(lcc_mod, g, device, lines, calls):
    """Wall seconds of lcc_sweep_numerator on the card and of its host prep."""
    import numpy as np

    want = lcc_mod.lcc_sweep_numerator(g, device)[0]  # warm-up: builds, first copies
    secs = []
    for _ in range(calls):
        t0 = time.perf_counter()
        got = lcc_mod.lcc_sweep_numerator(g, device)[0]
        secs.append(time.perf_counter() - t0)
        assert np.array_equal(got, want)
    planned = hasattr(lcc_mod, "sweep_plan")
    prep_secs = []
    for _ in range(calls):
        t0 = time.perf_counter()
        lcc_mod.sweep_plan(g, device) if planned else lcc_mod.prepare_lcc(g)
        prep_secs.append(time.perf_counter() - t0)
    what = "sweep_plan (its symmetry check on the card)" if planned else "prepare_lcc"
    lines.append(f"k15: lcc_sweep_numerator wall s over {calls} calls: "
                 f"{' '.join(f'{x:.3f}' for x in secs)} (median {np.median(secs):.3f}; "
                 f"numerator sum {int(want.sum())}); its host prep {what} alone: "
                 f"{' '.join(f'{x:.3f}' for x in prep_secs)} (median {np.median(prep_secs):.3f})")
    print(lines[-1], flush=True)


def finish(lines, out) -> int:
    text = "\n".join(lines)
    print(text, flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
