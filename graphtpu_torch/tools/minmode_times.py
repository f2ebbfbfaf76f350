#!/usr/bin/env python3
"""K12 ``segment_minmode`` timed on one CUDA card, at the shapes of the CDLP
paths and per class of segment length.

    python3 graphtpu_torch/tools/minmode_times.py [--root CHECKOUT] [--tag NAME] [--out FILE]
                                                  [--classes] [--plain]

The shapes, on the bench graph (RMAT scale 20, edge factor 32, undirected,
seed 42; cached under intermediate/ of the checkout that holds this
script), as ``k12_shapes`` builds them: "heavy", the CDLP slab plan's
heavy rows in gather mode with the labels after iteration 0; "identity",
the same rows in identity mode; "tier", a CDLP auto run's largest tier step
(its stream as the loop builds it); "incidence", the whole incidence
(cdlp-impl=sort's call) with the same labels; "vertex0", vertex 0's
segment alone. Prints per shape: segments, entries, the work items of a
call where the version reports them (medium, block-class and long
segments, bins, long chunks, the fallback's chunks and bins), the device
ms of one call (every kernel and memset of the call, by the profiler), of
its persistent grid kernel alone where the version has one, and, with
``--plain``, of the plain version.

``--classes``: streams of 2^24 entries in segments of one length L each,
labels drawn from 2^20, in gather mode, timed under every unit that can
take L (this version's class bounds set for the call: a warp's table up to
512, a block's table up to 4,096, bins), from which the class bounds
``K12_MED_LEN`` and ``K12_SMEM_LEN`` of ``ops/minmode.py`` are read off; a
version without those bounds is timed under its own design.

``--root`` names the checkout whose ``graphtpu_torch`` is timed (this one by
default), so that two versions of K12 are timed in one call on one card.
"""

from __future__ import annotations

import argparse
import runpy
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
BENCH_GRAPH = "bench-rmat-s20-ef32"
CDLP_ITERS = 10
CLASS_ENTRIES = 1 << 24
CLASS_LENGTHS = (33, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 2048, 3072, 4096, 8192,
                 65536)
# (name, med_len, long_len): the unit each class bound setting gives L
CLASS_UNITS = (("warp", 512, 4096), ("block", 32, 4096), ("bins", 32, 32))

device_ms = runpy.run_path(str(Path(__file__).with_name("trace_times.py")))["device_ms"]


def _kept(a):
    """A copy of a call's argument as it is now: a tensor cloned, and each
    tensor of a NamedTuple (an expansion, whose row starts may be a view of
    a loop's buffer that a later step writes again)."""
    if hasattr(a, "clone"):
        return a.clone()
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_kept(x) for x in a))
    return a


def captured(owner, attr, fn):
    """Run fn() with ``owner.attr`` replaced by a wrapper that keeps the
    positional arguments of each call (tensors cloned, also inside a
    NamedTuple); returns them, and raises if there was none."""
    calls = []
    real = getattr(owner, attr)

    def keep(*args, **kwargs):
        calls.append(tuple(_kept(a) for a in args))
        return real(*args, **kwargs)

    setattr(owner, attr, keep)
    try:
        fn()
    finally:
        setattr(owner, attr, real)
    if not calls:
        raise RuntimeError(f"{attr} was not called")
    return calls


def cdlp_auto_eager(active, g, centers, neigh, deg, cfg, prep, itermax=CDLP_ITERS):
    """CDLP auto's run as the step functions called one by one from the host
    (the loop's host driver, each wrapper launching its kernel), where the
    checkout runs the loop as one CUDA graph, whose replays call no Python
    function for ``captured`` to see; else the run itself."""
    if not hasattr(active, "_host_loop"):
        return active.cdlp_adaptive_device_run(g, centers, neigh, deg, itermax, cfg, prep=prep)
    tiers = active.cdlp_tiers(int(cfg.cdlp_frontier_rows or 1 << 16),
                              int(cfg.cdlp_frontier_edges or 1 << 18), int(deg.sum()), cfg)
    st = active._loop_state(prep, g.n, tiers, handles=False)
    st.itermax[0] = itermax
    active._host_loop(prep, st, g.directed)
    return st.labels, int(st.ctl[active.CTL_IT])


def bfs_eager(bfs_mod, g, source, cfg):
    """BFS auto's run (bfs-impl=device's where cfg.bfs_impl is device or
    dense) as its steps called one by one from the host (the loop's host
    walk, each wrapper launching its kernel), for a checkout that runs the
    loop as one CUDA graph, whose replays call no Python function for
    ``captured`` to see: (levels, control words)."""
    if cfg.bfs_impl in ("device", "dense"):
        spec = bfs_mod._dense_loop(g, cfg.device)
    else:
        spec = bfs_mod._auto_loop(g, cfg)[1]
    st, _ = bfs_mod._walk(spec, source)
    return st.levels, st.ctl


def k12_shapes(g, device, prep=None, lab1=None):
    """name -> (labels, centers, neigh, indptr, identity) of K12's calls on
    the CDLP paths of graph g (undirected): see the module docstring.
    ``prep`` (the CDLP auto prep) and ``lab1`` (the labels after iteration
    0) are built when not given."""
    import numpy as np
    import torch

    from graphtpu_torch.algorithms.cdlp import build_incidence
    from graphtpu_torch.ops import active
    from graphtpu_torch.ops.minmode import _iter0_minmode
    from graphtpu_torch.utils.config import PlatformConfig

    centers, neigh = build_incidence(g)
    deg = np.bincount(centers, minlength=g.n)
    cfg = PlatformConfig(device=str(device))
    if prep is None:
        prep = active.prepare_cdlp_adaptive(g, centers, neigh, deg, cfg)
    plan = prep.plan
    if lab1 is None:
        lab1 = _iter0_minmode(plan, torch.arange(g.n, dtype=torch.int32, device=device))
    heavy = (plan.heavy_centers, plan.heavy_neigh, plan.heavy_indptr)
    tiers = captured(active, "stream_minmode", lambda: cdlp_auto_eager(
        active, g, centers, neigh, deg, cfg, prep))
    t_labels, t_centers, t_neigh, t_indptr = max(tiers, key=lambda a: int(a[3][-1]))
    if t_centers is None:  # the tier step on the card builds no centres: K12 reads none
        h, m, real = t_indptr.shape[0] - 1, t_neigh.shape[0], int(t_indptr[-1])
        t_centers = torch.cat([
            torch.repeat_interleave(torch.arange(h, dtype=torch.int32, device=device),
                                    torch.diff(t_indptr), output_size=real),
            torch.full((m - real,), h, dtype=torch.int32, device=device)])
    tier = (t_centers, t_neigh, t_indptr)
    indptr = np.zeros(g.n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)  # noqa: E731
    inc = (i32(centers), i32(neigh), i32(indptr))
    d0 = int(deg[0])
    v0 = (i32(np.zeros(d0)), inc[1][:d0].contiguous(), i32([0, d0]))
    return {"heavy": (lab1, *heavy, False), "identity": (None, *heavy, True),
            "tier": (t_labels, *tier, False), "incidence": (lab1, *inc, False),
            "vertex0": (lab1, *v0, False)}


def shape_bytes(labels, neigh, indptr, n):
    """K12's byte bound at a call: neigh's real entries and indptr read
    once, in gather mode the labels those entries can reach (at most one
    an entry, at most all n), a result a segment."""
    h, real = indptr.shape[0] - 1, int(indptr[-1])
    return 4 * (real + (h + 1) + h + (0 if labels is None else min(n, real)))


def _work(minmode, labels, neigh, indptr, identity):
    """This version's work items of one call, or None if it has none."""
    if not hasattr(minmode, "k12_work"):
        return None
    _, scratch = minmode._k12_launch(labels, neigh, indptr, identity)
    return minmode.k12_work(scratch)


def class_stream(length, device, seed=16):
    """(labels, centers, neigh, indptr) of CLASS_ENTRIES entries in
    segments of ``length``, ids and labels from 2^20."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    n = 1 << 20
    h = CLASS_ENTRIES // length
    indptr = (torch.arange(h + 1, device=device, dtype=torch.int32) * length).contiguous()
    centers = torch.repeat_interleave(torch.arange(h, device=device, dtype=torch.int32), length)
    neigh = torch.randint(0, n, (h * length,), generator=gen, device=device, dtype=torch.int32)
    labels = torch.randint(0, n, (n,), generator=gen, device=device, dtype=torch.int32)
    return labels, centers, neigh, indptr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    ap.add_argument("--classes", action="store_true", help="time each class of length alone")
    ap.add_argument("--plain", action="store_true", help="time the plain version too")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("minmode_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.ops import minmode
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
    lines = [f"card: {smi}; version {args.tag} ({args.root})",
             "k12: shape segments entries bytes work device_ms grid_kernel_ms plain_ms"]
    for name, (labels, centers, neigh, indptr, identity) in k12_shapes(g, device).items():
        call = lambda: minmode.stream_minmode(labels, centers, neigh, indptr, identity)  # noqa: E731
        got = call()
        want = minmode.stream_minmode_plain(labels, centers, neigh, indptr, identity)
        assert torch.equal(got, want), f"{name}: K12 differs from its plain version"
        work = _work(minmode, labels, neigh, indptr, identity)
        plain = "-"
        if args.plain:
            plain = f"{device_ms(lambda: minmode.stream_minmode_plain(labels, centers, neigh, indptr, identity), reps=5):.6f}"  # noqa: E501
        grid = "-"
        if work is not None:  # the persistent grid's share of the call
            grid = f"{device_ms(call, reps=10, only=('k12_grid_kernel',)):.6f}"
        lines.append(f"k12: {name} {indptr.shape[0] - 1} {int(indptr[-1])} "
                     f"{shape_bytes(labels, neigh, indptr, g.n)} {work} "
                     f"{device_ms(call, reps=10):.6f} {grid} {plain}")
        print(lines[-1], flush=True)
    if args.classes:
        lines.append("k12 class: length segments unit device_ms")
        units = CLASS_UNITS if hasattr(minmode, "K12_MED_LEN") else (("own", None, None),)
        for length in CLASS_LENGTHS:
            labels, centers, neigh, indptr = class_stream(length, device)
            for unit, med, long_ in units:
                if length > {"warp": 512, "block": 4096}.get(unit, length):
                    continue  # a unit that cannot take this length
                saved = (getattr(minmode, "K12_MED_LEN", None),
                         getattr(minmode, "K12_SMEM_LEN", None))
                if med is not None:
                    minmode.K12_MED_LEN, minmode.K12_SMEM_LEN = med, long_
                try:
                    call = lambda: minmode.stream_minmode(labels, centers, neigh, indptr)  # noqa: E731
                    if length in (33, 512, 4096, 8192):
                        assert torch.equal(call(), minmode.stream_minmode_plain(
                            labels, centers, neigh, indptr)), f"class {length} {unit} differs"
                    ms = device_ms(call, reps=10)
                finally:
                    if med is not None:
                        minmode.K12_MED_LEN, minmode.K12_SMEM_LEN = saved
                lines.append(f"k12 class: {length} {indptr.shape[0] - 1} {unit} {ms:.6f}")
                print(lines[-1], flush=True)
            del labels, centers, neigh, indptr
            torch.cuda.empty_cache()
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
