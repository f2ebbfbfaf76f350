#!/usr/bin/env python3
"""K14 ``frontier_compact`` timed on one CUDA card at the adaptive paths'
shapes.

    python3 graphtpu_torch/tools/compact_times.py [--root CHECKOUT] [--tag NAME] [--out FILE]

On the bench graph (RMAT scale 20, edge factor 32, undirected, seed 42;
cached under intermediate/ of the checkout that holds this script), the
shapes of ``chip_smoke.py``'s K14 phase, each taken from a run: compact on
CDLP auto's fullest changed mask and on BFS auto's fullest level mask (n =
2^20), and on the CDLP mask from byte 3 on (a rank's slice, off a 16-byte
boundary); compact_stream on BFS auto's widest tier stream (2^18 slots), on
BFS's top push tier filled by a random frontier (2^22 slots), and on the
widest streams of CDLP auto's and WCC auto's active steps. Prints the
device ms of a call (``tools/trace_times.py``) beside the plain version's,
every result checked equal to the plain version bit for bit.

``--root`` names the checkout whose ``graphtpu_torch`` is timed (this one by
default): one whose BFS auto and CDLP auto loops are CUDA graphs, or one
from before either was (each loop's branch reads which).
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

_tools = Path(__file__).resolve().parent
device_ms = runpy.run_path(str(_tools / "trace_times.py"))["device_ms"]
bench_graph = runpy.run_path(str(_tools / "lcc_sweep_times.py"))["bench_graph"]


def shapes(g, device):
    """name -> ("mask", (mask, k)) or ("stream", (vals, active, k, n))."""
    import numpy as np
    import torch

    from graphtpu_torch.algorithms import bfs as bfs_mod
    from graphtpu_torch.algorithms import wcc as wcc_mod
    from graphtpu_torch.algorithms.common import run_algorithm
    from graphtpu_torch.ops import active as active_mod
    from graphtpu_torch.ops.frontier import frontier_expand
    from graphtpu_torch.tools.minmode_times import captured
    from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig

    n = g.n
    cfg = PlatformConfig(device=str(device))
    calls = {}

    def cdlp_auto():
        return run_algorithm("cdlp", g, AlgorithmParams(max_iterations=CDLP_ITERS),
                             PlatformConfig(device=str(device), cdlp_impl="auto"))

    if hasattr(active_mod, "compact_rows_into"):
        # the loop is one CUDA graph: its steps, called from the host, show
        # the tier steps' streams (K14's row-flag mode) as the stream of
        # compact_stream over the rows' flags
        from graphtpu_torch.algorithms.cdlp import build_incidence
        from graphtpu_torch.tools.minmode_times import cdlp_auto_eager

        centers, neigh = build_incidence(g)
        deg = np.bincount(centers, minlength=n)
        cfg_a = PlatformConfig(device=str(device))
        prep = active_mod.prepare_cdlp_adaptive(g, centers, neigh, deg, cfg_a)

        def cdlp_run():
            rows = captured(active_mod, "compact_rows_into", lambda: cdlp_auto_eager(
                active_mod, g, centers, neigh, deg, cfg_a, prep))
            calls["cdlp_stream"] = [
                (exp.neigh, exp.valid & rowflag[exp.rows_local.long()], ids.shape[0], n_)
                for exp, rowflag, n_, _, ids, _ in rows]
    else:
        def cdlp_run():
            calls["cdlp_stream"] = captured(active_mod, "compact_stream", cdlp_auto)

    masks = captured(active_mod, "compact", cdlp_run)
    calls["wcc_stream"] = captured(wcc_mod, "compact_stream", lambda: run_algorithm(
        "wcc", g, AlgorithmParams(), PlatformConfig(device=str(device), wcc_impl="auto")))

    if hasattr(bfs_mod, "_walk"):
        # the loop is one CUDA graph: its steps, called from the host, show
        # the tier steps' frontiers (K14's level mode) and new frontiers (its
        # unvisited mode), taken as the mask and the stream they compact
        from graphtpu_torch.core.types import INT32_INF
        from graphtpu_torch.tools.minmode_times import bfs_eager

        def bfs_run():
            calls["stream"] = [
                (exp.neigh, exp.valid & (levels[exp.neigh.long()] == INT32_INF), ids.shape[0], n_)
                for exp, levels, n_, _, ids, _ in captured(
                    bfs_mod, "compact_unvisited_into", lambda: bfs_eager(bfs_mod, g, 0, cfg))]

        calls["mask"] = [(levels == level, ids.shape[0]) for levels, level, ids, _ in
                         captured(bfs_mod, "compact_level_into", bfs_run)]
    else:
        def bfs_run():
            calls["stream"] = captured(bfs_mod, "compact_stream",
                                       lambda: bfs_mod.bfs_adaptive_run(g, 0, cfg))

        calls["mask"] = captured(bfs_mod, "compact", bfs_run)
    fullest = lambda cs: max(cs, key=lambda c: int(c[0].sum()))  # noqa: E731
    cdlp_mask, cdlp_k = fullest(masks)[:2]
    bfs_mask, bfs_k = fullest(calls["mask"])[:2]
    widest = lambda cs: max(cs, key=lambda c: c[0].shape[0])[:4]  # noqa: E731
    vals, active, s_k, s_n = widest(calls["stream"])
    # BFS's top push tier: the rows of a random sample, cut where their
    # out-edges pass the tier's slots (chip_smoke.py's K5 and K14 phases)
    bprep = bfs_mod.bfs_adaptive_prep(g, bfs_mod.BFS_TRUNC, device)
    e_top = int(cfg.bfs_frontier_edges or 1 << 22)
    k_top = min(int(cfg.bfs_frontier_rows or 1 << 18), e_top, n)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    order = torch.randperm(n, generator=gen, device=device)[:k_top]
    filled = torch.cumsum(bprep.deg_pad[order].long(), 0) >= e_top
    top_cnt = int(filled.long().argmax()) + 1 if bool(filled.any()) else k_top
    top_ids = torch.full((k_top,), n, dtype=torch.int32, device=device)
    top_ids[:top_cnt] = order[:top_cnt].sort().values.to(torch.int32)
    lens = bprep.deg_pad[top_ids.long()]
    starts = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0, dtype=torch.int32)])
    _, _, _, top_neigh, top_valid = frontier_expand(top_ids, starts, bprep.push_indptr,
                                                    bprep.push_dst, e_top, False)
    return {
        "cdlp_mask": ("mask", (cdlp_mask, cdlp_k)),
        "bfs_mask": ("mask", (bfs_mask, bfs_k)),
        "cdlp_mask_from_byte_3": ("mask", (cdlp_mask[3:], cdlp_k)),
        "bfs_stream": ("stream", (vals, active, s_k, s_n)),
        "bfs_top_stream": ("stream", (top_neigh, top_valid, k_top, n)),
        "cdlp_stream": ("stream", widest(calls["cdlp_stream"])),
        "wcc_stream": ("stream", widest(calls["wcc_stream"])),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose graphtpu_torch is timed")
    ap.add_argument("--tag", default="change", help="name of this version in the output")
    ap.add_argument("--out", default=None, help="also write the table to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compact_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from graphtpu_torch.ops import frontier as fr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda:0")
    g = bench_graph()
    lines = [f"card: {smi}; version {args.tag} ({args.root}); graph {BENCH_GRAPH}: n={g.n}",
             "k14: shape what ms plain_ms"]
    for name, (kind, a) in shapes(g, device).items():
        fn, plain = ((fr.compact, fr.compact_plain) if kind == "mask"
                     else (fr.compact_stream, fr.compact_stream_plain))
        want = plain(*a)
        what = (f"{a[0].shape[0]} vertices, {int(a[0].sum())} set, k = {a[1]}" if kind == "mask"
                else f"{a[0].shape[0]} slots, {int(a[1].sum())} active, {int(want[1])} distinct "
                     f"of n = {a[3]}, k = {a[2]}")
        assert all(torch.equal(g_, w_) for g_, w_ in zip(fn(*a), want)), name
        plain_ms = device_ms(lambda a=a, plain=plain: plain(*a), reps=10)
        ms = device_ms(lambda a=a, fn=fn: fn(*a), reps=10)
        lines.append(f"k14: {name} {fn.__name__} {ms:.6f} {plain_ms:.6f} ({what})")
        print(lines[-1], flush=True)
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
