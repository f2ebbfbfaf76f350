"""The port's benchmark entry point (counterpart of ``bench.py:main`` and
``bench.py:main_scaling``): prints one JSON line.

    python -m graphtpu_torch.bench                                # on cuda:0
    GRAPHTPU_BENCH_PLATFORM=cpu GRAPHTPU_BENCH_SCALE=8 python -m graphtpu_torch.bench
    python -m graphtpu_torch.bench --scaling                      # see run_scaling

Headline metric: CDLP throughput in processed incidence entries per second
on the bench graph (RMAT scale 20, edge factor 32, undirected, seed 42),
against the reference's CPU LAGraph_cdlp at 1,500 ms an iteration on
datagen-7_5-fb (BASELINE.md): 2 x 34,185,747 / 1.5 s.

The sections and their order are the JAX bench's: CDLP adaptive
(``prepare_cdlp_adaptive``, then ``cdlp_adaptive_device_run`` with stats),
PageRank on the slab plan (``build_pull_plan``, then ``_pr_slab_kernel``, 20
iterations), the adaptive BFS from vertex 0; then, under ``SectionRunner``,
``wcc`` (``wcc_adaptive_run``), ``sssp`` (the ladder adaptive, delta,
dense, on the weighted RMAT scale 20 / edge factor 16), ``lcc`` (the wedge
plan, then ``lcc_oriented`` cold and warm) and ``ingest`` (the bench
graph's text written once with numpy, then parsed and relabelled, natively
where the port's library builds).

Timing: ``torch.cuda.synchronize()`` at every timed boundary; one warm-up,
then ``GRAPHTPU_BENCH_REPS`` timed runs (default 5). A time key holds the
median run, ``<key>_min`` and ``<key>_max`` the spread, and
``<key>_event_s`` the CUDA-event span of the median run (events recorded
on the stream at its start and end; None on the CPU). The LCC plan's
preparation and its first (cold) run are one-shot by nature. Each section
resets the card's peak-memory counter first and records
``<section>_peak_device_bytes``. Between sections ``_free_device_state``
empties the graph's memo (plans, device views, the symmetrized graph) and
the allocator's cache.

Keys that differ from the JAX bench's:
* added: ``backend`` is "cuda" (or "cpu"), ``card`` and ``power_limit``
  (nvidia-smi), ``reps``, the ``_min``/``_max``/``_event_s`` spread of each
  time, the per-section peak device bytes, ``cdlp_s``, ``pr_s``,
  ``bfs_s`` and ``ingest_*_s`` spreads;
* left out: the nominal ratios ``*_sol_pct_nominal``,
  ``bfs_sol_pct_vs_edge_sweep`` and ``sssp_sol_pct_vs_one_pass`` (above 100
  by design); ``bfs_sol_pct`` (priced by TPU step costs); ``lcc_sol_pct``
  (priced pairs-mode hash probes, which the port's K10 search does not
  make). Every ``*_sol_pct`` here is a share of the executed volume's
  byte bound (``utils/roofline.py``).

Environment: GRAPHTPU_BENCH_SCALE (20), _EDGE_FACTOR (32), _ITERS (10),
_SSSP_SCALE (20), _SSSP_EF (16), _SECTIONS ("wcc,sssp,lcc,ingest"), _CACHE
("./intermediate": graphs ``bench-rmat-s<scale>-ef<ef>`` and
``bench-rmat-s<scale>-ef<ef>-w``, shared with ``chip_smoke.py``), _REPS (5),
_PLATFORM ("cuda", or "cpu" for the tests). With "cuda" and no card the
bench exits non-zero; it never falls back to the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from graphtpu_torch.utils import roofline as rl

# Reference CPU baseline (BASELINE.md): datagen-7_5-fb, 34,185,747 undirected
# edges (2x stored), ~1.5 s per CDLP iteration.
BASELINE_CDLP_EDGES_PER_S = 2 * 34_185_747 / 1.5
PR_ITERS = 20
SECTIONS = "wcc,sssp,lcc,ingest"


def _env_int(key: str, default: int) -> int:
    return int(os.environ.get(key, str(default)))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device, reps: int):
    """One warm-up, then ``reps`` timed runs of ``fn``: (the last run's
    value, {"s": median seconds, "s_min", "s_max", "event_s": the CUDA-event
    span of the median run or None, "i": the median run's index})."""
    fn()
    walls, spans, out = [], [], None
    for _ in range(reps):
        ev = None
        _sync(device)
        if device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        out = fn()
        if ev is not None:
            ev[1].record()
        _sync(device)
        walls.append(time.perf_counter() - t0)
        spans.append(ev[0].elapsed_time(ev[1]) / 1e3 if ev is not None else None)
    order = sorted(range(reps), key=walls.__getitem__)
    mid = order[(reps - 1) // 2]
    return out, {"s": walls[mid], "s_min": walls[order[0]], "s_max": walls[order[-1]],
                 "event_s": spans[mid], "i": mid}


def _spread(prefix: str, t: dict) -> dict:
    """``prefix``, ``prefix_min``, ``prefix_max`` and ``prefix_event_s``
    from a ``timed`` record (``prefix`` names seconds)."""
    return {prefix: t["s"], f"{prefix}_min": t["s_min"], f"{prefix}_max": t["s_max"],
            f"{prefix}_event_s": t["event_s"]}


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _free_device_state(g) -> None:
    """Drop every plan and device view memoized on the Graph between
    sections (the wedge plan, the symmetrized graph, the slab plans, the
    pull CSRs and the rest live in ``g.memo``), then the allocator's
    cache."""
    g.memo.clear()
    g._device_views.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def card() -> tuple:
    """(name, power limit) of the first card as nvidia-smi gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return name, limit


def _device_ping(device, timeout_s: float = 120.0) -> None:
    """Fail fast, with a message and a non-zero exit, when the card does
    not finish a trivial op."""
    ok = []
    t = threading.Thread(target=lambda: ok.append(float(torch.ones(8, device=device).sum())),
                         daemon=True)
    t.start()
    t.join(timeout_s)
    if not ok:
        print(f"bench: {device} did not finish a trivial op within {timeout_s:.0f}s: aborting",
              file=sys.stderr, flush=True)
        os._exit(1)


def load_or_make(cache_dir: str, name: str, scale: int, edge_factor: int, weighted: bool):
    """An undirected RMAT graph (seed 42) from the ingest cache, generated
    and cached on a miss (or a stale cache version)."""
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.utils.synth import rmat_graph

    if cache_mod.exists(cache_dir, name):
        try:
            return cache_mod.load(cache_dir, name)
        except ValueError:
            pass
    g = rmat_graph(scale, edge_factor, directed=False, weighted=weighted, seed=42)
    cache_mod.save(g, cache_dir, name)
    g.name = name
    return g


def ascii_lines(cols) -> bytes:
    """Lines of space-separated columns as text bytes. A column is an array
    of non-negative ids below 2^31 or a NUL-padded bytes array (numpy "S")."""
    parts = []
    for c in cols:
        if c.dtype.kind == "S":
            parts.append(c.view(np.uint8).reshape(c.shape[0], c.dtype.itemsize))
            continue
        c = c.astype(np.int32)
        width = len(str(int(c.max()))) if c.size else 1
        p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int32)
        lead = (c[:, None] < p) & (p > 1)  # leading zeros; a 0 keeps its last digit
        parts.append(np.where(lead, 0, (c[:, None] // p) % 10 + 48).astype(np.uint8))
    sep = np.full((parts[0].shape[0], 1), ord(" "), np.uint8)
    mat = np.concatenate([x for q in parts for x in (q, sep)][:-1]
                         + [np.full_like(sep, ord("\n"))], axis=1)
    return mat[mat != 0].tobytes()


def write_text(path: Path, cols, chunk: int = 1 << 20) -> None:
    """``cols`` as text lines at ``path``, by an atomic rename."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        for i in range(0, cols[0].shape[0], chunk):
            f.write(ascii_lines([c[i:i + chunk] for c in cols]))
    os.replace(tmp, path)


# ------------------------------------------------------------------ sections


def cdlp_section(g, cfg, itermax: int, device, reps: int) -> dict:
    from graphtpu_torch.algorithms.cdlp import build_incidence
    from graphtpu_torch.ops.active import cdlp_adaptive_device_run, prepare_cdlp_adaptive

    centers, neigh = build_incidence(g)
    deg = np.bincount(centers, minlength=g.n).astype(np.int32)
    inc_nnz = centers.shape[0]
    prep = prepare_cdlp_adaptive(g, centers, neigh, deg, cfg)
    (_, it, stats), t = timed(lambda: cdlp_adaptive_device_run(
        g, centers, neigh, deg, itermax, cfg, prep, with_stats=True), device, reps)
    iters = max(int(it), 1)
    roof = rl.cdlp_executed_roof(stats["full_steps"], stats["active_steps"],
                                 rl.plan_gather_count(prep.plan), stats["e_cap"])
    return {
        "cdlp_edges_per_s": inc_nnz * iters / t["s"],
        "cdlp_ms_per_iter": t["s"] * 1000.0 / iters,
        **_spread("cdlp_s", t),
        "cdlp_iters": iters,
        "cdlp_sol_pct": rl.sol_pct(t["s"], roof),
        "cdlp_full_steps": stats["full_steps"],
        "cdlp_active_steps": stats["active_steps"],
        "baseline_cdlp_ms_per_iter_cpu": 1500.0,
    }


def pr_section(g, device, reps: int) -> dict:
    from graphtpu_torch.algorithms.pr import _pr_slab_kernel, heavy_slices
    from graphtpu_torch.ops.spmv import build_pull_plan

    out_deg = torch.from_numpy(g.out_degree.astype(np.int32)).to(device)
    damping = torch.tensor(0.85, dtype=torch.float32, device=device)
    plan = build_pull_plan(g, device=device, wdtype=np.float32, with_values=False)
    slices = heavy_slices(plan, torch.float32)
    _, t = timed(lambda: _pr_slab_kernel(plan, out_deg, damping, g.n, PR_ITERS, slices), device,
                 reps)
    roof = rl.roof_seconds(gathers=rl.plan_gather_count(plan) * PR_ITERS)
    return {"pr_nnz_per_s": g.nnz * PR_ITERS / t["s"], **_spread("pr_s", t),
            "pr_sol_pct": rl.sol_pct(t["s"], roof)}


def bfs_section(g, cfg, device, reps: int) -> dict:
    from graphtpu_torch.algorithms.bfs import bfs_adaptive_run

    (_, nit, stats), t = timed(lambda: bfs_adaptive_run(g, 0, cfg, with_stats=True), device,
                               reps)
    return {
        "bfs_gteps": g.nnz / t["s"] / 1e9,
        **_spread("bfs_s", t),
        "bfs_iters": int(nit),
        "bfs_sol_pct_volume": rl.sol_pct(t["s"], rl.bfs_executed_roof(stats, g.nnz, g.n)),
        "bfs_phase_steps": {
            **{f"tier_{e}": c for e, c in stats["tier_steps"].items()},
            "bottom_up": stats["bu_steps"],
            "dense": stats["dense_steps"],
        },
    }


def wcc_section(g, cfg, device, reps: int) -> dict:
    from graphtpu_torch.algorithms.wcc import wcc_adaptive_run

    (_, wit, st), t = timed(lambda: wcc_adaptive_run(g, cfg, with_stats=True), device, reps)
    wit = max(int(wit), 1)
    roof = rl.wcc_executed_roof(st["full_steps"], st["active_steps"], g.nnz, g.n, st["e_cap"],
                                st.get("plan_gathers"))
    return {**_spread("wcc_s", t), "wcc_iters": wit, "wcc_full_steps": st["full_steps"],
            "wcc_active_steps": st["active_steps"], "wcc_edges_per_s": g.nnz * wit / t["s"],
            "wcc_sol_pct": rl.sol_pct(t["s"], roof)}


def sssp_rungs(gw, cfg, device, reps: int, label: str) -> list:
    """The SSSP ladder: adaptive (with its step counts and sol_pct), delta,
    dense."""
    from graphtpu_torch.algorithms import sssp as sssp_mod

    def dense_run(gg, src, c):
        return sssp_mod._sssp_kernel(sssp_mod.sssp_prep(gg, torch.float32, c.device), src, gg.n,
                                     torch.float32)

    def rung(run_fn, stats_capable=False):
        def thunk():
            if stats_capable:
                (_, sit, st), t = timed(lambda: run_fn(gw, 0, cfg, with_stats=True), device,
                                        reps)
                roof = rl.sssp_executed_roof(st["full_steps"], st["active_steps"], gw.nnz, gw.n,
                                             st["e_cap"], st)
                extra = {"sssp_full_steps": st["full_steps"],
                         "sssp_active_steps": st["active_steps"],
                         "sssp_sol_pct": rl.sol_pct(t["s"], roof)}
            else:
                (_, sit), t = timed(lambda: run_fn(gw, 0, cfg), device, reps)
                extra = {}
            return {**_spread("sssp_s", t), "sssp_rounds": int(sit), "sssp_graph": label,
                    "sssp_nnz": gw.nnz, **extra}

        return thunk

    return [("adaptive", rung(sssp_mod.sssp_adaptive_run, stats_capable=True)),
            ("delta", rung(sssp_mod.sssp_delta_run)),
            ("dense", rung(dense_run))]


def lcc_section(g, cache_dir: str, device, reps: int) -> dict:
    from graphtpu_torch.ops.triangles import lcc_oriented, prepare_wedge_plan

    _sync(device)
    t0 = time.perf_counter()
    plan = prepare_wedge_plan(g, cache_dir=cache_dir, device=device)
    g.memo["wedge_plan", str(device)] = plan
    _sync(device)
    prep_s = time.perf_counter() - t0
    # timed() takes the cold run as its warm-up; time it on its own first
    t0 = time.perf_counter()
    lcc_oriented(g, cache_dir, device=device)
    _sync(device)
    cold_s = time.perf_counter() - t0
    coeff, t = timed(lambda: lcc_oriented(g, cache_dir, device=device), device, reps)
    probes = sum(b.slab.shape[1] * (b.slab.shape[0] * (b.slab.shape[0] - 1)) // 2
                 for b in plan.buckets)
    return {**_spread("lcc_s", t), "lcc_cold_s": cold_s, "lcc_prep_s": prep_s,
            "lcc_padded_probes": int(probes), "lcc_nonzero": int((coeff > 0).sum())}


def ingest_section(g, cache_dir: str, gname: str, device, reps: int) -> dict:
    """The bench graph as Graphalytics text, written once (each unordered
    pair once; original ids 7 v + 3, so that the relabel's join does real
    work), then parsed and relabelled into a Graph."""
    from graphtpu_torch.core.graph import Graph
    from graphtpu_torch.ingest import native
    from graphtpu_torch.ingest.relabel import parse_edge_file, parse_vertex_file

    gdir = Path(cache_dir) / gname
    vpath, epath = gdir / "graph.v", gdir / "graph.e"
    write_s = 0.0
    if not (vpath.exists() and epath.exists()):
        t0 = time.perf_counter()
        gdir.mkdir(parents=True, exist_ok=True)
        once = g.src < g.dst
        ids = np.arange(g.n, dtype=np.int64) * 7 + 3
        write_text(vpath, [ids])
        write_text(epath, [ids[g.src[once]], ids[g.dst[once]]])
        write_s = time.perf_counter() - t0
    native_on = native.available()

    def run():
        t0 = time.perf_counter()
        vids = parse_vertex_file(str(vpath))
        src, dst, _ = parse_edge_file(str(epath), False)
        t1 = time.perf_counter()
        g2 = Graph.from_original_ids(vids, src, dst, None, False, False)
        t2 = time.perf_counter()
        if g2.nnz != g.nnz:
            raise RuntimeError(f"ingest: {g2.nnz} edges read back, {g.nnz} written")
        return t1 - t0, t2 - t1, vids.shape[0] + src.shape[0]

    runs = []
    rows, t = timed(lambda: runs.append(run()) or runs[-1][2], device, reps)
    parse, relabel = ([r[j] for r in runs[1:]] for j in (0, 1))  # without the warm-up
    k = t["i"]
    return {
        "ingest_parse_s": parse[k], "ingest_parse_s_min": min(parse),
        "ingest_parse_s_max": max(parse),
        "ingest_relabel_s": relabel[k], "ingest_relabel_s_min": min(relabel),
        "ingest_relabel_s_max": max(relabel),
        **_spread("ingest_s", t),
        "ingest_rows": int(rows),
        "ingest_rows_per_s": rows / max(parse[k] + relabel[k], 1e-9),
        "ingest_parse_rows_per_s": rows / max(parse[k], 1e-9),
        "ingest_relabel_impl": "native-fused" if native_on else "numpy",
        "ingest_parser": "native" if native_on else "numpy",
        "ingest_text_write_s": write_s,
    }


# ---------------------------------------------------------------------- main


def run_bench() -> dict:
    """Every section; the JSON object the bench prints."""
    from graphtpu_torch.utils.config import PlatformConfig
    from graphtpu_torch.utils.sections import SectionRunner

    platform = os.environ.get("GRAPHTPU_BENCH_PLATFORM", "cuda")
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"GRAPHTPU_BENCH_PLATFORM={platform!r}: cuda or cpu")
    if platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: GRAPHTPU_BENCH_PLATFORM=cuda, but torch sees no CUDA card "
                         "(GRAPHTPU_BENCH_PLATFORM=cpu runs on the CPU, for tests)")
    device = torch.device("cuda:0" if platform == "cuda" else "cpu")
    _device_ping(device)
    name, limit = card() if platform == "cuda" else (None, None)

    scale = _env_int("GRAPHTPU_BENCH_SCALE", 20)
    edge_factor = _env_int("GRAPHTPU_BENCH_EDGE_FACTOR", 32)
    itermax = _env_int("GRAPHTPU_BENCH_ITERS", 10)
    reps = _env_int("GRAPHTPU_BENCH_REPS", 5)
    if reps < 1:
        raise ValueError(f"GRAPHTPU_BENCH_REPS={reps}: at least 1")
    cache_dir = os.environ.get("GRAPHTPU_BENCH_CACHE", "./intermediate")
    sections = {s.strip() for s in os.environ.get("GRAPHTPU_BENCH_SECTIONS", SECTIONS).split(",")
                if s.strip()}
    cfg = PlatformConfig(device=str(device), intermediate_dir=cache_dir)

    gname = f"bench-rmat-s{scale}-ef{edge_factor}"
    t0 = time.perf_counter()
    g = load_or_make(cache_dir, gname, scale, edge_factor, weighted=False)
    gen_s = time.perf_counter() - t0

    details = {"backend": device.type, "card": name, "power_limit": limit, "reps": reps,
               "graph": f"rmat scale={scale} ef={edge_factor} undirected", "n": g.n,
               "nnz_stored": g.nnz, "gen_s": gen_s}

    def section(label, fn):
        _reset_peak(device)
        out = fn()
        details[f"{label}_peak_device_bytes"] = _peak(device)
        _free_device_state(g)
        return out

    details.update(section("cdlp", lambda: cdlp_section(g, cfg, itermax, device, reps)))
    details.update(section("pr", lambda: pr_section(g, device, reps)))
    details.update(section("bfs", lambda: bfs_section(g, cfg, device, reps)))

    runner = SectionRunner(details, default_watchdog_s=600.0)

    def guarded(label, rungs, watchdog_s=None, graph=None):
        _reset_peak(device)
        out = runner.run(label, rungs, watchdog_s=watchdog_s)
        details[f"{label}_peak_device_bytes"] = _peak(device)
        if out:
            details.update(out)
        _free_device_state(g if graph is None else graph)

    if "wcc" in sections:
        guarded("wcc", [("auto:slab-adaptive", lambda: wcc_section(g, cfg, device, reps))])
    if "sssp" in sections:
        sscale = _env_int("GRAPHTPU_BENCH_SSSP_SCALE", 20)
        sef = _env_int("GRAPHTPU_BENCH_SSSP_EF", 16)
        gw = load_or_make(cache_dir, f"bench-rmat-s{sscale}-ef{sef}-w", sscale, sef,
                          weighted=True)
        guarded("sssp", sssp_rungs(gw, cfg, device, reps, f"rmat s{sscale}/ef{sef} weighted"),
                watchdog_s=900.0, graph=gw)
        del gw
    if "lcc" in sections:
        guarded("lcc", [("wedge", lambda: lcc_section(g, cache_dir, device, reps))],
                watchdog_s=1800.0)
    if "ingest" in sections:
        guarded("ingest", [("text", lambda: ingest_section(g, cache_dir, gname, device, reps))],
                watchdog_s=900.0)

    rate = details["cdlp_edges_per_s"]
    return {"metric": "cdlp_edges_per_s", "value": rate, "unit": "edges/s",
            "vs_baseline": rate / BASELINE_CDLP_EDGES_PER_S, "details": details}


# ------------------------------------------------------------------ scaling

SCALING_DEVICES = (1, 2, 4, 8)  # the first is every efficiency's base
SCALING_ITERS = 10  # PageRank's iterations and CDLP's itermax, as bench.py's
# the host NIC's rate (about 100 Gbit/s) that the two-host projection
# assumes: stated, not measured
DCN_GBPS = 12.5


def run_scaling() -> dict:
    """The scaling table (``bench.py:main_scaling``): the distributed
    PageRank (10 iterations), CDLP (10) and BFS (from vertex 0), each under
    its default loop (``parallel/algorithms.py``), on RMAT
    GRAPHTPU_SCALING_SCALE / _EDGE_FACTOR (16 / 16, undirected, seed 42)
    over D ranks for each D of SCALING_DEVICES (1, 2, 4, 8) that the
    platform holds. GRAPHTPU_SCALING_PLATFORM "cuda" (the default)
    runs NCCL ranks, one card each from cuda:0, up to the cards torch sees
    (one card: one row), and exits non-zero without a card; "cpu" runs gloo
    ranks on this host, which checks shapes and collectives, not speed-up.

    Each row holds the JAX row's keys and formulas: the median seconds of
    GRAPHTPU_BENCH_REPS timed runs (5) after one warm-up (which builds and
    installs the plans) as rates, each rate's efficiency against D times
    the D = 1 row's, the bytes each rank sends a step when it all-gathers
    its row block (rows_per_dev x (D - 1) x 4) and the share of pull edges
    whose source row lies on another rank. ``projected_2host`` models two
    hosts of one card each: a PageRank step's compute at the chip rate
    (GRAPHTPU_CHIP_NNZ_PER_S, else the D = 1 row's rate) against the
    all-gather of n/2 float32 over the host NIC at DCN_GBPS."""
    from graphtpu_torch.parallel import algorithms as dist
    from graphtpu_torch.parallel.mesh import close_mesh, make_mesh
    from graphtpu_torch.parallel.partition import ShardedGraph
    from graphtpu_torch.utils.synth import rmat_graph

    platform = os.environ.get("GRAPHTPU_SCALING_PLATFORM", "cuda")
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"GRAPHTPU_SCALING_PLATFORM={platform!r}: cuda or cpu")
    if platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench --scaling: GRAPHTPU_SCALING_PLATFORM=cuda, but torch sees no "
                         "CUDA card (GRAPHTPU_SCALING_PLATFORM=cpu runs gloo ranks)")
    device = torch.device("cuda:0" if platform == "cuda" else "cpu")
    _device_ping(device)
    name, limit = card() if platform == "cuda" else (None, None)
    scale = _env_int("GRAPHTPU_SCALING_SCALE", 16)
    edge_factor = _env_int("GRAPHTPU_SCALING_EDGE_FACTOR", 16)
    reps = _env_int("GRAPHTPU_BENCH_REPS", 5)
    if reps < 1:
        raise ValueError(f"GRAPHTPU_BENCH_REPS={reps}: at least 1")
    avail = torch.cuda.device_count() if platform == "cuda" else max(SCALING_DEVICES)
    counts = [d for d in SCALING_DEVICES if d <= avail]

    g = rmat_graph(scale, edge_factor, directed=False, seed=42)
    psrc, pdst, _ = g.pull_arrays()
    table = []
    try:
        for d in counts:
            sg = ShardedGraph(g, make_mesh(d, device))
            rows = sg.rows_per_dev
            edge_cut = float(np.mean((psrc // rows) != (pdst // rows))) if d > 1 else 0.0
            _, t_pr = timed(lambda: dist.pr_dist(sg, 0.85, SCALING_ITERS), device, reps)
            (_, it), t_cdlp = timed(lambda: dist.cdlp_dist(sg, SCALING_ITERS), device, reps)
            _, t_bfs = timed(lambda: dist.bfs_dist(sg, 0), device, reps)
            table.append({"devices": d,
                          "pr_nnz_per_s": g.nnz * SCALING_ITERS / t_pr["s"],
                          "cdlp_edges_per_s": 2 * g.nnz * max(it, 1) / t_cdlp["s"],
                          "bfs_teps": g.nnz / t_bfs["s"],
                          "bytes_per_iter_per_dev": rows * (d - 1) * 4,
                          "edge_cut_frac": edge_cut})
            sg.release()
    finally:
        close_mesh()
    base = table[0]
    for row in table:
        for rate, eff in (("pr_nnz_per_s", "pr_efficiency"),
                          ("cdlp_edges_per_s", "cdlp_efficiency"), ("bfs_teps", "bfs_efficiency")):
            row[eff] = row[rate] / (row["devices"] * base[rate])

    chip_rate = float(os.environ.get("GRAPHTPU_CHIP_NNZ_PER_S") or base["pr_nnz_per_s"])
    t1 = g.nnz / chip_rate
    t_comp2 = (g.nnz / 2) / chip_rate
    t_comm2 = (g.n / 2 * 4) / (DCN_GBPS * 1e9)
    projected = {
        "model": "2 hosts x 1 card; PR iter = comp(nnz/2 @ chip rate) + "
                 "host NIC all-gather(n/2 f32)",
        "chip_nnz_per_s": chip_rate,
        "chip_rate_from": ("GRAPHTPU_CHIP_NNZ_PER_S" if os.environ.get("GRAPHTPU_CHIP_NNZ_PER_S")
                           else "the D = 1 row"),
        "dcn_gbps": DCN_GBPS,
        "efficiency_no_overlap": t1 / (2 * (t_comp2 + t_comm2)),
        "efficiency_overlapped": t1 / (2 * max(t_comp2, t_comm2)),
    }
    if platform == "cpu":
        note = "gloo ranks on one host's cores: validates shapes and collectives, not speed-up"
    elif len(table) == 1:
        note = "one card: the table holds the D = 1 row only"
    else:
        note = f"NCCL ranks, one card each ({len(table)} rows)"
    top = table[-1]
    return {"metric": "pr_scaling_efficiency", "value": top["pr_efficiency"],
            "unit": f"ratio@{top['devices']}dev", "vs_baseline": top["pr_efficiency"] / 0.70,
            "details": {"backend": device.type, "card": name, "power_limit": limit,
                        "reps": reps, "graph": f"rmat scale={scale} ef={edge_factor} undirected",
                        "n": g.n, "nnz_stored": g.nnz, "note": note, "table": table,
                        "projected_2host": projected}}


def main() -> int:
    out = run_scaling() if "--scaling" in sys.argv[1:] else run_bench()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
