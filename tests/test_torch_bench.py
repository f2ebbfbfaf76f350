"""The port's bench (graphtpu_torch/bench.py), run in process on the CPU at
RMAT scale 8: its JSON keys are the JAX bench's (bench.py) less the
documented omissions plus the port's additions, and its step and
iteration counts equal what the JAX package's adaptive runs return with
stats on the same graphs. ``_free_device_state`` empties the Graph's memo,
and without a card the bench exits non-zero instead of running on the CPU."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from graphtpu_torch import bench

REPO = Path(__file__).resolve().parents[1]
SCALE, EF, ITERS = 8, 8, 10

# the keys of bench.py's "details" (bench.py:334-367, 415-423, 446-473,
# 541-548, 612-634, and the ladders' <name>_impl_used)
JAX_KEYS = {
    "backend", "graph", "n", "nnz_stored", "cdlp_ms_per_iter", "cdlp_iters", "cdlp_sol_pct",
    "cdlp_sol_pct_nominal", "cdlp_full_steps", "cdlp_active_steps",
    "baseline_cdlp_ms_per_iter_cpu", "pr_nnz_per_s", "pr_sol_pct", "bfs_gteps", "bfs_iters",
    "bfs_sol_pct", "bfs_sol_pct_volume", "bfs_sol_pct_vs_edge_sweep", "bfs_phase_steps",
    "gen_s", "wcc_s", "wcc_iters", "wcc_full_steps", "wcc_active_steps", "wcc_edges_per_s",
    "wcc_sol_pct", "wcc_sol_pct_nominal", "wcc_impl_used", "sssp_s", "sssp_rounds",
    "sssp_graph", "sssp_nnz", "sssp_sol_pct_vs_one_pass", "sssp_full_steps",
    "sssp_active_steps", "sssp_sol_pct", "sssp_impl_used", "lcc_s", "lcc_cold_s",
    "lcc_prep_s", "lcc_padded_probes", "lcc_sol_pct", "lcc_nonzero", "lcc_impl_used",
    "ingest_parse_s", "ingest_relabel_s", "ingest_rows", "ingest_rows_per_s",
    "ingest_parse_rows_per_s", "ingest_relabel_impl", "ingest_parser", "ingest_text_write_s",
    "ingest_impl_used",
}
# nominal ratios above 100 % by design, and the two shares priced by TPU
# step costs or by hash probes the port does not make
OMITTED = {"cdlp_sol_pct_nominal", "wcc_sol_pct_nominal", "bfs_sol_pct_vs_edge_sweep",
           "sssp_sol_pct_vs_one_pass", "bfs_sol_pct", "lcc_sol_pct"}
SECTIONS = ("cdlp", "pr", "bfs", "wcc", "sssp", "lcc", "ingest")
ADDED = (
    {"card", "power_limit", "reps", "cdlp_edges_per_s", "cdlp_s", "pr_s", "bfs_s", "ingest_s"}
    | {f"{s}_peak_device_bytes" for s in SECTIONS}
    | {f"{p}_{x}" for p in ("cdlp_s", "pr_s", "bfs_s", "wcc_s", "sssp_s", "lcc_s", "ingest_s")
       for x in ("min", "max", "event_s")}
    | {f"ingest_{p}_s_{x}" for p in ("parse", "relabel") for x in ("min", "max")}
)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    cache = tmp_path_factory.mktemp("bench-cache")
    env = {"GRAPHTPU_BENCH_PLATFORM": "cpu", "GRAPHTPU_BENCH_SCALE": str(SCALE),
           "GRAPHTPU_BENCH_EDGE_FACTOR": str(EF), "GRAPHTPU_BENCH_ITERS": str(ITERS),
           "GRAPHTPU_BENCH_SSSP_SCALE": str(SCALE), "GRAPHTPU_BENCH_SSSP_EF": str(EF),
           "GRAPHTPU_BENCH_REPS": "3", "GRAPHTPU_BENCH_CACHE": str(cache)}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        out = bench.run_bench()
    json.dumps(out)  # one JSON line
    return out, cache


def _jax_twin(cache, name):
    from graphtpu.core.graph import Graph as JGraph

    from graphtpu_torch.ingest import cache as cache_mod

    g = cache_mod.load(cache, name)
    return JGraph(g.n, g.src, g.dst, g.w if g.weighted else None, g.mapping, g.directed,
                  g.weighted)


def test_keys_are_jax_less_omissions_plus_additions(result):
    out, _ = result
    src = (REPO / "bench.py").read_text()
    for k in JAX_KEYS - {"wcc_impl_used", "sssp_impl_used", "lcc_impl_used",
                         "ingest_impl_used"}:
        assert re.search(rf"\b{k}\b", src), k  # each is a key the JAX bench prints
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "details"}
    assert out["metric"] == "cdlp_edges_per_s" and out["unit"] == "edges/s"
    d = out["details"]
    assert set(d) == (JAX_KEYS - OMITTED) | ADDED, (
        set(d) ^ ((JAX_KEYS - OMITTED) | ADDED))
    assert not [k for k in d if k.endswith("_error") or k.endswith("_errors")]
    assert d["backend"] == "cpu" and d["card"] is None and d["reps"] == 3
    assert d["wcc_impl_used"] == "auto:slab-adaptive" and d["sssp_impl_used"] == "adaptive"
    assert (d["lcc_impl_used"], d["ingest_impl_used"]) == ("wedge", "text")
    assert out["value"] == d["cdlp_edges_per_s"] > 0


def test_times_rates_and_shares(result):
    d = result[0]["details"]
    for p in ("cdlp_s", "pr_s", "bfs_s", "wcc_s", "sssp_s", "lcc_s", "ingest_s"):
        assert 0 < d[f"{p}_min"] <= d[p] <= d[f"{p}_max"], p
        assert d[f"{p}_event_s"] is None  # no CUDA events on the CPU
    for k in ("pr_nnz_per_s", "bfs_gteps", "wcc_edges_per_s", "ingest_rows_per_s"):
        assert d[k] > 0, k
    for k in ("cdlp_sol_pct", "pr_sol_pct", "bfs_sol_pct_volume", "wcc_sol_pct",
              "sssp_sol_pct"):
        assert 0 < d[k] <= 100, k
    assert d["cdlp_ms_per_iter"] == pytest.approx(d["cdlp_s"] * 1e3 / d["cdlp_iters"])
    assert d["pr_nnz_per_s"] == pytest.approx(d["nnz_stored"] * 20 / d["pr_s"])
    assert all(d[f"{s}_peak_device_bytes"] is None for s in SECTIONS)
    assert d["ingest_rows"] == d["n"] + d["nnz_stored"] // 2
    assert d["ingest_parser"] == "native" and d["ingest_text_write_s"] > 0


def test_counts_equal_the_jax_packages(result):
    """The bench's step and iteration counts against the JAX package's
    adaptive runs with stats on the same graphs, default configuration."""
    from graphtpu.algorithms.bfs import bfs_adaptive_run
    from graphtpu.algorithms.cdlp import build_incidence
    from graphtpu.algorithms.sssp import sssp_adaptive_run
    from graphtpu.algorithms.wcc import wcc_adaptive_run
    from graphtpu.ops.active import cdlp_adaptive_device_run, prepare_cdlp_adaptive
    from graphtpu.utils.config import PlatformConfig as JConfig

    out, cache = result
    d = out["details"]
    jg = _jax_twin(cache, f"bench-rmat-s{SCALE}-ef{EF}")
    assert (jg.n, jg.nnz) == (d["n"], d["nnz_stored"])
    cfg = JConfig()

    centers, neigh = build_incidence(jg)
    deg = np.bincount(centers, minlength=jg.n).astype(np.int32)
    prep = prepare_cdlp_adaptive(jg, centers, neigh, deg, cfg)
    _, it, st = cdlp_adaptive_device_run(jg, centers, neigh, deg, ITERS, cfg, prep,
                                         with_stats=True)
    assert (d["cdlp_iters"], d["cdlp_full_steps"], d["cdlp_active_steps"]) == \
        (max(int(it), 1), st["full_steps"], st["active_steps"])

    _, nit, st = bfs_adaptive_run(jg, 0, cfg, with_stats=True)
    assert d["bfs_iters"] == int(nit)
    assert d["bfs_phase_steps"] == {**{f"tier_{e}": c for e, c in st["tier_steps"].items()},
                                    "bottom_up": st["bu_steps"], "dense": st["dense_steps"]}

    _, wit, st = wcc_adaptive_run(jg, cfg, with_stats=True)
    assert (d["wcc_iters"], d["wcc_full_steps"], d["wcc_active_steps"]) == \
        (max(int(wit), 1), st["full_steps"], st["active_steps"])

    jgw = _jax_twin(cache, f"bench-rmat-s{SCALE}-ef{EF}-w")
    assert d["sssp_nnz"] == jgw.nnz
    _, sit, st = sssp_adaptive_run(jgw, 0, cfg, with_stats=True)
    assert (d["sssp_rounds"], d["sssp_full_steps"], d["sssp_active_steps"]) == \
        (int(sit), st["full_steps"], st["active_steps"])


def test_lcc_nonzero_equals_the_sweep(result):
    from graphtpu_torch.algorithms.lcc import lcc_sweep_numerator
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.ops.triangles import coefficients

    out, cache = result
    g = cache_mod.load(cache, f"bench-rmat-s{SCALE}-ef{EF}")
    coeff = coefficients(*lcc_sweep_numerator(g, "cpu"))
    assert out["details"]["lcc_nonzero"] == int((coeff > 0).sum()) > 0


def test_free_device_state_empties_the_memo(result):
    """Every plan the sections memoize on the Graph, and its device views,
    are gone afterwards."""
    from graphtpu_torch.algorithms.common import run_algorithm
    from graphtpu_torch.ingest import cache as cache_mod
    from graphtpu_torch.utils.config import AlgorithmParams, PlatformConfig

    _, cache = result
    g = cache_mod.load(cache, f"bench-rmat-s{SCALE}-ef{EF}")
    cfg = PlatformConfig(device="cpu", intermediate_dir=str(cache))
    for algo, params in (("cdlp", AlgorithmParams(max_iterations=3)),
                         ("pr", AlgorithmParams(damping_factor=0.85, num_iterations=2)),
                         ("bfs", AlgorithmParams(source_vertex=int(g.mapping[0]))),
                         ("wcc", AlgorithmParams()), ("lcc", AlgorithmParams())):
        run_algorithm(algo, g, params, cfg)
    g.device_pull("cpu")
    assert len(g.memo) >= 5 and g._device_views
    bench._free_device_state(g)
    assert g.memo == {} and g._device_views == {}


def test_no_card_exits_nonzero_without_a_result(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("GRAPHTPU_BENCH_")}
    env.update(CUDA_VISIBLE_DEVICES="", GRAPHTPU_BENCH_SCALE="6", GRAPHTPU_BENCH_CACHE=str(tmp_path),
               PYTHONPATH=os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-m", "graphtpu_torch.bench"], capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr
    assert not list(tmp_path.iterdir())  # nothing generated, nothing run


# the keys of bench.py:main_scaling's line, its "details" and a table row
SCALING_DETAILS = {"backend", "graph", "n", "nnz_stored", "note", "table", "projected_2host"}
SCALING_ROW = {"devices", "pr_nnz_per_s", "cdlp_edges_per_s", "bfs_teps",
               "bytes_per_iter_per_dev", "edge_cut_frac", "pr_efficiency", "cdlp_efficiency",
               "bfs_efficiency"}


def test_scaling_mode_on_gloo_ranks(monkeypatch):
    """The scaling mode (``--scaling``, bench.py:main_scaling) with
    GRAPHTPU_SCALING_PLATFORM=cpu on RMAT scale 8 over 1 and 2 gloo ranks:
    the JAX line's keys and row keys (plus card, power_limit and reps),
    bytes_per_iter_per_dev and edge_cut_frac by the JAX formula on the JAX
    package's ShardedGraph of the same graph, efficiencies against the
    D = 1 row, and no TPU constant in the line (the chip rate is the
    D = 1 row's)."""
    from graphtpu.parallel import ShardedGraph as JShardedGraph
    from graphtpu.parallel import make_mesh as j_make_mesh
    from graphtpu.utils.synth import rmat_graph as j_rmat_graph

    src = (REPO / "bench.py").read_text()
    for k in SCALING_DETAILS | SCALING_ROW:
        assert re.search(rf'"{k}"', src), k  # each is a key the JAX bench prints
    for k, v in {"GRAPHTPU_SCALING_PLATFORM": "cpu", "GRAPHTPU_SCALING_SCALE": "8",
                 "GRAPHTPU_SCALING_EDGE_FACTOR": "8", "GRAPHTPU_BENCH_REPS": "2"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "SCALING_DEVICES", (1, 2))
    monkeypatch.delenv("GRAPHTPU_CHIP_NNZ_PER_S", raising=False)
    out = bench.run_scaling()
    line = json.dumps(out)
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "details"}
    assert (out["metric"], out["unit"]) == ("pr_scaling_efficiency", "ratio@2dev")
    d = out["details"]
    assert set(d) == SCALING_DETAILS | {"card", "power_limit", "reps"}
    assert (d["backend"], d["card"], d["reps"]) == ("cpu", None, 2)
    jg = j_rmat_graph(8, 8, directed=False, seed=42)
    assert (d["n"], d["nnz_stored"]) == (jg.n, jg.nnz)
    psrc, pdst, _ = jg.pull_arrays()
    assert [row["devices"] for row in d["table"]] == [1, 2]
    for row in d["table"]:
        assert set(row) == SCALING_ROW
        D = row["devices"]
        rows = JShardedGraph(jg, j_make_mesh(D)).rows_per_dev
        assert row["bytes_per_iter_per_dev"] == rows * (D - 1) * 4
        assert row["edge_cut_frac"] == (
            float(np.mean((psrc // rows) != (pdst // rows))) if D > 1 else 0.0)
        for rate, eff in (("pr_nnz_per_s", "pr_efficiency"),
                          ("cdlp_edges_per_s", "cdlp_efficiency"), ("bfs_teps", "bfs_efficiency")):
            assert row[rate] > 0
            assert row[eff] == pytest.approx(row[rate] / (D * d["table"][0][rate]))
    assert out["value"] == d["table"][-1]["pr_efficiency"]
    p = d["projected_2host"]
    assert p["chip_nnz_per_s"] == d["table"][0]["pr_nnz_per_s"] and p["dcn_gbps"] == 12.5
    assert "ici_gbps" not in line and "3.7e8" not in line and "370000000" not in line
    assert "45.0" not in line


def test_scaling_without_a_card_exits_nonzero(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("GRAPHTPU_SCALING_")}
    env.update(CUDA_VISIBLE_DEVICES="", GRAPHTPU_SCALING_SCALE="6",
               PYTHONPATH=os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-m", "graphtpu_torch.bench", "--scaling"],
                          capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr
