"""The graphtpu_torch slice end to end, on the CPU: CDLP and PageRank
against the JAX package's run_algorithm, the golden fixtures through the
port's platform lifecycle and CLI, and the port's import hygiene.

CDLP labels and iteration counts must be bit-identical. PageRank is held
to rtol 1e-5 / atol 1e-9 at float32: the slab sums add in other orders.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graphtpu.algorithms.common import run_algorithm as j_run_algorithm
from graphtpu.utils.config import AlgorithmParams as JParams
from graphtpu.utils.config import PlatformConfig as JConfig
from graphtpu.utils.synth import rmat_graph as j_rmat_graph

from graphtpu_torch.algorithms.cdlp import _cdlp_sort_kernel, build_incidence
from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.cli import main as cli_main
from graphtpu_torch.core.graph import Graph
from graphtpu_torch.harness.platform import GraphTorchPlatform
from graphtpu_torch.harness.validator import validate_result
from graphtpu_torch.utils.config import AlgorithmParams, GraphSpec, PlatformConfig

from torch_native_env import jax_native_on_port_build  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

GOLDENS = [
    ("example-directed", "pr"), ("example-undirected", "pr"),
    ("test-pr-directed", "pr"), ("test-pr-undirected", "pr"),
    ("example-directed", "cdlp"), ("example-undirected", "cdlp"),
    ("test-cdlp-directed", "cdlp"), ("test-cdlp-undirected", "cdlp"),
]


def _twins(directed, seed, scale=10, ef=12):
    jg = j_rmat_graph(scale, ef, directed=directed, seed=seed)
    tg = Graph.from_arrays(jg.n, jg.src, jg.dst, None, jg.mapping, directed, False)
    return jg, tg


@pytest.mark.parametrize("buckets", [None, (4, 8)])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("directed", [True, False])
def test_cdlp_matches_jax(directed, seed, buckets):
    jg, tg = _twins(directed, seed)
    want = j_run_algorithm(
        "cdlp", jg, JParams(max_iterations=10), JConfig(cdlp_impl="slab", slab_buckets=buckets)
    )
    got = run_algorithm(
        "cdlp", tg, AlgorithmParams(max_iterations=10),
        PlatformConfig(device="cpu", cdlp_impl="slab", slab_buckets=buckets),
    )
    np.testing.assert_array_equal(got.values, want.values)
    assert got.iterations == want.iterations


@pytest.mark.parametrize("directed", [True, False])
def test_pr_matches_jax(directed):
    jg, tg = _twins(directed, 0)
    params = dict(damping_factor=0.85, num_iterations=20)
    want = j_run_algorithm("pr", jg, JParams(**params), JConfig())
    got = run_algorithm("pr", tg, AlgorithmParams(**params), PlatformConfig(device="cpu"))
    assert got.values.dtype == np.float32
    np.testing.assert_allclose(got.values, want.values, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("directed", [True, False])
def test_sort_oracle_equals_slab_path(directed):
    _, tg = _twins(directed, 1)
    cfg = PlatformConfig(device="cpu", cdlp_impl="slab")
    slab = run_algorithm("cdlp", tg, AlgorithmParams(max_iterations=10), cfg)
    centers, neigh = build_incidence(tg)
    deg = np.bincount(centers, minlength=tg.n).astype(np.int32)
    labels, it = _cdlp_sort_kernel(
        torch.from_numpy(centers), torch.from_numpy(neigh), torch.from_numpy(deg), tg.n, 10
    )
    np.testing.assert_array_equal(tg.mapping[labels.numpy()], slab.values)
    assert it == slab.iterations
    sort = run_algorithm("cdlp", tg, AlgorithmParams(max_iterations=10),
                         PlatformConfig(device="cpu", cdlp_impl="sort"))
    np.testing.assert_array_equal(sort.values, slab.values)


def test_cdlp_auto_resolves_to_slab_and_adaptive_is_refused():
    """(Named for the first slice's behaviour.) auto and adaptive now run
    the adaptive device path, which agrees with slab; an unknown impl, an
    unknown pr-impl and an unknown algorithm are refused (pr-impl=scan runs
    since its port, and segment, the JAX package's name of that arm, as
    scan: tests/test_torch_pr_scan.py)."""
    _, tg = _twins(False, 0, scale=8, ef=4)
    params = AlgorithmParams(max_iterations=5)
    auto = run_algorithm("cdlp", tg, params, PlatformConfig(device="cpu"))
    assert any(k[0] == "cdlp_adaptive_prep" for k in tg.memo if isinstance(k, tuple))
    slab = run_algorithm("cdlp", tg, params, PlatformConfig(device="cpu", cdlp_impl="slab"))
    np.testing.assert_array_equal(auto.values, slab.values)
    assert auto.iterations == slab.iterations
    for impl in ("adaptive", "adaptive-host"):
        res = run_algorithm("cdlp", tg, params, PlatformConfig(device="cpu", cdlp_impl=impl))
        np.testing.assert_array_equal(res.values, auto.values)
        assert res.iterations == auto.iterations
    with pytest.raises(ValueError, match="unknown cdlp-impl"):
        run_algorithm("cdlp", tg, params, PlatformConfig(device="cpu", cdlp_impl="hash"))
    with pytest.raises(ValueError, match="unknown pr-impl"):
        run_algorithm("pr", tg, AlgorithmParams(damping_factor=0.85, num_iterations=2),
                      PlatformConfig(device="cpu", pr_impl="bogus"))
    with pytest.raises(ValueError, match="unknown algorithm"):
        run_algorithm("tc", tg, AlgorithmParams(), PlatformConfig(device="cpu"))
    # lcc, the last algorithm to be ported, is in the registry
    res = run_algorithm("lcc", tg, AlgorithmParams(), PlatformConfig(device="cpu"))
    assert res.values.shape == (tg.n,) and 0.0 < res.values.max() <= 1.0


def test_cdlp_iteration_timing_and_edgeless_graph(capsys):
    _, tg = _twins(True, 0, scale=8, ef=4)
    res = run_algorithm("cdlp", tg, AlgorithmParams(max_iterations=3),
                        PlatformConfig(device="cpu", iteration_timing=True))
    timer_lines = [ln for ln in capsys.readouterr().out.splitlines() if "[CUDA][TIMER]" in ln]
    assert len(timer_lines) == res.iterations
    empty = Graph(4, np.empty(0, np.int32), np.empty(0, np.int32), None,
                  np.array([10, 11, 12, 13]), True, False)
    res = run_algorithm("cdlp", empty, AlgorithmParams(max_iterations=3), PlatformConfig(device="cpu"))
    assert res.values.tolist() == [10, 11, 12, 13] and res.iterations == 0


@pytest.mark.parametrize("name,algo", GOLDENS)
def test_golden_through_platform(fixtures_dir, tmp_path, name, algo):
    spec = GraphSpec.from_properties(fixtures_dir / f"{name}.properties")
    plat = GraphTorchPlatform(PlatformConfig(device="cpu", intermediate_dir=str(tmp_path)))
    plat.verify_setup()
    plat.load_graph(spec)
    plat.startup(log_dir=str(tmp_path / "logs"))
    plat.prepare(spec, algo)
    res = plat.run(spec, algo)
    metrics = plat.finalize()
    assert metrics.processing_time_seconds >= 0
    assert (tmp_path / "logs" / "platform" / "runner.logs").exists()
    ok, msg = validate_result(res, plat.graphs[spec.name], str(fixtures_dir / f"{name}-{algo.upper()}"))
    assert ok, msg
    # the second load hits the binary cache
    assert plat.load_graph(spec).nnz == plat.graphs[spec.name].nnz


@pytest.mark.parametrize("name,algo", GOLDENS)
def test_golden_through_cli(fixtures_dir, tmp_path, capsys, name, algo):
    rc = cli_main([
        "run", "--graph-properties", str(fixtures_dir / f"{name}.properties"),
        "--algorithm", algo, "--device", "cpu", "--intermediate-dir", str(tmp_path),
        "--output-file", str(tmp_path / "out"),
        "--validation-file", str(fixtures_dir / f"{name}-{algo.upper()}"),
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "validation: PASS" in out, out
    assert (tmp_path / "out").read_text().count("\n") == GraphSpec.from_properties(
        fixtures_dir / f"{name}.properties").num_vertices


def test_cli_module_entry_point(fixtures_dir, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "graphtpu_torch.cli", "run",
         "--graph-properties", str(fixtures_dir / "example-undirected.properties"),
         "--algorithm", "cdlp", "--device", "cpu", "--intermediate-dir", str(tmp_path),
         "--validation-file", str(fixtures_dir / "example-undirected-CDLP")],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "validation: PASS" in proc.stdout


def test_port_imports_no_jax_graphtpu_or_pandas():
    code = (
        "import importlib, pkgutil, sys\n"
        "import graphtpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(graphtpu_torch.__path__, 'graphtpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k.startswith(('jax', 'graphtpu.', 'pandas')) or k == 'graphtpu']\n"
        "assert len(mods) >= 56, mods\n"
        "for m in ('algorithms.lcc', 'ops.edgehash', 'ops.triangles', 'ingest.grb',\n"
        "          'ingest.native', 'ingest.mm', 'ingest.download', 'core.spops',\n"
        "          'core.spgemm', 'bench', 'utils.sections', 'utils.roofline',\n"
        "          'parallel.mesh', 'parallel.partition', 'parallel.multihost',\n"
        "          'parallel.algorithms', 'parallel.dispatch', 'parallel.checkpoint'):\n"
        "    assert 'graphtpu_torch.' + m in mods, m\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_package_docstring_names_what_the_port_holds():
    """The package's docstring names the six algorithms, the harness, the
    ingest, the GraphBLAS surface, the sharded checkpoints, the scaling
    mode and every hand kernel K1-K23 by name."""
    import graphtpu_torch
    from graphtpu_torch.ops import kernels

    doc = " ".join(graphtpu_torch.__doc__.split())
    for words in ("PageRank", "CDLP", "BFS", "WCC", "SSSP", "LCC", "harness", "ingest",
                  "GraphBLAS", "core/spops.py", "core/spgemm.py", "sharded checkpoints",
                  "shard-checkpoints", "--scaling", "module for module"):
        assert words in doc, words
    for k, name in enumerate(kernels.KERNELS, start=1):
        assert f"K{k} {name}" in doc, name


def _fake_profiler(monkeypatch, counts_per_trace):
    """torch.profiler.profile replaced by traces whose one device record
    has the given counts, one trace after another; returns the list of
    traces taken."""
    import torch.profiler

    taken = []

    class Event:
        key, self_device_time_total = "some_kernel", 1000.0

        class device_type:
            name = "CUDA"

    class Trace:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            ev = Event()
            ev.count = counts_per_trace[len(taken) - 1]
            return [ev]

    def fake_profile(**kw):
        taken.append(kw)
        return Trace()

    monkeypatch.setattr(torch.profiler, "profile", fake_profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return taken


def test_tools_device_ms_retakes_a_trace_that_lost_records(monkeypatch, capsys):
    """The tools' shared device_ms (tools/trace_times.py, loaded by path as
    the tools load it) takes a trace again while a record's count is not a
    whole multiple of the calls, and fails after five such traces."""
    import runpy

    device_ms = runpy.run_path(str(REPO / "graphtpu_torch" / "tools" / "trace_times.py"))[
        "device_ms"]
    taken = _fake_profiler(monkeypatch, [7, 10, 20])
    assert device_ms(lambda: None, reps=10) == 1000.0 / 1e3 / 10
    assert len(taken) == 2 and "7 records in 10 calls" in capsys.readouterr().out
    taken = _fake_profiler(monkeypatch, [3] * 5)
    with pytest.raises(RuntimeError, match="5 traces in a row"):
        device_ms(lambda: None, reps=10)
    assert len(taken) == 5
    for tool in ("csr_row_times", "slab_bucket_times", "wedge_bucket_times"):
        ns = runpy.run_path(str(REPO / "graphtpu_torch" / "tools" / f"{tool}.py"))
        assert ns["device_ms"].__code__.co_filename.endswith("trace_times.py"), tool
