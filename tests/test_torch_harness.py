"""The port's benchmark harness on the CPU, against the JAX package's:
BenchmarkConfig and platform.properties parsing, the suite in both job
isolation modes with its reports, the killable subprocess job and the
fault-injection hook, the CLI commands, the profile-dir trace and the
delete-graph hook. Every job here runs with device=cpu.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from graphtpu.harness.suite import BenchmarkSuite as JSuite
from graphtpu.harness.suite import RunRecord as JRunRecord
from graphtpu.utils.config import BenchmarkConfig as JBenchmarkConfig
from graphtpu.utils.config import _PLATFORM_PROPS as J_PROPS
from graphtpu.utils.config import PlatformConfig as JConfig

from graphtpu_torch.cli import main as cli_main
from graphtpu_torch.harness.platform import GraphTorchPlatform
from graphtpu_torch.harness.suite import BenchmarkSuite, RunRecord
from graphtpu_torch.ingest import cache as cache_mod
from graphtpu_torch.utils.config import (
    _PLATFORM_PROPS, BenchmarkConfig, GraphSpec, PlatformConfig,
)

from torch_native_env import jax_native_on_port_build  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TEMPLATE = REPO / "config-template" / "benchmark.properties"
ALGOS = ["bfs", "pr", "wcc", "cdlp", "lcc", "sssp"]


def _bench(fixtures_dir, tmp_path, **over):
    fields = dict(graphs=["example-directed"], algorithms=["bfs"], graphs_root=str(fixtures_dir),
                  output_dir=str(tmp_path / "out"), report_dir=str(tmp_path / "report"))
    return BenchmarkConfig(**{**fields, **over})


def _cpu(tmp_path, **over):
    return PlatformConfig(device="cpu", intermediate_dir=str(tmp_path / "im"), **over)


def _cli(*argv, cwd=None, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}{env.get('PYTHONPATH', '')}"
    return subprocess.run([sys.executable, "-m", "graphtpu_torch.cli", *argv],
                          capture_output=True, text=True, env=env, cwd=cwd, timeout=timeout)


@pytest.mark.parametrize("source", ["template", "temp file"])
def test_benchmark_config_matches_jax(tmp_path, source):
    path = TEMPLATE
    if source == "temp file":
        path = tmp_path / "conf" / "bench.properties"
        path.parent.mkdir()
        path.write_text(
            "benchmark.custom.graphs = a, b ,c\n"
            "benchmark.custom.algorithms = BFS, pr\n"
            "benchmark.custom.timeout = 17\n"
            "benchmark.custom.output-required = false\n"
            "benchmark.custom.validation-required = false\n"
            "benchmark.custom.repetitions = 3\n"
            "benchmark.custom.job-isolation = InProcess\n"
            "graphs.root-directory = ../graphs\n"
            "graphs.validation-directory = /abs/golden\n"
            "benchmark.output-directory = out\n"
            "benchmark.report-directory = rep\n"
        )
    got = dataclasses.asdict(BenchmarkConfig.from_properties(path))
    assert got == dataclasses.asdict(JBenchmarkConfig.from_properties(path))
    assert dataclasses.asdict(BenchmarkConfig()) == dataclasses.asdict(JBenchmarkConfig())
    assert BenchmarkConfig().job_isolation == "subprocess"
    if source == "temp file":
        assert got["graphs_root"] == str(tmp_path / "graphs")
        assert got["job_isolation"] == "inprocess"


def test_benchmark_config_refuses_an_unknown_isolation(tmp_path):
    path = tmp_path / "b.properties"
    path.write_text("benchmark.custom.job-isolation = thread\n")
    with pytest.raises(ValueError, match="job-isolation"):
        BenchmarkConfig.from_properties(path)


def test_platform_config_properties_roundtrip(tmp_path):
    """to_properties then from_properties gives the same config, device
    included; the JAX package reads the file's shared keys alike."""
    cfg = PlatformConfig(
        device="cpu", precision="float64", pr_impl="scan", spmv_impl="xla", cdlp_impl="sort",
        skip_convergence_checks=3, profile_dir=str(tmp_path / "prof"),
        fault_injection="hang:pr", intermediate_dir=str(tmp_path / "im"),
        slab_buckets=(4, 8, 16), iteration_timing=True, sssp_delta=0.5, lcc_impl="sweep",
    )
    p = tmp_path / "platform.properties"
    cfg.to_properties(p)
    assert "platform.graphtpu.device = cpu" in p.read_text()
    back = PlatformConfig.from_properties(p)
    assert back == cfg
    jback = JConfig.from_properties(p)
    written = [line.split(" = ")[0] for line in p.read_text().splitlines()]
    assert len(written) == 13
    for key in set(written) & set(J_PROPS):
        attr = _PLATFORM_PROPS[key][0]
        assert getattr(jback, attr) == getattr(cfg, attr), key
    PlatformConfig().to_properties(p)  # all defaults: nothing to write
    assert PlatformConfig.from_properties(p) == PlatformConfig()


def test_inprocess_suite_validates_every_job_with_jax_report_fields(fixtures_dir, tmp_path):
    cfg = _bench(fixtures_dir, tmp_path, graphs=["example-directed", "example-undirected"],
                 algorithms=ALGOS, job_isolation="inprocess")
    records = BenchmarkSuite(cfg, _cpu(tmp_path)).run()
    assert len(records) == 12
    assert all(r.success and r.validated is True for r in records), \
        [(r.graph, r.algorithm, r.error) for r in records]
    assert all(r.processing_time_seconds >= 0 and r.makespan_seconds > 0 for r in records)
    assert [f.name for f in dataclasses.fields(RunRecord)] == \
        [f.name for f in dataclasses.fields(JRunRecord)]
    out = (tmp_path / "out" / "example-directed-BFS").read_text().splitlines()
    assert len(out) == 10
    # the JAX suite's report writer, given the same records, writes the
    # same files but for the platform's name
    jreport = tmp_path / "jreport"
    jsuite = JSuite(JBenchmarkConfig(report_dir=str(jreport)))
    jsuite.records = [JRunRecord(**r.to_json()) for r in records]
    jsuite.write_report()
    report = tmp_path / "report"
    summary = json.loads((report / "summary.json").read_text())
    jsummary = json.loads((jreport / "summary.json").read_text())
    assert summary["platform"] == "graphtpu_torch" and jsummary["platform"] == "graphtpu"
    assert {**summary, "platform": None} == {**jsummary, "platform": None}
    assert summary["succeeded"] == 12 and summary["failed"] == 0
    assert (report / "runs.jsonl").read_text() == (jreport / "runs.jsonl").read_text()
    lines, jlines = ((d / "report.txt").read_text().splitlines() for d in (report, jreport))
    assert lines[0] == "graphtpu_torch benchmark report" and lines[1:] == jlines[1:]


def test_suite_records_failures_and_goes_on(fixtures_dir, tmp_path):
    """An unresolvable graph and a job that raises are failed records; the
    next job still runs, and the report is written."""
    cfg = _bench(fixtures_dir, tmp_path, graphs=["no-such-graph", "example-directed"],
                 algorithms=["bfs", "wcc"], job_isolation="inprocess")
    suite = BenchmarkSuite(cfg, _cpu(tmp_path))
    spec = suite._resolve_spec("example-directed")
    spec.params["bfs"].source_vertex = None
    rec = suite.run_one(spec, "bfs", 0)
    assert not rec.success and "source-vertex" in rec.error
    records = suite.run()
    assert [r.success for r in records] == [False, False, True, True]
    assert "graph unresolvable" in records[1].error
    assert json.loads((tmp_path / "report" / "summary.json").read_text())["failed"] == 2


def test_inprocess_hang_is_stopped_by_the_alarm(fixtures_dir, tmp_path):
    cfg = _bench(fixtures_dir, tmp_path, algorithms=["bfs", "pr"], job_isolation="inprocess",
                 timeout_seconds=8)
    t0 = time.perf_counter()
    records = BenchmarkSuite(cfg, _cpu(tmp_path, fault_injection="hang:bfs")).run()
    assert time.perf_counter() - t0 < 60
    assert not records[0].success and records[0].error == "timeout after 8s"
    assert records[1].success and records[1].validated is True


def test_subprocess_job_runs_and_validates(fixtures_dir, tmp_path):
    cfg = _bench(fixtures_dir, tmp_path, timeout_seconds=300)
    assert cfg.job_isolation == "subprocess"
    records = BenchmarkSuite(cfg, _cpu(tmp_path)).run()
    assert len(records) == 1
    rec = records[0]
    assert rec.success and rec.validated is True, rec.error
    assert rec.processing_time_seconds >= 0 and rec.iterations is not None
    assert (tmp_path / "out" / "example-directed-BFS").exists()
    job_log = tmp_path / "report" / "log" / "example-directed-bfs-r0"
    assert "platform.graphtpu.device = cpu" in (job_log / "platform.properties").read_text()
    assert not (job_log / "executable.pid").exists()  # removed once the job ended


def test_hung_job_is_killed_at_timeout(fixtures_dir, tmp_path):
    cfg = _bench(fixtures_dir, tmp_path, timeout_seconds=8)
    t0 = time.perf_counter()
    records = BenchmarkSuite(cfg, _cpu(tmp_path, fault_injection="hang:bfs")).run()
    elapsed = time.perf_counter() - t0
    assert not records[0].success and "timeout" in records[0].error
    assert 8 <= elapsed < 60, f"kill took {elapsed:.1f}s"


def test_cli_load(fixtures_dir, tmp_path):
    r = _cli("load", "--graph-properties", str(fixtures_dir / "example-undirected.properties"),
             "--intermediate-dir", str(tmp_path / "im"))
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "im" / "example-undirected" / "graph.npz").exists()
    r = _cli("load", "--graph-name", "g", "--intermediate-dir", str(tmp_path / "im"))
    assert r.returncode == 2 and "need --graph-properties" in r.stderr


def test_cli_run_then_validate(fixtures_dir, tmp_path):
    out_file = tmp_path / "out-bfs"
    golden = str(fixtures_dir / "example-directed-BFS")
    r = _cli("run", "--graph-properties", str(fixtures_dir / "example-directed.properties"),
             "--algorithm", "bfs", "--device", "cpu", "--output-file", str(out_file),
             "--intermediate-dir", str(tmp_path / "im"))
    assert r.returncode == 0, r.stderr
    assert "processing time:" in r.stdout
    r = _cli("validate", "--algorithm", "bfs", "--output-file", str(out_file),
             "--validation-file", golden)
    assert r.returncode == 0 and "validation: PASS" in r.stdout, r.stderr
    lines = out_file.read_text().splitlines()
    lines[0] = lines[0].split()[0] + " 12345"
    out_file.write_text("\n".join(lines) + "\n")
    r = _cli("validate", "--algorithm", "bfs", "--output-file", str(out_file),
             "--validation-file", golden)
    assert r.returncode == 1 and "validation: FAIL" in r.stdout


def test_cli_benchmark(tmp_path):
    """The template's own config (paths relative to it), as the JAX CLI
    test runs it: two subprocess jobs on the CPU."""
    r = _cli("benchmark", "--config", str(TEMPLATE), "--graphs", "example-directed",
             "--algorithms", "bfs,wcc", "--device", "cpu",
             "--intermediate-dir", str(tmp_path / "im"), cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr + r.stdout
    assert "benchmark finished: 2/2 runs ok" in r.stdout
    summary = json.loads((tmp_path / "report" / "summary.json").read_text())
    assert summary["platform"] == "graphtpu_torch" and summary["succeeded"] == 2
    assert (tmp_path / "output" / "example-directed-BFS").exists()


def test_cli_benchmark_fails_on_a_failed_job(tmp_path):
    """A graph the config cannot resolve is a failed record and a non-zero
    exit, never a pass."""
    r = _cli("benchmark", "--config", str(TEMPLATE), "--graphs", "no-such-graph",
             "--algorithms", "bfs", "--device", "cpu", "--intermediate-dir",
             str(tmp_path / "im"), cwd=str(tmp_path))
    assert r.returncode == 1 and "0/1 runs ok" in r.stdout, r.stderr


def test_cli_devices():
    import torch

    r = _cli("devices")
    assert r.returncode == 0, r.stderr
    info = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(info) == {"backend", "num_devices", "devices"}
    assert info["num_devices"] == len(info["devices"]) >= 1
    if not torch.cuda.is_available():
        assert info == {"backend": "cpu", "num_devices": 1, "devices": ["cpu"]}


def test_profile_dir_writes_a_trace_of_the_window(fixtures_dir, tmp_path, capsys):
    prof = tmp_path / "prof"
    rc = cli_main(["run", "--graph-properties", str(fixtures_dir / "example-directed.properties"),
                   "--algorithm", "pr", "--device", "cpu", "--intermediate-dir",
                   str(tmp_path / "im"), "--profile-dir", str(prof)])
    assert rc == 0, capsys.readouterr().err
    traces = list(prof.glob("example-directed-pr-*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_delete_graph_keeps_the_cache_and_refuses_a_foreign_name(fixtures_dir, tmp_path):
    spec = GraphSpec.from_properties(fixtures_dir / "example-directed.properties")
    plat = GraphTorchPlatform(_cpu(tmp_path))
    plat.load_graph(spec)
    plat.delete_graph(spec.name)
    assert spec.name not in plat.graphs
    assert cache_mod.exists(tmp_path / "im", spec.name)
    for bad in ("", "a/b", "../x"):
        with pytest.raises(ValueError, match="refusing to unload"):
            cache_mod.unload(tmp_path / "im", bad)
