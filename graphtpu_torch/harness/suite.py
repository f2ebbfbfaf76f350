"""Benchmark suite runner (counterpart of graphtpu/harness/suite.py), the
analogue of the graphalytics-core harness (SURVEY.md L0): iterate graph x
algorithm x repetition, enforce each run's timeout, write outputs,
validate them against the golden files, collect the processing time, and
write report/{runs.jsonl, summary.json, report.txt}.

Driven by benchmark.properties through BenchmarkConfig
(benchmark.custom.graphs/.algorithms/.timeout/.output-required/
.validation-required/.repetitions/.job-isolation;
config-template/cdlp.properties:8-23).

Under job-isolation=subprocess (the default) the suite's process never
touches the card: each job's child makes its own CUDA context, so it
finds the card free whatever the card's compute mode. The kernels are
built here first, so that no child's timeout holds a cold nvcc build.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from pathlib import Path
from typing import List, Optional

import torch

from graphtpu_torch.algorithms.common import run_algorithm
from graphtpu_torch.harness.collector import ceil3
from graphtpu_torch.harness.platform import PLATFORM_NAME, GraphTorchPlatform
from graphtpu_torch.harness.validator import validate_files, validate_result
from graphtpu_torch.utils.config import BenchmarkConfig, GraphSpec, PlatformConfig
from graphtpu_torch.utils.logging import get_logger
from graphtpu_torch.utils.timers import proc_time_end, proc_time_start

log = get_logger("suite")

ALGO_SUFFIX = {"bfs": "BFS", "pr": "PR", "wcc": "WCC", "cdlp": "CDLP", "lcc": "LCC", "sssp": "SSSP"}


def _is_primary() -> bool:
    """True on the process that writes outputs and reports: rank 0 of a
    multi-host run, and always on a single host."""
    from graphtpu_torch.parallel.multihost import is_primary

    return is_primary()


@dataclasses.dataclass
class RunRecord:
    graph: str
    algorithm: str
    repetition: int
    success: bool
    validated: Optional[bool]
    processing_time_seconds: float
    makespan_seconds: float
    iterations: Optional[int]
    error: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class _Timeout(Exception):
    pass


class _alarm:
    """Best-effort timeout of an in-process run (SIGALRM; main thread
    only). It interrupts between host steps, not a kernel that never
    returns: that takes job-isolation=subprocess."""

    def __init__(self, seconds: int):
        self.seconds = seconds
        self._armed = False

    def __enter__(self):
        if self.seconds > 0:
            try:
                self._old = signal.signal(signal.SIGALRM, self._raise)
                signal.alarm(self.seconds)
                self._armed = True
            except ValueError:  # not in the main thread
                self._armed = False
        return self

    @staticmethod
    def _raise(signum, frame):
        raise _Timeout()

    def __exit__(self, *exc):
        if self._armed:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, self._old)
        return False


class BenchmarkSuite:
    def __init__(self, bench_cfg: BenchmarkConfig, platform_cfg: Optional[PlatformConfig] = None):
        self.cfg = bench_cfg
        self.platform = GraphTorchPlatform(platform_cfg)
        self.records: List[RunRecord] = []

    # -- resolution ----------------------------------------------------------

    def _resolve_spec(self, graph_name: str) -> GraphSpec:
        props = Path(self.cfg.graphs_root) / f"{graph_name}.properties"
        if not props.exists():
            raise FileNotFoundError(f"dataset descriptor not found: {props}")
        return GraphSpec.from_properties(props)

    def _golden_path(self, spec: GraphSpec, algorithm: str) -> Optional[Path]:
        base = Path(self.cfg.validation_dir or self.cfg.graphs_root)
        p = base / f"{spec.name}-{ALGO_SUFFIX[algorithm]}"
        return p if p.exists() else None

    def _output_path(self, spec: GraphSpec, algorithm: str) -> Path:
        out_dir = Path(self.cfg.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        return out_dir / f"{spec.name}-{ALGO_SUFFIX[algorithm]}"

    def _validate(self, rec: RunRecord, spec: GraphSpec, algorithm: str, check) -> None:
        """Validate by ``check(golden path) -> (ok, msg)`` when required."""
        if not self.cfg.validation_required:
            return
        golden = self._golden_path(spec, algorithm)
        if golden is None:
            log.warning("no golden file for %s/%s: not validated", spec.name, algorithm)
            return
        ok, msg = check(str(golden))
        rec.validated = ok
        if not ok:
            rec.error = f"validation failed: {msg}"

    # -- execution -----------------------------------------------------------

    def run_one(self, spec: GraphSpec, algorithm: str, repetition: int) -> RunRecord:
        t0 = time.perf_counter()
        rec = RunRecord(graph=spec.name, algorithm=algorithm, repetition=repetition,
                        success=False, validated=None, processing_time_seconds=-1.0,
                        makespan_seconds=-1.0, iterations=None)
        from graphtpu_torch.parallel.multihost import is_multihost

        # multi-host: every ranked process runs each (collective) job itself;
        # a child process would sit outside the hosts' group
        if self.cfg.job_isolation == "subprocess" and not is_multihost():
            self._run_subprocess(spec, algorithm, repetition, rec)
        else:
            self._run_inprocess(spec, algorithm, rec)
        rec.makespan_seconds = round(time.perf_counter() - t0, 3)
        self.records.append(rec)
        status = "OK" if rec.success and rec.validated in (True, None) else "FAIL"
        log.info("[%s] %s/%s rep %d: t=%.3fs makespan=%.3fs validated=%s %s", status, spec.name,
                 algorithm, repetition, rec.processing_time_seconds, rec.makespan_seconds,
                 rec.validated, rec.error)
        return rec

    def _run_inprocess(self, spec: GraphSpec, algorithm: str, rec: RunRecord) -> None:
        try:
            with _alarm(self.cfg.timeout_seconds):
                graph = self.platform.graphs.get(spec.name) or self.platform.load_graph(spec)
                self.platform.prepare(spec, algorithm)  # builds and warms outside the window
                start_ms = proc_time_start(self.platform.collector.stream)
                result = run_algorithm(algorithm, graph, spec.params.get(algorithm),
                                       self.platform.config)
                end_ms = proc_time_end(self.platform.collector.stream)
            rec.success = True
            rec.processing_time_seconds = ceil3((end_ms - start_ms) / 1000.0)
            rec.iterations = result.iterations
            if self.cfg.output_required and _is_primary():
                result.write(graph, str(self._output_path(spec, algorithm)))
            self._validate(rec, spec, algorithm,
                           lambda golden: validate_result(result, graph, golden))
        except _Timeout:
            rec.error = f"timeout after {self.cfg.timeout_seconds}s"
        except Exception as e:  # noqa: BLE001 - the suite outlives a failed job
            rec.error = f"{type(e).__name__}: {e}"

    def _run_subprocess(self, spec: GraphSpec, algorithm: str, repetition: int,
                        rec: RunRecord) -> None:
        """A killable child per job (job-isolation=subprocess), killed at
        benchmark.custom.timeout through its process group."""
        from graphtpu_torch.harness.jobproc import run_job

        out_path = None
        if self.cfg.output_required or self.cfg.validation_required:
            out_path = self._output_path(spec, algorithm)
        job_log = Path(self.cfg.report_dir) / "log" / f"{spec.name}-{algorithm}-r{repetition}"
        outcome = run_job(
            str(Path(self.cfg.graphs_root) / f"{spec.name}.properties"),
            algorithm,
            self.platform.config,
            log_dir=str(job_log),
            output_file=str(out_path) if out_path else None,
            timeout_seconds=self.cfg.timeout_seconds,
            stream=self.platform.collector.stream,
        )
        if outcome.status == "timeout":
            rec.error = f"timeout after {self.cfg.timeout_seconds}s (job killed)"
        elif outcome.status == "error":
            rec.error = outcome.error
        else:
            rec.success = True
            rec.processing_time_seconds = ceil3(outcome.processing_ms / 1000.0)
            rec.iterations = outcome.iterations
            if out_path is not None:
                self._validate(rec, spec, algorithm,
                               lambda golden: validate_files(algorithm, str(out_path), golden))

    def _set_up(self) -> None:
        """In-process jobs need the configured device in this process;
        subprocess jobs need the kernels built before any child starts."""
        device = torch.device(self.platform.config.device)
        if self.cfg.job_isolation != "subprocess":
            self.platform.verify_setup()
        elif device.type == "cuda":
            from graphtpu_torch.ops import kernels

            kernels.build()

    def run(self) -> List[RunRecord]:
        # one bad graph or job must not stop the suite or lose the report,
        # as the reference harness isolates each job's failure
        try:
            self._set_up()
            for graph_name in self.cfg.graphs:
                try:
                    spec = self._resolve_spec(graph_name)
                except Exception as e:  # noqa: BLE001
                    log.error("graph %s unresolvable: %s; skipped", graph_name, e)
                    self.records.append(RunRecord(
                        graph=graph_name, algorithm="*", repetition=0, success=False,
                        validated=None, processing_time_seconds=0.0, makespan_seconds=0.0,
                        iterations=None, error=f"graph unresolvable: {e}",
                    ))
                    continue
                for algorithm in self.cfg.algorithms or spec.algorithms:
                    if algorithm not in spec.algorithms:
                        log.warning("%s does not list algorithm %s; skipped", spec.name, algorithm)
                        continue
                    for rep in range(self.cfg.repetitions):
                        self.run_one(spec, algorithm, rep)
                self.platform.delete_graph(spec.name)
        finally:
            self.write_report()
        return self.records

    # -- reporting -----------------------------------------------------------

    def write_report(self) -> Path:
        report_dir = Path(self.cfg.report_dir)
        if not _is_primary():
            return report_dir
        report_dir.mkdir(parents=True, exist_ok=True)
        with open(report_dir / "runs.jsonl", "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec.to_json()) + "\n")
        ok = [r for r in self.records if r.success and r.validated in (True, None)]
        summary = {
            "platform": PLATFORM_NAME,
            "total_runs": len(self.records),
            "succeeded": len(ok),
            "failed": len(self.records) - len(ok),
            "by_run": {
                f"{r.graph}/{r.algorithm}/rep{r.repetition}": r.processing_time_seconds
                for r in self.records
            },
        }
        (report_dir / "summary.json").write_text(json.dumps(summary, indent=2))
        lines = [
            f"{PLATFORM_NAME} benchmark report",
            "=" * 60,
            f"{'graph':24} {'algo':6} {'rep':3} {'proc(s)':>9} {'valid':>6} status",
        ]
        for r in self.records:
            status = "ok" if r.success and r.validated in (True, None) else (r.error[:40] or "fail")
            lines.append(f"{r.graph:24} {r.algorithm:6} {r.repetition:3d} "
                         f"{r.processing_time_seconds:9.3f} {str(r.validated):>6} {status}")
        (report_dir / "report.txt").write_text("\n".join(lines) + "\n")
        log.info("report written to %s", report_dir)
        return report_dir
