"""Subprocess job execution with a hard timeout (counterpart of
graphtpu/harness/jobproc.py).

The reference harness's job contract: each algorithm job is a process of
its own (GraphblasJob.java:70-97 spawning execute-job.sh), its pid is
written to ``<log>/executable.pid`` (execute-job.sh:150) so that a hung job
can be killed, and its stdout, which carries the ``Processing starts/ends
at:`` markers, is pumped into the parent's collector stream
(GraphblasJob.java:93-96, GraphblasCollector.java:30-47).

The child is ``python -m graphtpu_torch.cli run``; the whole platform
configuration, device included, goes to it as a generated
platform.properties file. At the timeout the child's process group is
SIGKILLed, which stops even a kernel that never returns; the child's CUDA
context ends with its process.
"""

from __future__ import annotations

import dataclasses
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path
from typing import List, Optional

from graphtpu_torch.utils.config import PlatformConfig
from graphtpu_torch.utils.logging import get_logger

log = get_logger("jobproc")

_START = re.compile(r"Processing starts at: (\d+)")
_END = re.compile(r"Processing ends at: (\d+)")
_ITERS = re.compile(r"iterations: (\d+)")


@dataclasses.dataclass
class JobOutcome:
    status: str  # "ok" | "timeout" | "error"
    processing_ms: Optional[int] = None
    iterations: Optional[int] = None
    returncode: Optional[int] = None
    error: str = ""


def run_job(
    spec_path: str,
    algorithm: str,
    platform_cfg: PlatformConfig,
    *,
    log_dir: str,
    output_file: Optional[str] = None,
    timeout_seconds: int = 0,
    stream=None,
) -> JobOutcome:
    """Run one algorithm job in a child process; kill it at the timeout.

    The timeout covers the whole job (interpreter and CUDA start-up, the
    graph's load from the binary cache, the warm-up and the timed run), as
    the harness's per-run ``benchmark.custom.timeout`` does.
    """
    log_path = Path(log_dir)
    log_path.mkdir(parents=True, exist_ok=True)
    props_path = log_path / "platform.properties"
    platform_cfg.to_properties(props_path)

    argv = [
        sys.executable, "-m", "graphtpu_torch.cli", "run",
        "--graph-properties", str(spec_path),
        "--algorithm", algorithm,
        "--platform-properties", str(props_path),
        "--intermediate-dir", platform_cfg.intermediate_dir,
        "--log-path", str(log_path),
    ]
    if output_file:
        argv += ["--output-file", str(output_file)]

    # the package importable in the child whatever its cwd (it need not be
    # installed)
    pkg_root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")

    proc = subprocess.Popen(
        argv,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        env=env,
        start_new_session=True,  # its own process group, killable as a unit
    )
    pid_file = log_path / "executable.pid"
    pid_file.write_text(f"{proc.pid}\n")

    lines: List[str] = []

    def _pump():
        for line in proc.stdout:  # type: ignore[union-attr]
            lines.append(line)
            if stream is not None:
                try:
                    stream.write(line)
                except Exception:  # noqa: BLE001 - a logging failure must not stop the pump
                    pass

    pump = threading.Thread(target=_pump, daemon=True)
    pump.start()

    timed_out = False
    try:
        proc.wait(timeout=timeout_seconds if timeout_seconds > 0 else None)
    except subprocess.TimeoutExpired:
        timed_out = True
        # the child leads its own process group (start_new_session): this
        # kills the job's tree and nothing else
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    finally:
        pump.join(timeout=10)
        pid_file.unlink(missing_ok=True)

    if timed_out:
        return JobOutcome(status="timeout", returncode=proc.returncode)
    text = "".join(lines)
    start, end, iters = _START.findall(text), _END.findall(text), _ITERS.findall(text)
    if proc.returncode != 0 or not (start and end):
        tail = "".join(lines[-15:]).strip()
        return JobOutcome(status="error", returncode=proc.returncode,
                          error=f"job exited {proc.returncode}: {tail[-500:]}")
    return JobOutcome(
        status="ok",
        processing_ms=int(end[-1]) - int(start[-1]),
        iterations=int(iters[-1]) if iters else None,
        returncode=proc.returncode,
    )
