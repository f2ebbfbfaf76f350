"""Metric collection from timing markers (counterpart of
graphtpu/harness/collector.py).

Replicates GraphblasCollector.java:54-95: scan the captured run log for
lines containing "Processing starts at:" / "Processing ends at:", take the
trailing epoch-millis token of the *last* start/end pair, and report
(end - start) / 1000 seconds rounded *up* to 3 decimals (ceiling
BigDecimal semantics, GraphblasCollector.java:87-91).
"""

from __future__ import annotations

import io
import math
import sys
from pathlib import Path
from typing import Optional

from graphtpu_torch.utils.timers import END_PROC_MARKER, START_PROC_MARKER


class _Tee(io.TextIOBase):
    """TeeOutputStream analogue (GraphblasCollector.java:30-47): mirror
    writes to the real stream and to an in-memory/file log."""

    def __init__(self, primary, secondary):
        self.primary = primary
        self.secondary = secondary

    def write(self, s):
        self.primary.write(s)
        self.secondary.write(s)
        return len(s)

    def flush(self):
        self.primary.flush()
        self.secondary.flush()


def ceil3(seconds: float) -> float:
    return math.ceil(seconds * 1000.0) / 1000.0


class Collector:
    def __init__(self):
        self.buffer = io.StringIO()
        self.stream = self.buffer  # markers are written here
        self._log_path: Optional[Path] = None
        self._tee: Optional[_Tee] = None

    def start_logging(self, log_dir: Optional[str] = None) -> None:
        self.buffer = io.StringIO()
        if log_dir:
            p = Path(log_dir) / "platform"
            p.mkdir(parents=True, exist_ok=True)
            self._log_path = p / "runner.logs"
        self.stream = _Tee(sys.stdout, self.buffer)

    def stop_logging(self) -> None:
        if self._log_path is not None:
            self._log_path.write_text(self.buffer.getvalue())
        self.stream = self.buffer

    def collect_processing_time(self, text: Optional[str] = None) -> float:
        """Parse marker lines; returns seconds or -1 when absent
        (GraphblasCollector returns a failed metric then)."""
        text = text if text is not None else self.buffer.getvalue()
        start_ms = end_ms = None
        for line in text.splitlines():
            if START_PROC_MARKER.rstrip() in line:
                start_ms = int(line.split()[-1])
            elif END_PROC_MARKER.rstrip() in line:
                end_ms = int(line.split()[-1])
        if start_ms is None or end_ms is None:
            return -1.0
        return ceil3((end_ms - start_ms) / 1000.0)
