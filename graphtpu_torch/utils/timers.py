"""Timing utilities (counterpart of graphtpu/utils/timers.py).

1. Nested scoped wall-clock timers printing ``"<name> starts"`` /
   ``"<name> duration: Xs"`` lines (computation_timer.hpp:23-50).
2. The benchmark metric: epoch-millisecond markers
   ``"Processing starts at: <ms>"`` / ``"Processing ends at: <ms>"`` around
   the kernel, harvested by the collector (bfs.cpp:105-107,
   GraphblasCollector.java:54-95). The strings are byte-compatible.
"""

from __future__ import annotations

import sys
import threading
import time

import torch

START_PROC_MARKER = "Processing starts at: "
END_PROC_MARKER = "Processing ends at: "

_nesting = threading.local()


def _level() -> int:
    return getattr(_nesting, "level", 0)


def current_millis() -> int:
    """Epoch milliseconds (utils.cpp:8-13)."""
    return int(time.time() * 1000)


def proc_time_start(stream=None) -> int:
    """Emit the processing-window-open marker; returns the epoch-ms stamp."""
    ms = current_millis()
    print(f"{START_PROC_MARKER}{ms}", file=stream or sys.stdout, flush=True)
    return ms


def proc_time_end(stream=None) -> int:
    """Emit the processing-window-close marker; returns the epoch-ms stamp."""
    ms = current_millis()
    print(f"{END_PROC_MARKER}{ms}", file=stream or sys.stdout, flush=True)
    return ms


class ComputationTimer:
    """Scoped nested timer: prints "<name> starts", then
    "<name> duration: Xs", indented one tab per nesting level."""

    def __init__(self, name: str, print_on_exit: bool = True, stream=None):
        self.name = name
        self.print_on_exit = print_on_exit
        self.stream = stream or sys.stdout
        self.elapsed: float = 0.0

    def __enter__(self) -> "ComputationTimer":
        self._indent = "\t" * _level()
        _nesting.level = _level() + 1
        print(f"{self._indent}{self.name} starts", file=self.stream, flush=True)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.elapsed = time.perf_counter() - self._t0
        _nesting.level = _level() - 1
        if self.print_on_exit:
            print(
                f"{self._indent}{self.name} duration: {self.elapsed}s",
                file=self.stream,
                flush=True,
            )


class IterationTimer:
    """Per-iteration timing, printing ``[CUDA][TIMER] <name> took Xms``
    like the reference's CUDA-event queue (common/utils.hpp:344-382).
    ``stop`` synchronizes the device of every CUDA tensor it is given, so
    the span covers the device work and not only its enqueue."""

    PREFIX = "[CUDA][TIMER]"

    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, name: str, *block_on) -> float:
        for t in block_on:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.synchronize(t.device)
        ms = (time.perf_counter() - self._t0) * 1000.0
        print(f"{self.PREFIX} {name} took {ms:.3f}ms", file=self.stream, flush=True)
        return ms
