"""Device time per call from profiler traces whose records are whole.

``device_ms(fn, reps)`` is what the measuring tools under
``graphtpu_torch/tools/`` share. A ``torch.profiler`` trace now and then
loses device records: none at all, or some of one kernel's, so that a
record's count is not a whole multiple of the calls (every call of fn
launches the same kernels). Such a trace is taken again, and after
``TRACE_TRIES`` of them in a row the measurement fails rather than report a
time below the truth.

The tools run with ``--root`` pointing at another checkout, whose
``graphtpu_torch`` they then import; they load this file by its path
(``runpy.run_path``), so that it comes from the tool's own checkout. It
imports torch only, and only when called.
"""

from __future__ import annotations

TRACE_TRIES = 5


def _on_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).endswith("CUDA")


def device_ms(fn, reps=10, tries=TRACE_TRIES, only=None):
    """Device ms per call of fn(): the profiler's device time of the calls'
    kernels and copies, over ``reps`` calls after a warm-up; with ``only``
    (names), that of the records whose name holds one of them. Raises after
    ``tries`` traces in a row that lost records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    lost = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if _on_device(e) and e.self_device_time_total > 0]
        us = sum(e.self_device_time_total for e in events
                 if only is None or any(n in e.key for n in only))
        lost = [f"{e.key[:48]}: {e.count} records in {reps} calls" for e in events
                if e.count % reps]
        if us > 0 and not lost:
            return us / 1e3 / reps
        print(f"device_ms: a trace lost device records ({'; '.join(lost) or 'no device time'})",
              flush=True)
    raise RuntimeError(f"device_ms: {tries} traces in a row lost device records "
                       f"({'; '.join(lost) or 'no device time'})")
