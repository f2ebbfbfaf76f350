"""The port's bench section runner (graphtpu_torch/utils/sections.py) under
simulated failures, case for case as tests/test_sections.py holds the JAX
package's: the impl ladder, the retry of transient errors with backoff,
the watchdog; and a CUDA error, which is never retried."""

import time

from graphtpu_torch.utils.sections import SectionRunner


def _runner(details, **kw):
    kw.setdefault("backoff_s", 0.01)
    kw.setdefault("sleep", lambda s: None)
    return SectionRunner(details, **kw)


def test_primary_success_records_no_error():
    details = {}
    r = _runner(details)
    out = r.run("sssp", [("adaptive", lambda: 42)])
    assert out == 42
    assert "sssp_error" not in details
    assert details["sssp_impl_used"] == "adaptive"


def test_ladder_falls_through_on_permanent_error():
    details = {}
    r = _runner(details)

    def boom():
        raise RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")

    out = r.run("sssp", [("adaptive", boom), ("delta", lambda: "ok")])
    assert out == "ok"
    assert details["sssp_impl_used"] == "delta"
    assert any("adaptive" in e for e in details["sssp_errors"])


def test_permanent_error_is_not_retried():
    details = {}
    calls = []

    def boom():
        calls.append(1)
        # a transient type whose message names a CUDA failure
        raise TimeoutError("NCCL watchdog: CUDA error: an illegal memory access")

    r = _runner(details, retries=3)
    out = r.run("x", [("a", boom)])
    assert out is None
    assert len(calls) == 1
    assert "a" in details["x_error"]


def test_transient_error_retried_then_succeeds():
    details = {}
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise ConnectionResetError("rendezvous: Connection reset by peer")
        return "num"

    slept = []
    r = _runner(details, retries=1, backoff_s=5.0, sleep=slept.append)
    out = r.run("pr", [("slab", flaky)])
    assert out == "num"
    assert len(calls) == 2
    assert slept == [5.0]
    assert "pr_error" not in details


def test_transient_retries_exhausted_fall_through_ladder():
    details = {}

    def always_eagain():
        raise OSError(11, "Resource temporarily unavailable")

    r = _runner(details, retries=1)
    out = r.run("sssp", [("adaptive", always_eagain), ("dense", lambda: 7)])
    assert out == 7
    assert details["sssp_impl_used"] == "dense"


def test_all_rungs_fail_records_last_error():
    details = {}
    r = _runner(details)
    out = r.run("lcc", [("a", lambda: 1 / 0), ("b", lambda: [][1])])
    assert out is None
    assert details["lcc_error"].startswith("b: IndexError")
    assert len(details["lcc_errors"]) == 2


def test_watchdog_times_out_and_aborts_ladder():
    details = {}
    started = []

    def wedge():
        started.append(1)
        time.sleep(10)

    def never():
        raise AssertionError("ladder must stop after a watchdog timeout")

    r = _runner(details)
    t0 = time.perf_counter()
    out = r.run("wcc", [("adaptive", wedge), ("dense", never)], watchdog_s=0.2)
    took = time.perf_counter() - t0
    assert out is None
    assert took < 5
    assert "watchdog" in details["wcc_error"]
    assert started == [1]


def test_watchdog_passes_fast_sections():
    details = {}
    r = _runner(details)
    assert r.run("bfs", [("adaptive", lambda: "fast")], watchdog_s=5.0) == "fast"


def test_cuda_error_is_not_retried():
    """A CUDA error leaves the context unusable: the rung fails at once,
    with no backoff, and the next rung runs."""
    details = {}
    calls, slept = [], []

    def launch_failure():
        calls.append(1)
        raise RuntimeError("CUDA error: unspecified launch failure\nCUDA kernel errors "
                           "might be asynchronously reported")

    r = _runner(details, retries=5, sleep=slept.append)
    out = r.run("cdlp", [("adaptive", launch_failure), ("slab", lambda: 3)])
    assert out == 3
    assert calls == [1] and slept == []
    assert details["cdlp_impl_used"] == "slab"
    assert "launch failure" in details["cdlp_errors"][0]
