"""A loop of step functions run as one CUDA graph with conditional nodes, or
as a host loop over the same steps: the single-dispatch design of the JAX
package's nested ``lax.while_loop`` kernels (``_cdlp_adaptive_kernel``,
``_wcc_adaptive_loop``, ``_sssp_adaptive_kernel``, ``_bfs_adaptive_kernel``,
``_bfs_kernel`` and ``_sssp_delta_kernel``; ops/fixed_point.py builds the
one-WHILE loops, ``_sssp_kernel``, ``_wcc_kernel``, ``_cdlp_slab_kernel``
and ``_cdlp_sort_kernel``, on it).

A loop keeps its state on the device, in preallocated buffers and a small
int32 control vector whose words hold the loop's conditions, and is a set of
named step functions that issue only hand-kernel launches, memsets and
copies and read nothing back. Each step ends with a route kernel that writes
every condition into the control vector and, given the graph's handles,
into the graph's conditional nodes. A nest describes the loops: a tuple of
nodes, each a step's name or ``("while", j, body)`` / ``("if", j, body)``,
where j indexes the conditions and body is a nest; each j appears once.

* ``run_host`` walks the nest on the host, reading each condition from the
  control vector (one small read each): on the CPU, and on a card inside
  ``kernels.plain_torch()``, where each wrapper takes its plain version.
  It is the reference the graph is held against.
* ``LoopGraph`` builds the graph on a card: each step runs once eagerly
  (the library and each kernel's module load outside any capture; the
  eager steps are given no handles), then is captured by torch into a graph
  of its own (one private memory pool for all, kept alive here), and the
  captures are nested under conditional nodes (csrc/device_loop.cu) as the
  nest says, then one device-to-device copy of the result. A run points the
  copy at a fresh tensor and launches the graph: one launch, nothing read
  back. State that must survive a replay (a kernel's queues, counters,
  bitmaps) is zeroed by a memset inside the C entry that uses it, captured
  with its step. The build counts nothing in ``kernels.launch_counts`` (its
  eager pass and captures are taken back out), and a run launches nothing
  from Python, so the graph's executions of each kernel are read from a
  trace of a run. ``captured`` holds each step's launches at its capture;
  ``account`` adds them times the step counts the control vector reports to
  ``kernels.replayed_counts``: an inference, which a trace checks.

On a card a build or a launch that fails raises; nothing falls back to the
host loop. A ``LoopGraph`` that the garbage collector frees while a capture
is under way (a step's Python calls may trigger a collection) would end that
capture by destroying its graphs (a global-mode capture allows no such
call): its graphs are kept in ``_deferred`` and freed at the next build or
launch.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch
from torch.profiler import record_function

from graphtpu_torch.ops import kernels

# (root, exec, step graphs) of loop graphs collected during a capture
_deferred: list = []


def run_host(nest, steps: dict, cond: Callable[[int], bool], ranges: dict | None = None) -> int:
    """Walk ``nest`` on the host: each step's function from ``steps`` (in the
    profiler range ``ranges[name]`` where one is named), each condition j
    from ``cond(j)``. Returns the number of conditions read."""
    ranges = ranges or {}
    reads = 0

    def read(j):
        nonlocal reads
        reads += 1
        return cond(j)

    def walk(nodes):
        for node in nodes:
            if isinstance(node, str):
                if node in ranges:
                    with record_function(ranges[node]):
                        steps[node]()
                else:
                    steps[node]()
            elif node[0] == "while":
                while read(node[1]):
                    walk(node[2])
            elif read(node[1]):
                walk(node[2])

    walk(nest)
    return reads


def conditions(nest) -> int:
    """The number of conditions of ``nest`` (each index once, from 0)."""
    seen = []

    def walk(nodes):
        for node in nodes:
            if not isinstance(node, str):
                seen.append(node[1])
                walk(node[2])

    walk(nest)
    if sorted(seen) != list(range(len(seen))):
        raise ValueError(f"nest conditions {seen}: each of 0..{len(seen) - 1} once")
    return len(seen)


class LoopGraph:
    """One loop's CUDA graph (see the module's docstring). ``steps``: (name,
    step) in capture order, each step given the graph's handles; ``eager``:
    the same steps given none, run once before the captures; ``handles``: an
    int64 device tensor of the nest's conditions, which the route kernels
    read and which is filled here once the graph is built; ``out_src``: the
    tensor the closing copy reads (its content after the last node)."""

    def __init__(self, device, steps, eager, nest, handles: torch.Tensor, out_src: torch.Tensor):
        self.graphs, self.captured = {}, {}
        self.root = self.exec = self.copy = None
        self.out_src = out_src
        counts = dict(kernels.launch_counts)
        _free_deferred()
        with torch.cuda.device(device):
            for step in eager:
                step()
            pool = torch.cuda.graph_pool_handle()
            for name, step in steps:
                before = dict(kernels.launch_counts)
                self.graphs[name] = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(self.graphs[name], pool=pool):
                    step()
                self.captured[name] = {k: c - before[k] for k, c in kernels.launch_counts.items()
                                       if c != before[k]}
            kernels.launch_counts.update(counts)
            self._assemble(nest, handles)

    def _assemble(self, nest, handles: torch.Tensor) -> None:
        P, ref = ctypes.c_void_p, ctypes.byref
        found = [None] * conditions(nest)
        if handles.shape != (len(found),) or handles.dtype != torch.int64:
            raise ValueError(f"LoopGraph: handles must be int64 [{len(found)}]")

        def node(fn, *args):
            out = P()
            kernels.graph_call(fn, *args, ref(out))
            return out

        def add(graph, after, nodes):
            """Chains ``nodes`` after ``after`` in ``graph``; returns the last."""
            last = after
            for nd in nodes:
                if isinstance(nd, str):
                    last = node("graph_add_child", graph, last,
                                P(self.graphs[nd].raw_cuda_graph()))
                    continue
                h, body = ctypes.c_ulonglong(), P()
                last = node("graph_add_conditional", graph, last, int(nd[0] == "while"), ref(h),
                            ref(body))
                found[nd[1]] = h.value
                add(body, None, nd[2])
            return last

        self.root = P()
        kernels.graph_call("graph_new", ref(self.root))
        last = add(self.root, None, nest)
        # the closing copy of the result; each run points it at its own output
        self.copy_bytes = self.out_src.numel() * self.out_src.element_size()
        self.out0 = torch.empty_like(self.out_src)  # the copy's target until a run sets it
        if self.copy_bytes:
            self.copy = node("graph_add_copy", self.root, last, self.out0.data_ptr(),
                             self.out_src.data_ptr(), self.copy_bytes)
        self.exec = P()
        kernels.graph_call("graph_instantiate", self.root, ref(self.exec))
        handles.copy_(torch.tensor([h - (1 << 64) if h >= 1 << 63 else h for h in found],
                                   dtype=torch.int64))

    def launch(self, range_name: str = "loop.graph") -> torch.Tensor:
        """One run: the result (a copy of ``out_src``), on the card, once the
        stream gets there."""
        _free_deferred()
        out = torch.empty_like(self.out_src)
        if self.copy is not None:
            kernels.graph_call("graph_set_copy", self.exec, self.copy, out.data_ptr(),
                               self.out_src.data_ptr(), self.copy_bytes)
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
        with record_function(range_name):
            kernels.graph_call("graph_launch", self.exec, ctypes.c_void_p(stream))
        return out

    def account(self, runs: dict) -> None:
        """Adds each step's captured launches times its executions (``runs``,
        by step name) to ``kernels.replayed_counts``."""
        for name, counts in self.captured.items():
            for k, c in counts.items():
                kernels.replayed_counts[k] += c * runs[name]

    def __del__(self):
        try:
            if torch.cuda.is_current_stream_capturing():
                _deferred.append((self.root, self.exec, self.graphs))
            elif self.root is not None:
                kernels.graph_call("graph_free", self.root, self.exec)
        except Exception:  # noqa: BLE001 - no raise under garbage collection
            pass


def _free_deferred() -> None:
    """Frees the graphs of loop graphs collected during a capture."""
    while _deferred:
        root, exec_, _ = _deferred.pop()
        if root is not None:
            kernels.graph_call("graph_free", root, exec_)
