"""Build, load and launch the hand-written CUDA kernels of graphtpu_torch.

The sources under ``graphtpu_torch/csrc/`` are compiled at first use by
``nvcc``, one process per source, all started together, and linked into
one shared library with a plain C interface, loaded with ctypes, under
``build/graphtpu_torch/`` at the root of the checkout. The library's file
name carries a hash of the sources and flags, so an edited source never
loads a stale build. Parallel first use is safe: the build runs under an
exclusive file lock and the library appears by an atomic rename, so no
process can load a half-written file.

Each kernel has a wrapper beside its plain PyTorch version:
``ops/gather.py:gather_rows`` (K1), ``ops/minmode.py:slab_minmode`` (K2),
``ops/spmv.py:slab_spmv_sum`` (K3), ``ops/pallas_gather.py:vreg_shuffle``
(K4), ``ops/frontier.py:frontier_expand`` (K5), ``ops/spmv.py:slab_spmv_min``
(K6), ``ops/spmv.py:csr_pull_reduce`` (K7; in mode sum on a sliced pull,
C entry ``csr_pull_slices``) and ``ops/frontier.py:relax_min``
(K8, kernel ``push_relax_min``), ``ops/edgehash.py:edgehash_probe`` (K9) and
``ops/triangles.py:wedge_rowblock`` (K10), ``core/spgemm.py:masked_spgemm_rows``
(K11, kernel ``masked_spgemm``), ``ops/minmode.py:stream_minmode`` (K12, kernel
``segment_minmode``), ``ops/frontier.py:bfs_trunc_probe`` (K13),
``ops/frontier.py:compact`` and ``compact_stream`` (K14, kernel
``frontier_compact``), ``algorithms/lcc.py:_lcc_bucket_sweep`` (K15,
kernel ``lcc_sweep_member``), ``ops/triangles.py:lcc_head_credits`` (K16) and
``ops/frontier.py:residual_claim`` (K17, kernel ``bfs_residual_claim``),
``ops/frontier.py:frontier_starts`` (K18), ``ops/active.py:cdlp_tier_apply``
(K19; its min mode, WCC's active step, counted as ``cdlp_tier_apply_min``),
``ops/active.py:cdlp_route`` and ``cdlp_status`` (K20, kernel
``cdlp_route``, the full step's status counted as ``cdlp_route_status``, its
jump mode, WCC's full step, as ``cdlp_route_status_jump``),
``algorithms/wcc.py:wcc_jump`` (K21), ``algorithms/sssp.py:sssp_apply``
(K22) and ``algorithms/bfs.py:bfs_apply`` (K23). A wrapper dispatches on
the device of its tensors: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. K2, K3 and K6 also take every bucket
of a slab plan in one launch (``slab_minmode_buckets``,
``slab_spmv_sum_buckets``, ``slab_spmv_min_buckets``), which is what the
algorithms call. Inside ``plain_torch()`` CUDA
tensors take the plain version too, so the whole path can run as its own
reference on the card. A wrapper adds one to ``launch_counts[name]`` for
each launch (K7 in mode sum to ``launch_counts["csr_pull_reduce_sum"]``, in
mode sum_i64, which no path runs since K16 took LCC's head sums, to
``"csr_pull_reduce_sum_i64"``, K8's int32 mode,
``ops/frontier.py:relax_min_i32``, to ``"push_relax_min_i32"``, its in-place
mode, ``ops/frontier.py:relax_min_into``, to ``"push_relax_min_inplace"``, K14's
row-flag mode, ``ops/frontier.py:compact_rows_into``, to
``"frontier_compact_rows"``, its level mode, ``compact_level_into``, to
``"frontier_compact_level"``, its unvisited mode, ``compact_unvisited_into``,
to ``"frontier_compact_unvisited"``, and the device-level modes of K13 and
K17, a level read on the card, to ``"bfs_trunc_probe_at"`` and
``"bfs_residual_claim_at"``); K9, K11
and K12 may launch more than once a call (K9: a histogram, a scatter, the
probe and the unbin; K11: one launch per task list of its plan; K12: a warp
per segment, then a persistent grid for the longer ones), and count each. A
call of K14 is one count: its C entry runs a count and a write kernel (and
in compact_stream, before them, a memset and the bitmap's marking); so is
a call of K16, whose C entry zeroes its output by a memset first, of K20's
status, K22 and K23, which zero their scratch the same way, and of K8's in-place
mode (a memset of the mask, a snapshot kernel and the relaxation).
A launch captured into a CUDA graph counts once, at its capture
(``torch.cuda.graph``), and its replays not at all. The device loops' graphs
(ops/device_loop.py: CDLP auto, WCC auto and adaptive, SSSP auto, BFS auto and
device) take their
build's counts back out: their runs launch nothing from Python, and a trace
of a run shows what it executed. ``replayed_counts`` holds such a graph's
captured launches times the step counts its control words report, an
inference the trace is held against. ``graph_call`` runs the host functions
that assemble and launch those graphs (``_GRAPH``).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "graphtpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

KERNELS = (
    "gather_rows", "slab_minmode", "slab_spmv_sum", "vreg_shuffle", "frontier_expand",
    "slab_spmv_min", "csr_pull_reduce", "push_relax_min", "edgehash_probe", "wedge_rowblock",
    "masked_spgemm", "segment_minmode", "bfs_trunc_probe", "frontier_compact",
    "lcc_sweep_member", "lcc_head_credits", "bfs_residual_claim", "frontier_starts",
    "cdlp_tier_apply", "cdlp_route", "wcc_jump", "sssp_apply", "bfs_apply",
)

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    # table, idx, out, n, rows, row_bytes, stream
    "gt_gather_rows": (_P, _P, _P, _I64, _I64, _I64, _P),
    # buckets (ops/slab.py BucketDescriptor array), count, labels, out, bound, mode, stream
    "gt_slab_minmode": (_P, _I32, _P, _P, _I64, _I32, _P),
    # buckets, count, x, y, n, is_f64, stream
    "gt_slab_spmv_sum": (_P, _I32, _P, _P, _I64, _I32, _P),
    # tbl8, ind, out, cols, stream
    "gt_vreg_shuffle": (_P, _P, _P, _I32, _P),
    # ids, starts, k, indptr_pad, neigh, rows_local, row_ids, gpos, neigh_out,
    # valid, e_cap, stream
    "gt_frontier_expand": (_P, _P, _I32, _P, _P, _P, _P, _P, _P, _P, _I32, _P),
    # buckets, count, x (null = identity mode), y, n, stream
    "gt_slab_spmv_min": (_P, _I32, _P, _P, _I64, _P),
    # indptr, src, x (null = the stored ids), w (null unless min_plus), y, n, m, mode,
    # items per block, scratch, scratch bytes, stream
    "gt_csr_pull_reduce": (_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _P, _I64, _P),
    # K7's mode sum over a sliced pull (ops/spmv.py PullSlices): lid, head, row_runs,
    # part_ptr, tile_edge, tile_run, tile_slice, tiles, runs, n, x, len(x), width, edges
    # a tile, is_f64, grid, part, scratch, scratch bytes, y, stream
    "gt_csr_pull_slices": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _I64, _I32, _I32,
                           _I32, _I32, _P, _P, _I64, _P, _P),
    # dist, row_ids, neigh, gpos, valid, w, out, e_cap, is_f64, stream
    "gt_push_relax_min": (_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _P),
    # table, rows, klo, khi, found, payload, p, stream
    "gt_edgehash_probe": (_P, _I64, _P, _P, _P, _P, _I64, _P),
    # table, rows, klo, khi, p, pshift, parts, tiles, counts, stream
    "gt_edgehash_bin_count": (_P, _I64, _P, _P, _I64, _I32, _I32, _I32, _P, _P),
    # table, rows, klo, khi, p, pshift, parts, tiles, offsets, bins, pos, stream
    "gt_edgehash_bin_scatter": (_P, _I64, _P, _P, _I64, _I32, _I32, _I32, _P, _P, _P, _P),
    # table, rows, bins, starts, parts, p, pshift, res, stream
    "gt_edgehash_bin_probe": (_P, _I64, _P, _P, _I32, _I64, _I32, _P, _P),
    # pos, res, found, payload, p, stream
    "gt_edgehash_unbin": (_P, _P, _P, _P, _I64, _P),
    # slab, mslab, W, R, close_indptr, close_ids, close_mult, n_close, u_cred,
    # edge_cred, stream
    "gt_wedge_rowblock": (_P, _P, _I32, _I64, _P, _P, _P, _I64, _P, _P, _P),
    # a_indptr, a_col, a_val (null = structural), b_indptr, b_col, b_val, cw,
    # a_rows, b_rows, vtype, add, mul, kind, tasks, ntask, cols, idx (null =
    # identity), out, stream
    "gt_masked_spgemm": (_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _P,
                         _I32, _P, _P, _P, _P),
    # K12's two launches: labels (null = identity), neigh, indptr, h, m, bound,
    # out, scratch, scratch ints, med_len, long_len, stream
    **{f"gt_segment_minmode_{k}": (_P, _P, _P, _I32, _I64, _I64, _P, _P, _I64, _I32, _I32, _P)
       for k in ("warp", "grid")},
    # levels, n_levels, level, level_at (null: level), trunc, t, rows, row_offset, pdeg,
    # claim, resid, stream
    "gt_bfs_trunc_probe": (_P, _I64, _I32, _P, _P, _I32, _I64, _I64, _P, _P, _P, _P),
    # labels, row_ids, neigh, total (a device int32), out, e_cap, row_offset, n_out, grid,
    # stream
    "gt_push_relax_min_i32": (_P, _P, _P, _P, _P, _I32, _I64, _I64, _I32, _P),
    # mask, n, ids, k, count, scratch, scratch ints, stream
    "gt_frontier_compact": (_P, _I64, _P, _I64, _P, _P, _I64, _P),
    # mask, levels (null: the mask mode), level_at, n, ids, k, count, deg_pad, deg_sum (null:
    # none), scratch, scratch ints, stream
    "gt_frontier_compact_into": (_P, _P, _P, _I64, _P, _I64, _P, _P, _P, _P, _I64, _P),
    # vals, active, rows_local, rowflag, edge_count, levels, mode (0: active; 1: the row-flag
    # mode, which reads rows_local, rowflag and edge_count in place of active; 2: the
    # unvisited mode, edge_count and levels), e, n, bitmap, ids, k, count, deg_pad, deg_sum
    # (null: none), scratch, scratch ints, stream
    "gt_frontier_compact_stream": (_P, _P, _P, _P, _P, _P, _I32, _I64, _I64, _P, _P, _I64, _P,
                                   _P, _P, _P, _I64, _P),
    # indptr, col, c, o, items, n_items, weight, unit (threads an item), ilp
    # (searches a lane runs in step), numerator, stream
    "gt_lcc_sweep_member": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P, _P),
    # buckets (ops/triangles.py HeadCreditBucket array), count, n, num, stream
    "gt_lcc_head_credits": (_P, _I32, _I64, _P, _P),
    # levels, n_levels, level, level_at (null: level), neigh, seg_starts, rids, k, e_cap, pad,
    # out, grid, stream
    "gt_bfs_residual_claim": (_P, _I64, _I32, _P, _P, _P, _P, _I32, _I32, _I32, _P, _I32, _P),
    # ids, k, deg_pad, n_pad, starts, scratch, scratch words (uint64), stream
    "gt_frontier_starts": (_P, _I64, _P, _I64, _P, _P, _I64, _P),
    # labels, n, ids, winners, k, rowflag, ch, is_min, stream
    "gt_cdlp_tier_apply": (_P, _I64, _P, _P, _I64, _P, _P, _I32, _P),
    # labels, next, n, deg, mask, scratch, ctl, k_max, e_max, jump, grid, stream
    "gt_cdlp_route_status": (_P, _P, _I64, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _P),
    # ctl, tiers, t, stage, itermax (pinned host int32), handles (null outside a graph), stream
    "gt_cdlp_route": (_P, _P, _I32, _I32, _P, _P, _P),
    # labels, neigh_min, out, n, stream
    "gt_wcc_jump": (_P, _P, _P, _I64, _P),
    # dist, relaxed (null but at the full stage), mask, n, deg, source (pinned host int32),
    # scratch, ctl, tiers, t, stage, itermax, is_f64, handles (null outside a graph), grid,
    # stream
    "gt_sssp_apply": (_P, _P, _P, _I64, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _P, _I32,
                      _P),
    # dist, ids, k, n, du (scratch), rows_local, neigh, gpos, w, total (a device int32),
    # e_cap, mask, is_f64, grid, stream
    "gt_push_relax_min_inplace": (_P, _P, _I64, _I64, _P, _P, _P, _P, _P, _P, _I32, _P, _I32,
                                  _I32, _P),
    # levels, n, fmask, reached, claim, ids, k, stat, deg (null: sums of 0), source (pinned
    # host int32), scratch, ctl, tiers, t, stage, k_bu, e_bu, itermax, handles (null outside
    # a graph), handles set, grid, stream
    "gt_bfs_apply": (_P, _I64, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                     _I32, _I32, _P, _I32, _I32, _P),
    # stream: a kernel that returns at once (csrc/empty_kernel.cu)
    "gt_empty_kernel": (_P,),
}

# host functions that assemble, instantiate and launch a CUDA graph
# (csrc/device_loop.cu), each returning a cudaError_t
_PP, _PH = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_ulonglong)
_GRAPH = {
    "gt_graph_new": (_PP,),
    # graph, after (null: no dependency), child, node out
    "gt_graph_add_child": (_P, _P, _P, _PP),
    # graph, after, is_while, handle out, body out, node out
    "gt_graph_add_conditional": (_P, _P, _I32, _PH, _PP, _PP),
    # graph, after, dst, src, bytes, node out
    "gt_graph_add_copy": (_P, _P, _P, _P, _I64, _PP),
    "gt_graph_instantiate": (_P, _PP),
    # exec, copy node, dst, src, bytes
    "gt_graph_set_copy": (_P, _P, _P, _P, _I64),
    "gt_graph_launch": (_P, _P),
    "gt_graph_free": (_P, _P),
}

# host functions that size a launch's scratch, returning a count
_QUERIES = {
    # h, m, long_len -> the ints of K12's scratch
    "gt_segment_minmode_scratch_ints": (_I32, _I64, _I32),
    # -> the heads K16 sums in a block's shared memory (its build's K16_HUBS)
    "gt_lcc_head_credits_hubs": (),
    # k -> the uint64 words of K18's scratch (a ticket and a status word a tile)
    "gt_frontier_starts_scratch_words": (_I64,),
}

# a launch counter per kernel, and one for each of K7's sum modes (sum:
# PageRank's scan arm and slab PageRank's heavy rows; sum_i64: LCC's credit
# sums in head order, the design K16 replaced, which no path launches now),
# K8's int32 mode (the distributed WCC's active step) and in-place mode (SSSP
# auto's tier rounds), K14's row-flag mode, K19's min mode (WCC's active
# step), K20's status entry and its jump mode (WCC's full step), and BFS's
# device loop's modes: K14's level and unvisited modes, K13 and K17 with the
# level read on the card, so that a run shows which callers it went through
COUNTERS = KERNELS + ("csr_pull_reduce_sum", "csr_pull_reduce_sum_i64", "push_relax_min_i32",
                      "frontier_compact_rows", "cdlp_route_status", "cdlp_tier_apply_min",
                      "cdlp_route_status_jump", "push_relax_min_inplace", "frontier_compact_level",
                      "frontier_compact_unvisited", "bfs_trunc_probe_at", "bfs_residual_claim_at")
launch_counts = dict.fromkeys(COUNTERS, 0)
# a captured graph's launches as inferred by its driver: each step's captured
# launches times the executions of the step that its control words report
replayed_counts = dict.fromkeys(COUNTERS, 0)
build_seconds = None  # seconds the last nvcc build took; None = not built here
_libs = {}
_plain = False


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
        replayed_counts[k] = 0


@contextlib.contextmanager
def plain_torch():
    """Run every wrapper's plain PyTorch version, on any device."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def use_kernel(t) -> bool:
    """True when a wrapper must launch its kernel for tensor ``t``."""
    return t.is_cuda and not _plain


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device: what a one-wave grid is
    sized by."""
    import torch

    return torch.cuda.get_device_properties(torch.device(device)).multi_processor_count


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path(defines=()) -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(f"-D{d}" for d in defines)).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgraphtpu_torch_{h.hexdigest()[:16]}.so"


def build(defines=()) -> Path:
    """Compile the kernels unless a build of these exact sources exists.
    ``defines``: preprocessor names a measuring tool's own build sets (a
    library of its own; the path's build sets none)."""
    global build_seconds
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    out = library_path(defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        cu, _ = _sources()
        nvcc = _nvcc()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
            objs = [Path(objdir) / f"{src.stem}.o" for src in cu]
            _run_all([[nvcc, *flags, "-c", "-o", str(o), str(src)]
                      for src, o in zip(cu, objs)])
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            try:
                _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
            except RuntimeError:
                tmp.unlink(missing_ok=True)
                raise
        os.replace(tmp, out)
        build_seconds = time.perf_counter() - t0
    return out


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with every failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))


def library(defines=()) -> ctypes.CDLL:
    """The loaded build (``build``'s ``defines``), its functions typed."""
    defines = tuple(defines)
    if defines not in _libs:
        lib = ctypes.CDLL(str(build(defines)))
        for name, argtypes in (_SIGNATURES | _GRAPH).items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gt_error_string.argtypes = (ctypes.c_int,)
        lib.gt_error_string.restype = ctypes.c_char_p
        for name, argtypes in _QUERIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I64
        _libs[defines] = lib
    return _libs[defines]


def _call(name: str, device, *args) -> None:
    import torch

    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, "gt_" + name)(*args, stream)
    if rc != 0:
        msg = lib.gt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc} ({msg})")


def launch(name: str, device, *args, counter: str | None = None) -> None:
    """Launch kernel ``name`` on ``device``'s current stream; raise if the
    launch was refused, else add one to ``launch_counts[counter or name]``.
    ``args`` are the C arguments before the stream (pointers and sizes as
    Python ints)."""
    _call(name, device, *args)
    launch_counts[counter or name] += 1


def graph_call(name: str, *args) -> None:
    """A graph host function of the library (``_GRAPH``); raise if it
    failed."""
    lib = library()
    rc = getattr(lib, "gt_" + name)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA graph call {name} failed: error {rc} "
                           f"({lib.gt_error_string(rc).decode()})")


def query(name: str, *args) -> int:
    """A host function of the library (``_QUERIES``): no launch, no stream."""
    return int(getattr(library(), "gt_" + name)(*args))


def launch_empty(device) -> None:
    """Launch the kernel that does nothing: what a launch alone costs on
    the device. A yardstick for the measuring scripts; not counted."""
    _call("empty_kernel", device)
