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
(K6), ``ops/spmv.py:csr_pull_reduce`` (K7) and ``ops/frontier.py:relax_min``
(K8, kernel ``push_relax_min``), ``ops/edgehash.py:edgehash_probe`` (K9) and
``ops/triangles.py:wedge_rowblock`` (K10). A wrapper dispatches on
the device of its tensors: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. K2, K3 and K6 also take every bucket
of a slab plan in one launch (``slab_minmode_buckets``,
``slab_spmv_sum_buckets``, ``slab_spmv_min_buckets``), which is what the
algorithms call. Inside ``plain_torch()`` CUDA
tensors take the plain version too, so the whole path can run as its own
reference on the card. A wrapper adds one to ``launch_counts[name]`` for
each launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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
    # dist, row_ids, neigh, gpos, valid, w, out, e_cap, is_f64, stream
    "gt_push_relax_min": (_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _P),
    # table, rows, klo, khi, found, payload, p, stream
    "gt_edgehash_probe": (_P, _I64, _P, _P, _P, _P, _I64, _P),
    # slab, mslab, W, R, close_indptr, close_ids, close_mult, n_close, u_cred,
    # edge_cred, stream
    "gt_wedge_rowblock": (_P, _P, _I32, _I64, _P, _P, _P, _I64, _P, _P, _P),
    # stream: a kernel that returns at once (csrc/empty_kernel.cu)
    "gt_empty_kernel": (_P,),
}

launch_counts = dict.fromkeys(KERNELS, 0)
build_seconds = None  # seconds the last nvcc build took; None = not built here
_lib = None
_plain = False


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgraphtpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a build of these exact sources exists."""
    global build_seconds
    out = library_path()
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
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
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


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gt_error_string.argtypes = (ctypes.c_int,)
        lib.gt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _call(name: str, device, *args) -> None:
    import torch

    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, "gt_" + name)(*args, stream)
    if rc != 0:
        msg = lib.gt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc} ({msg})")


def launch(name: str, device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream; raise if the
    launch was refused, count it otherwise. ``args`` are the C arguments
    before the stream (pointers and sizes as Python ints)."""
    _call(name, device, *args)
    launch_counts[name] += 1


def launch_empty(device) -> None:
    """Launch the kernel that does nothing: what a launch alone costs on
    the device. A yardstick for the measuring scripts; not counted."""
    _call("empty_kernel", device)
