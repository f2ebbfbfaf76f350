"""Rank groups and their collectives (counterpart of graphtpu/parallel/mesh.py).

JAX drives a 1-D mesh of devices from one process. ``torch.distributed``
runs one rank per device instead: gloo over CPU ranks, NCCL over cards.
A ``Mesh`` here is such a group of D ranks, and ``Mesh.call`` runs one
function on every rank, each with its own arguments, SPMD style: the
function meets the other ranks only in the collectives below.

How one process reaches D ranks. ``run_algorithm`` is called in one
process per host, as in the JAX harness. Under ``num-devices = D`` that
process is rank 0, and ``make_mesh`` starts D - 1 worker processes once per
(D, backend, first card), each a ``python`` running ``_worker_main``. Over
NCCL, rank r drives the card r places after the one the caller named
(``cuda:1`` with D = 2: cards 1 and 2). A worker joins the group (a file
store under the temporary directory is the rendezvous, so no port is
fixed), then waits on a pipe for the next call: the function's module and
name and the worker's own arguments. The mesh is kept for reuse, as JAX
keeps its mesh and its sharded graphs, because a worker's start is an
``import torch``; a harness job starts it in its warm-up run, outside the
processing window. It goes at exit, when another (D, backend, first card)
is asked for, and when ``dispatch.purge_sharded`` drops the last sharded
graph. A worker that raises sends its traceback and exits at once, so that
the other ranks' collectives fail instead of waiting; rank 0 then raises
with the worker's traceback and closes the mesh. A worker whose parent
dies sees its pipe close and exits.

Where ``multihost.initialize`` has already joined this process to a group
(one process per host, every host running the same program), the mesh is
that group and starts no worker: each process runs its own rank's part.
"""

from __future__ import annotations

import atexit
import datetime
import importlib
import os
import subprocess
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import Connection
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from graphtpu_torch.utils.logging import get_logger

log = get_logger("mesh")

ROOT = Path(__file__).resolve().parents[2]
# a collective that waits longer than this raises (a rank that died); the
# value at a mesh's start holds for all its ranks
GROUP_TIMEOUT_S = 600.0
# seconds a worker is given to leave after the stop message before it is killed
STOP_GRACE_S = 10.0
# seconds rank 0 waits for the workers' tracebacks after a failed call
ERROR_GRACE_S = 2.0

# torch 2.13 names the flat all-gather all_gather_single and warns on
# all_gather_into_tensor; older releases have only the latter
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class Mesh:
    """D ranks of one process group, seen from one of them."""

    def __init__(self, size: int, rank: int, backend: str, device: torch.device, workers=(),
                 store: Optional[str] = None, owned: bool = True):
        self.size = size
        self.rank = rank
        self.backend = backend
        self.device = device  # this rank's device
        # this rank's shards and other per-rank state, by key
        self.state: dict = {}
        self._workers = list(workers)
        self._store = store
        self._owned = owned  # False: a group that multihost.initialize joined
        self.closed = False

    def call(self, fn: Callable, per_rank_args: Sequence[tuple]) -> Any:
        """Run ``fn(mesh, *per_rank_args[r])`` on every rank r; return this
        rank's value. ``fn`` must be a module-level function."""
        if self.closed:
            raise RuntimeError("mesh is closed")
        if len(per_rank_args) != self.size:
            raise ValueError(f"{len(per_rank_args)} argument tuples for {self.size} ranks")
        for w, args in zip(self._workers, per_rank_args[1:]):
            w.send((fn.__module__, fn.__qualname__, tuple(args)))
        try:
            out = fn(self, *per_rank_args[self.rank])
            errors = [w.reply(GROUP_TIMEOUT_S) for w in self._workers]
        except BaseException as e:
            deadline = time.monotonic() + ERROR_GRACE_S
            errors = [w.reply(max(deadline - time.monotonic(), 0.0)) for w in self._workers]
            self.close(kill=True)
            said = "".join(f"\nrank {w.rank}: {m}" for w, m in zip(self._workers, errors) if m)
            raise RuntimeError(f"{fn.__qualname__} failed on rank {self.rank}{said}") from e
        failed = [(w.rank, m) for w, m in zip(self._workers, errors) if m]
        if failed:
            self.close(kill=True)
            raise RuntimeError(f"{fn.__qualname__} failed on rank {failed[0][0]}:\n{failed[0][1]}")
        return out

    def close(self, kill: bool = False) -> None:
        """Stop the workers (``kill``: at once, as after a failed call) and
        leave the group (a group that ``multihost.initialize`` joined stays
        joined)."""
        if self.closed:
            return
        self.closed = True
        for w in self._workers:
            w.stop(kill)
        if self._owned and dist.is_initialized():
            dist.destroy_process_group()
        if self._store:
            Path(self._store).unlink(missing_ok=True)


# -- collectives: every caller goes through these ---------------------------


def all_gather_rows(block: torch.Tensor) -> torch.Tensor:
    """Each rank's row block [R], concatenated in rank order [D * R] on every
    rank (JAX's tiled all_gather over the rows axis)."""
    block = block.contiguous()
    out = torch.empty(dist.get_world_size() * block.numel(), dtype=block.dtype,
                      device=block.device)
    _all_gather_flat(out, block)
    return out


def _all_reduce(t: torch.Tensor, op) -> torch.Tensor:
    """``op`` over the ranks, elementwise, into ``t`` (a contiguous copy of
    ``t`` where ``t`` is not contiguous, returned in its place)."""
    t = t.contiguous()
    dist.all_reduce(t, op=op)
    return t


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum over the ranks, in place (JAX's psum)."""
    return _all_reduce(t, dist.ReduceOp.SUM)


def all_reduce_min(t: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum over the ranks, in place (JAX's pmin)."""
    return _all_reduce(t, dist.ReduceOp.MIN)


# -- the worker pool ---------------------------------------------------------


_WORKER = "import sys; from graphtpu_torch.parallel.mesh import _worker_main; _worker_main(sys.argv[1:])"


class _Worker:
    """Rank ``rank``'s process, seen from rank 0: a command pipe in, a reply
    pipe out."""

    def __init__(self, rank: int, size: int, backend: str, store: str, card: int):
        self.rank = rank
        cmd_r, cmd_w = os.pipe()
        rep_r, rep_w = os.pipe()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(rank), str(size), backend, store, str(card),
             str(GROUP_TIMEOUT_S), str(cmd_r), str(rep_w)],
            pass_fds=(cmd_r, rep_w), env=env, cwd=str(ROOT),
        )
        os.close(cmd_r)
        os.close(rep_w)
        self._cmd = Connection(cmd_w, readable=False)
        self._rep = Connection(rep_r, writable=False)

    def send(self, msg) -> None:
        self._cmd.send(msg)

    def reply(self, timeout: float) -> Optional[str]:
        """None when the worker finished its call, else what went wrong."""
        try:
            if self._rep.poll(timeout):
                return self._rep.recv()
        except (EOFError, OSError):
            pass
        return f"no reply (worker exit code {self.proc.poll()})"

    def stop(self, kill: bool = False) -> None:
        try:
            if kill:
                self.proc.kill()
            else:
                self._cmd.send(None)
        except OSError:
            pass
        try:
            self.proc.wait(STOP_GRACE_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._cmd.close()
        self._rep.close()


def _rank_device(backend: str, card: int) -> torch.device:
    """Rank ``r``'s device: ``cuda:card`` over NCCL (``card`` is the first
    card plus r), the CPU over gloo."""
    return torch.device("cuda", card) if backend == "nccl" else torch.device("cpu")


def _init_group(backend: str, store: str, size: int, rank: int, card: int,
                timeout_s: float) -> None:
    if backend == "nccl":
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


_current: Optional[Mesh] = None


def make_mesh(num_devices: int, device="cuda") -> Mesh:
    """A mesh of ``num_devices`` ranks for tensors on ``device`` (NCCL for a
    CUDA device, one card a rank from ``device``'s on; gloo for the CPU),
    reused while it lives. Under ``multihost.initialize`` it is the joined
    group, whose size ``num_devices`` must be (0 takes it whatever it is)."""
    global _current
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    first = (device.index or 0) if backend == "nccl" else 0
    if _current is not None and not _current.closed:
        if not _current._owned:
            if num_devices in (0, _current.size) and _current.backend == backend:
                return _current
            raise ValueError(f"this process is rank {_current.rank} of {_current.size} "
                             f"(multihost); num-devices {num_devices} does not fit")
        if (_current.size == num_devices and _current.backend == backend
                and _current.device == _rank_device(backend, first)):
            return _current
    elif dist.is_initialized():  # joined by multihost.initialize
        size = dist.get_world_size()
        if num_devices not in (0, size):
            raise ValueError(f"the process group has {size} ranks; num-devices {num_devices}")
        # the card multihost.initialize chose for this process
        card = torch.cuda.current_device() if dist.get_backend() == "nccl" else 0
        _current = Mesh(size, dist.get_rank(), dist.get_backend(),
                        _rank_device(dist.get_backend(), card), owned=False)
        return _current
    if num_devices < 1:
        raise ValueError(f"num-devices {num_devices}: a mesh needs at least one rank")
    if backend == "nccl" and first + num_devices > torch.cuda.device_count():
        raise ValueError(f"requested {num_devices} cards from cuda:{first} on, have "
                         f"{torch.cuda.device_count()}")
    close_mesh()  # another size, backend or first card
    fd, store = tempfile.mkstemp(prefix="graphtpu-mesh-")
    os.close(fd)
    os.unlink(store)  # the file store makes it
    workers = [_Worker(r, num_devices, backend, store, first + r) for r in range(1, num_devices)]
    try:
        _init_group(backend, store, num_devices, 0, first, GROUP_TIMEOUT_S)
    except BaseException:
        for w in workers:
            w.proc.kill()
        raise
    _current = Mesh(num_devices, 0, backend, _rank_device(backend, first), workers, store)
    log.info("mesh: %d ranks (%s), %d worker process(es)", num_devices, backend, len(workers))
    return _current


def current_mesh() -> Optional[Mesh]:
    return _current if _current is not None and not _current.closed else None


def close_mesh() -> None:
    """Stop the current mesh's workers and leave its group."""
    if _current is not None:
        _current.close()


atexit.register(close_mesh)


def _worker_main(argv) -> None:
    rank, size, backend, store, card, timeout_s, cmd_fd, rep_fd = argv
    cmd = Connection(int(cmd_fd), writable=False)
    rep = Connection(int(rep_fd), readable=False)
    if backend == "gloo":
        # CPU ranks share one host: one thread each, not one per core each
        torch.set_num_threads(1)
    _init_group(backend, store, int(size), int(rank), int(card), float(timeout_s))
    mesh = Mesh(int(size), int(rank), backend, _rank_device(backend, int(card)))
    while True:
        try:
            msg = cmd.recv()
        except EOFError:  # rank 0 is gone
            break
        if msg is None:
            break
        module, name, args = msg
        try:
            getattr(importlib.import_module(module), name)(mesh, *args)
        except BaseException:  # noqa: BLE001  (rank 0 raises it)
            rep.send(traceback.format_exc())
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)  # the other ranks' collectives fail rather than wait
        rep.send(None)
    mesh.state.clear()
    dist.destroy_process_group()

