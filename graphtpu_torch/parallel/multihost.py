"""Multi-host launch (counterpart of graphtpu/parallel/multihost.py).

Every host runs the same command, one process per host, as under the JAX
package. The environment contract is the JAX package's:
``GRAPHTPU_COORDINATOR`` (host:port of rank 0), ``GRAPHTPU_NUM_PROCESSES``
and ``GRAPHTPU_PROCESS_ID``. Here they map onto
``torch.distributed.init_process_group`` with a ``tcp://`` rendezvous at the
coordinator, NCCL for a CUDA device and gloo for the CPU; the group is then
the mesh (``mesh.make_mesh`` takes it and starts no worker).

    GRAPHTPU_COORDINATOR=host0:8476 GRAPHTPU_NUM_PROCESSES=2 GRAPHTPU_PROCESS_ID=<rank> \\
        python -m graphtpu_torch.cli run ... --num-devices 2

The JAX package also detects a TPU pod from ``TPU_WORKER_HOSTNAMES`` and
lets JAX find the coordinator through the TPU metadata server. CUDA hosts
have no such service, so there is no counterpart: without the variables
above, ``initialize`` does nothing.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from graphtpu_torch.parallel.mesh import GROUP_TIMEOUT_S
from graphtpu_torch.utils.logging import get_logger

log = get_logger("multihost")

_initialized = False


def _int_env(key: str) -> Optional[int]:
    v = os.environ.get(key)
    return int(v) if v else None


def initialize(device="cuda", coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None) -> bool:
    """Join the hosts' process group when the environment (or the
    arguments) name one. True when this process is part of one after the
    call, False for plain single-host execution. Idempotent."""
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get("GRAPHTPU_COORDINATOR")
    num_processes = num_processes or _int_env("GRAPHTPU_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("GRAPHTPU_PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("multi-host needs GRAPHTPU_COORDINATOR, GRAPHTPU_NUM_PROCESSES and "
                         "GRAPHTPU_PROCESS_ID")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )
    _initialized = True
    atexit.register(_leave)
    log.info("multi-host: process %d/%d (%s)", process_id, num_processes, dist.get_backend())
    return True


def _leave() -> None:
    """At exit: wait for every process (rank 0 serves the rendezvous store
    until the last one is done), then leave the group."""
    try:
        dist.barrier()
    finally:
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that writes outputs and reports."""
    return not dist.is_initialized() or dist.get_rank() == 0


def is_multihost() -> bool:
    """True when this process is one of several that ``initialize`` joined."""
    return _initialized and dist.get_world_size() > 1


def barrier() -> None:
    """Wait for every process that ``initialize`` joined; nothing without
    several."""
    if is_multihost():
        dist.barrier()


def everywhere(flag: bool) -> bool:
    """True when ``flag`` holds on every process that ``initialize`` joined
    (one all-reduce), so that they take one branch together; ``flag``
    itself without several."""
    if not is_multihost():
        return flag
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())
