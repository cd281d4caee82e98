"""Multi-process initialisation (counterpart of
``graphnet_tpu/parallel/distributed.py``).

The JAX package runs one process per host, each holding a mesh of its
chips.  The port runs one process per device (the torch counterpart):
call :func:`init_distributed` first in every process, build a mesh over
the world (:func:`~graphnet_tpu_torch.parallel.mesh.make_mesh`), and
feed each process either the global batch (the Trainer keeps this
rank's slice) or its own process-local stream
(:func:`host_local_batch_slice`, ``MaterializedLoader(process_index=,
process_count=)``).

The backend is chosen from the device the caller names, never from what
happens to be found: NCCL for ``"cuda"``, gloo for ``"cpu"``; a caller
may name it (two ranks sharing one card need gloo, which NCCL refuses).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.device import DeviceLike, resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = "cuda",
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> Tuple[int, int]:
    """Initialise ``torch.distributed`` when more than one process runs;
    returns ``(rank, world_size)``.

    Arguments default from the environment variables of the JAX
    package's function (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
    ``PROCESS_ID``), then from torch's (``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  ``coordinator_address`` is
    ``host:port`` or a URL (``tcp://host:port``, ``file:///path``).  For
    one process it is a no-op returning ``(0, 1)``; a group already
    initialised is kept.  ``device`` names the backend (``"cuda"``:
    NCCL, ``"cpu"``: gloo) unless ``backend`` is given; every collective
    of the group times out after ``timeout_s`` seconds.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    n = num_processes or int(env.get("NUM_PROCESSES", 0)
                             or env.get("WORLD_SIZE", 0) or 1)
    if process_id is None:
        process_id = int(env.get("PROCESS_ID", env.get("RANK", 0)))
    if n <= 1:
        return 0, 1
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if address is None and "MASTER_ADDR" in env:
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', 29500)}"
    if address is None:
        raise ValueError(
            f"{n} processes need a coordinator address (argument, "
            "COORDINATOR_ADDRESS or MASTER_ADDR/MASTER_PORT)")
    if "://" not in address:
        address = f"tcp://{address}"
    if backend is None:
        backend = BACKENDS[resolve_device(device).type]
    dist.init_process_group(
        backend, init_method=address, world_size=n, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_local_batch_slice(global_batch_size: int) -> Tuple[int, int]:
    """``(start, size)`` of this process's slice of a global batch."""
    n, i = process_count(), process_index()
    per = global_batch_size // n
    assert per * n == global_batch_size, (
        f"global batch {global_batch_size} not divisible by {n} processes"
    )
    return i * per, per


def shard_host_local(batch: EventBatch, device: DeviceLike = "cuda"
                     ) -> EventBatch:
    """This process's local batch on its device: with one process a
    device, the local arrays are the shard (the JAX function assembles
    the global array from them; here the collectives span processes)."""
    return batch.to(resolve_device(device))
