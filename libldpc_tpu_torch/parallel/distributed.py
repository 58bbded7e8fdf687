"""Multi-process launch glue on ``torch.distributed`` (from
:mod:`libldpc_tpu.parallel.distributed`).

Scaling past one process is:

1. every process calls :func:`initialize` (idempotent), which reads the
   usual environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
   ``WORLD_SIZE``, ``LOCAL_RANK``) and stays a single process without it;
2. :func:`global_mesh` builds a 1-D frames mesh of every process's device
   in rank order, each entry owned by its rank (two processes on one card
   give a 2-entry mesh of that card);
3. every process runs the identical sweep driver on its own shards; the
   driver reduces the counters it reads over the process group
   (:func:`all_sum`), so every process sees every point's global counters
   after every absorb and all stop at the same batch without control
   messages.

The process group is gloo and carries host tensors only: the counters are
a few int64 a point, read on the host by the absorb anyway, and NCCL
refuses two ranks on one card.  The group has a timeout, so a rank that
fails or hangs fails the others instead of hanging them.  Only the
primary process (rank 0) writes the console, results file, checkpoint and
error log (:func:`is_primary`).

:func:`initialize` registers one ``atexit`` teardown (:func:`shutdown`): a
barrier bounded by :data:`EXIT_BARRIER_S`, then ``destroy_process_group``.
A gloo group still running when the interpreter exits can abort the
process (``terminate called without an active exception``) after its work
is done; the bound keeps a rank whose peer died from waiting at exit.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

#: Seconds a collective waits for the other ranks before it fails.
DEFAULT_TIMEOUT_S = 600.0
#: Seconds the exit barrier waits for the other ranks (:func:`shutdown`).
EXIT_BARRIER_S = 30.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the process group (gloo).  The arguments default to
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; without them
    (or with a world of one) the process stays alone.  Idempotent."""
    if dist.is_initialized():
        return
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', 29500)}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None or not num_processes or num_processes < 2:
        return  # a single-process run
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
        rank=int(process_id or 0), timeout=datetime.timedelta(seconds=timeout_s))
    atexit.register(shutdown)


def shutdown(timeout_s: float = EXIT_BARRIER_S) -> None:
    """Leave the process group: a barrier of at most ``timeout_s`` seconds
    (a rank that died or is late fails it; it is not waited for), then
    ``destroy_process_group``.  A no-op without a group; registered at exit
    by :func:`initialize`."""
    if not dist.is_initialized():
        return
    try:
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError:
        pass  # a peer is gone: leave without it
    dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns console and file output."""
    return process_index() == 0


def local_device(device="cuda") -> torch.device:
    """This process's device: ``cuda:{LOCAL_RANK % device_count}`` (so
    several ranks may share a card), or the CPU when asked."""
    from .mesh import local_devices

    devs = local_devices(device)
    if torch.device(device).type == "cpu":
        return devs[0]
    return devs[int(os.environ.get("LOCAL_RANK", process_index())) % len(devs)]


def global_mesh(device="cuda"):
    """1-D frames mesh over every process's device, in rank order."""
    from .mesh import FRAME_AXIS, Mesh

    mine = str(local_device(device))
    names = [mine] * process_count()
    if process_count() > 1:
        dist.all_gather_object(names, mine)
    return Mesh(names, (FRAME_AXIS,), processes=list(range(process_count())))


def process_info() -> dict:
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": 1,
        "global_devices": process_count(),
    }


def all_sum(values: torch.Tensor) -> torch.Tensor:
    """The sum over every process of a host tensor (int64 or float64);
    the tensor itself when the process is alone."""
    if process_count() == 1:
        return values
    out = values.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def broadcast_object(obj):
    """The primary's ``obj`` on every process."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
