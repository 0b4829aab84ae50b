"""Multi-host batch coordination on ``torch.distributed``.

Port of ``video_restore_tpu/parallel/multihost.py``. Directory jobs bigger
than one host shard at the *video* level: every process runs the same batch
command, :func:`init_multihost` forms a gloo process group over TCP, and
each process takes the videos whose index is congruent to its rank
(:func:`shard_items`): deterministic, no coordinator state, no work queue to
lose. Within a process the frame-level sharding over that host's own GPUs
applies (``parallel/mesh.py::frame_mesh``): one process per host uses all of
the host's GPUs, as in JAX.

The group carries two collectives per job: the rendezvous and the final
per-process success counts (:func:`allgather_counts`, one gloo
``all_gather`` of an int64 CPU tensor).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

from video_restore_tpu_torch.utils.logging import get_logger

log = get_logger()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def init_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "gloo",
) -> Tuple[int, int]:
    """Join (or form) the process group; returns (rank, world size).

    ``coordinator`` is ``HOST:PORT`` (rank 0 listens there), or else
    ``MASTER_ADDR:MASTER_PORT``; ``num_processes`` defaults to
    ``WORLD_SIZE`` and ``process_id`` to ``RANK`` (what ``torchrun`` sets:
    the counterparts of ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``
    and ``JAX_PROCESS_ID``); a group of one process needs no rank. The batch
    job's group is gloo; the sharded train step passes its own backend
    (NCCL where each rank has a GPU of its own)."""
    import torch.distributed as dist

    if coordinator is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
        if process_id is None and num_processes == 1:
            process_id = 0
    missing = [n for n, v in (("coordinator (--coordinator or MASTER_ADDR/MASTER_PORT)", coordinator),
                              ("number of processes (WORLD_SIZE)", num_processes),
                              ("process id (RANK)", process_id)) if v is None]
    if missing:
        raise ValueError("multihost: no " + ", no ".join(missing))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id
    )
    pid, n = dist.get_rank(), dist.get_world_size()
    log.info("multihost: process %d/%d (coordinator %s, %s)", pid, n, coordinator, backend)
    return pid, n


def process_count() -> int:
    """The process group's size, 1 without a group."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank, 0 without a group."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def shard_items(items: Sequence, pid: Optional[int] = None, nprocs: Optional[int] = None) -> List:
    """Deterministic round-robin shard of a work list for this process.

    Items must be identically ordered on every process (callers sort);
    round-robin (not contiguous blocks) keeps per-process wall-clock even
    when file sizes trend through the listing."""
    pid = process_index() if pid is None else pid
    nprocs = process_count() if nprocs is None else nprocs
    return [it for i, it in enumerate(items) if i % nprocs == pid]


def allgather_counts(local: Sequence[int]) -> List[List[int]]:
    """Gather a small vector of ints from every process (one collective);
    returns [nprocs][len(local)]."""
    if process_count() == 1:
        return [list(local)]
    import torch
    import torch.distributed as dist

    t = torch.tensor(list(local), dtype=torch.int64)
    rows = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, t)
    return [[int(v) for v in r] for r in rows]
