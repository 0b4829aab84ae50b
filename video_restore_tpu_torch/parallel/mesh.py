"""Device lists for the sharded restore step and the mesh of the sharded
train step.

Port of ``video_restore_tpu/parallel/mesh.py``. Where JAX builds a 1-D
``Mesh`` over which XLA shards the frame batch, the port keeps a plain list
of ``torch.device``: :class:`~video_restore_tpu_torch.parallel.dispatch.
ShardedUpscaler` gives each entry a shard of its own (a model replica, a
stream, pinned rings, a carry row and a dispatch thread). A list may name
one device more than once: each entry is still a shard of its own, the
counterpart of JAX's virtual host devices (``[cpu] * D`` in the tests,
``[cuda:0] * D`` in ``chip_smoke.py``). The CLI never builds such a list.

:func:`train_mesh` builds the ``("dp", "tp")`` ``DeviceMesh`` of the sharded
train step (``training/train.py``), one rank per mesh device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from video_restore_tpu_torch.utils.device import resolve_device


def device_count(requested: int = 0, *, cpu: bool = False) -> int:
    """Number of devices to use (0 = all): this process's visible GPUs, or 1
    on the CPU (``mesh.py:12-22``). Raises when more are requested than
    there are."""
    n = 1 if cpu or not torch.cuda.is_available() else torch.cuda.device_count()
    if requested <= 0:
        return n
    if requested > n:
        raise RuntimeError(f"Requested {requested} devices but only {n} available")
    return requested


def frame_mesh(
    n_devices: int = 0,
    *,
    devices: Optional[Sequence[torch.device]] = None,
    cpu: bool = False,
) -> List[torch.device]:
    """The devices a frame batch is sharded over (``mesh.py:25-53``): the
    first ``n_devices`` (0 = all) of this process's visible GPUs, or
    ``[cpu]`` with ``cpu=True`` (the CPU is one device). An explicit
    ``devices`` is taken as it is, repeats included.

    Under a multi-process group (``--multihost``) the list covers this
    process's own GPUs only, as JAX's covers ``jax.local_devices()``: batch
    mode shards *videos* over processes, so no video's step spans hosts.
    Without a GPU and without ``cpu=True`` this raises, as every entry point
    does."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("frame_mesh: empty device list")
        return devs
    resolve_device(cpu)  # no CUDA and no cpu=True: the entry points' error
    n = device_count(n_devices, cpu=cpu)
    if cpu:
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(n)]


def train_mesh(dp: int, tp: int, device_type: str = "cuda"):
    """The ``DeviceMesh`` of shape (dp, tp), axes ``("dp", "tp")``, over the
    default process group's ranks in order (rank r: dp index r // tp, tp
    index r % tp; ``train.py`` of the JAX package builds ``Mesh(devices.
    reshape(dp, tp), ("dp", "tp"))``). The group must be formed first
    (``parallel/multihost.py::init_multihost``), with dp * tp ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if dp * tp != world:
        raise ValueError(f"train_mesh: dp {dp} x tp {tp} != {world} ranks")
    return DeviceMesh(
        device_type, torch.arange(world).view(dp, tp), mesh_dim_names=("dp", "tp")
    )
