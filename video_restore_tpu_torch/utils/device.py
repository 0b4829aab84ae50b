"""Device selection for the port's entry points.

Counterpart of the JAX CLI's ``--cpu`` handling (``video_restore_tpu/cli.py``
``main``): there the flag moves JAX onto the host. Here every entry point
runs on the GPU unless the caller asks for the CPU, and a missing GPU is an
error, never a silent move to the CPU.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch


def resolve_device(cpu: bool = False) -> torch.device:
    """``torch.device("cpu")`` when asked for, else the current CUDA device.

    Raises RuntimeError when CUDA is unavailable and the CPU was not asked
    for (``--cpu`` on the CLI, ``cpu=True`` in the API)."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass --cpu (or cpu=True) to run the "
            "plain PyTorch path on the host CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


# the TF32 flags are process-wide: one thread at a time sets them
_tf32_lock = threading.RLock()


@contextlib.contextmanager
def tf32(enabled: bool) -> Iterator[None]:
    """The TF32 flags of cuDNN convs and CUDA matmuls for one call, restored
    after it (on the CPU they change nothing). The port's fp32 library calls
    (GFPGAN, the resize, training, the losses) run inside it with
    ``enabled=False`` unless the caller asks for TF32. The flags belong to
    the process, so the block holds a lock: the dispatch threads of a
    sharded upscaler, each running its face pass, take turns, and no thread
    restores the flags while another's calls inside the block still
    launch."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    with _tf32_lock:
        prev = (cudnn.allow_tf32, mm.allow_tf32)
        cudnn.allow_tf32 = mm.allow_tf32 = enabled
        try:
            yield
        finally:
            cudnn.allow_tf32, mm.allow_tf32 = prev
