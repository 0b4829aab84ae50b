"""video-restore-tpu-torch: the PyTorch/CUDA port of ``video_restore_tpu``.

The JAX package stays the reference; this package runs the same restore
program on an NVIDIA GPU. Plain tensor code is PyTorch, and every Pallas
kernel on the ported path has a hand-written CUDA counterpart under
``csrc/`` (built at first use by :mod:`video_restore_tpu_torch.ops._build`).
Each kernel wrapper keeps a plain PyTorch version beside it, which runs for
tensors on the CPU and serves as the reference in the checks.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
